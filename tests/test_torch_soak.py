"""The soak of the training app (``stego_torch/tools/soak.py``) in its CPU
form: the sensitive instrument's tiny net at res 64 (``soak.tiny``), 40
steps with validation, checkpoints and histograms every 10, the loss
logged every 2, the probes reset at 20, and the cut run resumed from 10,
across the reset. It is held to the JAX app (``stego_tpu/train/app.py``)
on the same schedule: the metrics.jsonl rows and their keys, the
histogram sets, the kept checkpoints; the reset to the JAX package's
``reset_probes`` (``stego_tpu/train/segmenter.py:164-177``); and the
resumed run to the straight one, bit for bit.

``python -m tests.test_torch_soak [steps=1500] [output_root=DIR]`` (not a
test) runs the soak's code collapse on the CPU in both packages: the
JAX app and the port's on the same config (ViT-S/8 at res 64, f32, batch
16, the res-64 mosaic of 64 + 16 scenes, one KNN table), one process
each, side by side, and prints each package's losses by 250 steps and its
validations, then the port's code statistics (``soak.code_stats``) at the
end (about 15 minutes)."""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stego_torch.tools import soak as soak_tool
from stego_torch.train.app import step_seed
from stego_torch.train.segmenter import UnsupervisedSegmenter
from stego_tpu.data.synthetic import tiny_benchmark_setup as jax_tiny_setup
from stego_tpu.models.vit import ViTConfig as JaxViTConfig
from stego_tpu.train import app as jax_app
from stego_tpu.train.segmenter import UnsupervisedSegmenter as JaxSegmenter
from stego_tpu.utils.logging import MetricLogger as JaxMetricLogger

from tests.test_torch_app import jax_kept_steps
from tests.test_torch_config import torch_config
from tests._torch_cpu import one_intra_op_thread  # noqa: F401

CPU = torch.device("cpu")
SCHEDULE = dict(experiment_name="soak", val_freq=10, checkpoint_freq=10,
                hist_freq=10, scalar_log_freq=2, reset_probe_steps=20)


class JaxRecorder(JaxMetricLogger):
    """The JAX app's logger, recording each histogram set its writer
    thread delivers ({step: {name: total count}})."""
    sets: dict = {}

    def log_histogram_counts(self, step, name, counts, lo=-1.0, hi=1.0):
        self.sets.setdefault(int(step), {})[name] = float(
            np.asarray(counts, np.float64).sum())
        super().log_histogram_counts(step, name, counts, lo, hi)


@pytest.fixture(scope="module")
def soaked(tmp_path_factory):
    """The tiny soak's runs and failures, and the JAX app's straight run on
    the same data, KNN table and schedule: its metrics.jsonl rows and
    histogram sets. TensorBoard and the validation figures are off for
    both (the port prints a line for each figure without matplotlib)."""
    root = str(tmp_path_factory.mktemp("soak"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        cfg, vit, resume_at, limits = soak_tool.tiny(root, device=CPU)
        with pytest.MonkeyPatch.context() as no_plots:
            no_plots.setitem(sys.modules, "matplotlib", None)
            runs, fails = soak_tool.soak(cfg, resume_at, limits, vit_cfg=vit,
                                         device=CPU)
        jcfg, jvit = jax_tiny_setup(root, **SCHEDULE)
        jcfg = dataclasses.replace(jcfg, output_root=f"{root}/jax_out")
        mp.setattr(jax_app, "MetricLogger", JaxRecorder)
        for fig in ("save_comparison_grid", "save_confusion_matrix",
                    "save_frequency_bars"):
            mp.setattr(f"stego_tpu.utils.viz.{fig}", lambda *a, **k: None)
        JaxRecorder.sets = {}
        jax_app.train(jcfg, vit_cfg=jvit)
        jax_rows = soak_tool.read_rows(
            f"{jcfg.output_root}/logs/directory_soak")
    return dict(cfg=cfg, vit=vit, jcfg=jcfg, runs=runs, fails=fails,
                jax_rows=jax_rows, jax_hists=dict(JaxRecorder.sets),
                lines=soak_tool.lines(runs, CPU))


def shape(rows):
    """(step, keys) of each row, timings aside."""
    return [(r["step"], sorted(set(r) - set(soak_tool.TIMING_KEYS)))
            for r in rows]


def test_the_soak_passes_every_gate(soaked):
    assert soaked["fails"] == []
    assert torch_config(soaked["jcfg"]).replace(
        output_root=soaked["cfg"].output_root) == soaked["cfg"]


def test_rows_hists_and_kept_steps_match_the_jax_app(soaked):
    """The straight run's metrics.jsonl rows and keys, its histogram sets
    (steps and names) and the checkpoints it keeps are the JAX app's on
    the same schedule (the kept steps: the JAX manager's for the port's
    logged metrics)."""
    straight = soaked["runs"]["straight"]
    jax_rows = soaked["jax_rows"]
    assert shape(straight.rows) == shape(jax_rows)
    assert len([r for r in jax_rows if "loss/total" in r]) == 20
    assert sorted(straight.hist_sets) == sorted(soaked["jax_hists"]) \
        == [10, 20, 30, 40]
    assert {s: sorted(v) for s, v in straight.hist_sets.items()} == \
        {s: sorted(v) for s, v in soaked["jax_hists"].items()}
    vals = {r["step"]: {k: r[k] for k in soak_tool.VAL_KEYS}
            for r in straight.rows if soak_tool.VAL_KEYS[0] in r}
    kept = [int(f) for f in straight.ckpt_files if f.isdigit()]
    assert kept == jax_kept_steps(
        Path(soaked["cfg"].output_root), vals, 2)
    jax_vals = {r["step"]: {k: r[k] for k in soak_tool.VAL_KEYS}
                for r in jax_rows if soak_tool.VAL_KEYS[0] in r}
    assert len(jax_vals) == len(vals) == 4


def test_the_reset_draws_step_seed_probes_and_fresh_probe_adams(soaked):
    """The probes after the reset are reset_probes' from
    step_seed(seed, max_steps + 1); the probes' Adams start fresh and the
    head's keeps its state, as the JAX package's reset_probes does
    (its probe states at count 0, its net state untouched)."""
    cfg, vit = soaked["cfg"], soaked["vit"]
    at = soaked["runs"]["straight"].at_reset
    assert at["step"] == 20
    seg = UnsupervisedSegmenter(4, cfg, vit_cfg=vit)
    seg.reset_probes(torch.Generator().manual_seed(
        step_seed(cfg.seed, cfg.max_steps + 1)))
    probes = ("linear_probe.", "cluster_probe.")
    want = {k: v for k, v in seg.state_dict().items() if k.startswith(probes)}
    assert len(want) == 3
    for k, v in want.items():
        assert torch.equal(at["after"]["modules"][k], v), k
        assert not torch.equal(at["before"]["modules"][k], v), k
    for k, v in at["before"]["modules"].items():
        if not k.startswith(probes):
            assert torch.equal(at["after"]["modules"][k], v), k
    opts_before, opts_after = (at[w]["optimizers"] for w in ("before",
                                                             "after"))
    for name in ("linear", "cluster"):
        assert opts_before[name]["state"] and opts_after[name]["state"] == {}
    assert soak_tool.state_differences(
        {**at["before"], "optimizers": {"net": opts_before["net"]}},
        {**at["after"], "modules": at["before"]["modules"],
         "optimizers": {"net": opts_after["net"]}}) == []
    # the JAX package's reset: fresh probe states, the net state untouched
    jseg = JaxSegmenter(4, soaked["jcfg"],
                        vit_cfg=JaxViTConfig(**dataclasses.asdict(vit)))
    state = jseg.init_state(jax.random.PRNGKey(0))
    state = {**state, "opt": {**state["opt"], "net": jax.tree.map(
        lambda x: x + 1, state["opt"]["net"])}}
    reset = jseg.reset_probes(jax.random.PRNGKey(1), state)
    jax.tree.map(np.testing.assert_array_equal, reset["opt"]["net"],
                 state["opt"]["net"])
    for name, params in (("linear", "linear_probe"),
                         ("cluster", "cluster_probe")):
        fresh = jseg.make_optimizers()[name].init(reset["params"][params])
        jax.tree.map(np.testing.assert_array_equal, reset["opt"][name],
                     fresh)


def test_resume_across_the_reset_is_bit_for_bit(soaked):
    """The cut run ends at 10 with step 10 kept; the resumed run starts
    there, resets the probes at 20 and ends in the straight run's state,
    every module and optimizer entry bit for bit, with its rows."""
    runs = soaked["runs"]
    assert runs["cut"].record["steps"] == [0, 10]
    assert runs["resumed"].record["steps"] == [10, 40]
    assert runs["resumed"].record["resets"] == [20]
    assert soak_tool.state_differences(runs["straight"].state,
                                       runs["resumed"].state) == []
    assert runs["resumed"].state["optimizers"]["linear"]["state"]
    untimed = [soak_tool._untimed(r) for r in runs["resumed"].rows]
    assert untimed == [soak_tool._untimed(r) for r in runs["straight"].rows
                       if r["step"] > 10]
    assert runs["straight"].ckpt_files == runs["resumed"].ckpt_files


def test_every_record_names_the_cpu(soaked):
    lines = soaked["lines"]
    assert [ln["soak"] for ln in lines] == ["straight", "cut_resumed"]
    assert all(ln["device"] == "cpu" and ln["card"] is None for ln in lines)
    straight = lines[0]
    assert straight["steps"] == [0, 40] and straight["val_s"]["n"] == 4
    assert straight["ckpt_s"]["n"] == 4 and straight["images_per_s"] > 0
    assert [row[0] for row in straight["memory_mib"]] == [10, 20, 30, 40]
    assert all(len(row) == 2 for row in straight["memory_mib"])  # step, RSS
    assert len(straight["loss"]) == 20 and len(straight["validation"]) == 4


def test_the_soak_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="runs on a CUDA device and found "
                       "none"):
        soak_tool.main([f"output_root={tmp_path}"])
    assert not any(tmp_path.iterdir())


def test_a_resume_after_the_reset_is_refused(soaked):
    with pytest.raises(ValueError, match="resumes before its probe reset"):
        soak_tool.soak(soaked["cfg"], 20, device=CPU)


def _collapse_run(which, root, steps):
    """One package's app on the collapse config, under ``root``."""
    fields = dict(
        pytorch_data_dir=f"{root}/data", dataset_name="directory",
        dir_dataset_name="synthbench", dir_dataset_n_classes=4,
        experiment_name=which, model_type="vit_small", dino_patch_size=8,
        res=64, val_res=64, batch_size=16, val_batch_size=16,
        max_steps=steps, val_freq=250, checkpoint_freq=steps, hist_freq=0,
        scalar_log_freq=10, num_neighbors=4, crop_type=None,
        loader_crop_type="center", backbone_dtype="float32",
        cache_dataset=True, seed=0, output_root=f"{root}/out_{which}")
    sys.modules["torch.utils.tensorboard"] = None
    if which == "port":
        from stego_torch.config import Config
        from stego_torch.train.app import train

        torch.set_num_threads(3)
        train(Config(**fields), device=CPU)
    else:
        from stego_tpu.config import Config as JaxConfig

        jax_app.train(JaxConfig(**fields))


def _collapse_main(argv):
    import json
    import os
    import subprocess
    import tempfile

    from stego_torch.config import Config, prep_args
    from stego_torch.data.synthetic import write_synthetic_benchmark
    from stego_torch.eval.evaluate import load_model_for_eval
    from stego_torch.train.knn_app import precompute_knns

    args = prep_args(argv)
    steps = int(args.get("steps", 1500))
    root = args.get("output_root") or tempfile.mkdtemp(prefix="collapse_")
    write_synthetic_benchmark(f"{root}/data", n_train=64, n_val=16, res=64)
    precompute_knns(Config(pytorch_data_dir=f"{root}/data",
                           dataset_name="directory",
                           dir_dataset_name="synthbench",
                           dir_dataset_n_classes=4, res=64,
                           backbone_dtype="float32"),
                    dataset_names=["directory"], crop_types=[None], res=64,
                    batch_size=16, device=CPU)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="3")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_soak", "run", which,
         root, str(steps)], env=env) for which in ("port", "jax")]
    if any(p.wait() for p in procs):
        raise SystemExit("a run failed")
    keys = ("total", "linear", "cluster", "pos_intra", "neg_inter")
    for which in ("port", "jax"):
        rows = soak_tool.read_rows(f"{root}/out_{which}/logs/"
                                   f"directory_{which}")
        print(which)
        for end in range(250, steps + 1, 250):
            win = [r for r in rows if "loss/total" in r
                   and end - 250 < r["step"] <= end]
            print(f"  steps {end - 249}-{end}: " + ", ".join(
                f"loss/{k} {np.mean([r['loss/' + k] for r in win]):+.4f}"
                for k in keys))
        for r in rows:
            if soak_tool.VAL_KEYS[0] in r:
                print(f"  validation {r['step']}: " + json.dumps(
                    {k: round(r[k], 2) for k in soak_tool.VAL_KEYS}))
    seg = load_model_for_eval(
        f"{root}/out_port/checkpoints/directory_port/{steps}/model.ckpt",
        CPU)
    img = torch.from_numpy(np.stack(_val_images(root)))
    print("port, the code at the end: mean norm, mean pairwise cosine, "
          "variance share of one direction", soak_tool.code_stats(seg, img))


def _val_images(root):
    """The first 8 val scenes at res 64, normalised as the loader does."""
    from stego_torch.config import Config
    from stego_torch.data.contrastive import ContrastiveSegDataset
    from stego_torch.data.transforms import get_transform

    ds = ContrastiveSegDataset(
        pytorch_data_dir=f"{root}/data", dataset_name="directory",
        crop_type=None, image_set="val",
        transform=get_transform(64, False, "center"),
        target_transform=get_transform(64, True, "center"),
        cfg=Config(dataset_name="directory", dir_dataset_name="synthbench",
                   dir_dataset_n_classes=4))
    return [np.asarray(ds[i]["img"]) for i in range(8)]


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"]:
        _collapse_run(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    else:
        _collapse_main(sys.argv[1:])
