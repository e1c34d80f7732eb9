"""stego_torch's training app (``stego_torch/train/app.py``, ``knn_app.py``,
``checkpoint.py``) against the JAX package's, on the directory-dataset
fixture of ``tests/test_integration.py`` at res 32 with the small trunk
(ViT patch 8, width 128, depth 2, 2 heads): the KNN caches, a validation
epoch with a short final batch, train() end to end (metrics, metrics.jsonl,
top-k checkpoints, the f32 backbone of a bf16 trunk, the ``.ckpt`` read by
the JAX package's loader), resume bit for bit, SIGTERM and the cached
mode."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stego_tpu.config import Config as JaxConfig
from stego_tpu.data.contrastive import ContrastiveSegDataset as JaxDataset
from stego_tpu.data.loader import DataLoader as JaxLoader
from stego_tpu.data.transforms import get_transform as jax_get_transform
from stego_tpu.models.convert import \
    load_stego_checkpoint as jax_load_stego_checkpoint
from stego_tpu.models.vit import init_vit_params
from stego_tpu.parallel.mesh import make_mesh
from stego_tpu.train import app as jax_app
from stego_tpu.train.checkpoint import CheckpointManager as JaxManager
from stego_tpu.train.knn_app import precompute_knns as jax_precompute_knns
from stego_tpu.train.segmenter import make_val_step as jax_make_val_step
from stego_tpu.utils.metrics import UnsupervisedMetrics as JaxMetrics
from stego_torch.data.contrastive import ContrastiveSegDataset
from stego_torch.data.loader import DataLoader
from stego_torch.data.transforms import get_transform
from stego_torch.models.convert import to_jax_params, vit_state_dict
from stego_torch.models.vit import ViTConfig
from stego_torch.train import app
from stego_torch.train.checkpoint import (CheckpointManager, load_config,
                                          top_k_steps)
from stego_torch.train.knn_app import main as knn_app_main
from stego_torch.train.knn_app import precompute_knns
from stego_torch.train.segmenter import (UnsupervisedSegmenter,
                                         make_val_step)

from tests.test_integration import data_root  # noqa: F401
from tests.test_torch_config import torch_config
from tests.test_torch_train_step import setup
from tests.test_torch_vit import JAX_CFG, SMALL

REPO = Path(__file__).resolve().parents[1]
VIT = ViTConfig(**SMALL)
CPU = torch.device("cpu")
RES = 32
KEYS = {f"test/{probe}/{m}" for probe in ("linear", "cluster")
        for m in ("mIoU", "Accuracy")}


def jax_cfg(data_root, tmp_path, **kw):
    base = dict(
        output_root=str(tmp_path / "out"), pytorch_data_dir=data_root,
        dataset_name="directory", dir_dataset_name="synth",
        dir_dataset_n_classes=3, res=RES, val_res=RES, dino_patch_size=8,
        dim=6, feature_samples=4, neg_samples=2, batch_size=8,
        val_batch_size=8, max_steps=6, val_freq=3, checkpoint_freq=3,
        scalar_log_freq=2, hist_freq=2, num_neighbors=4,
        backbone_dtype="float32", crop_type=None, loader_crop_type="center",
        model_type="vit_small", num_workers=2)
    base.update(kw)
    return JaxConfig(**base)


def make_cfg(data_root, tmp_path, **kw):  # noqa: F811
    """The port's Config, with the KNN caches of both splits written."""
    cfg = torch_config(jax_cfg(data_root, tmp_path, **kw))
    precompute_knns(cfg, dataset_names=["directory"], crop_types=[None],
                    vit_cfg=VIT, res=RES, batch_size=8, device=CPU)
    return cfg


def log_lines(trainer):
    with open(os.path.join(trainer.log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def jax_kept_steps(tmp_path, metrics_by_step, k):
    """The steps the JAX package's (orbax) manager keeps for this metric
    sequence, saved in step order."""
    mgr = JaxManager(str(tmp_path / "jax_topk"), JaxConfig(), save_top_k=k)
    for step, metrics in sorted(metrics_by_step.items()):
        mgr.save(step, {"x": np.zeros(1, np.float32)}, metrics=metrics)
    mgr.wait_until_finished()
    kept = sorted(mgr.all_steps())
    mgr.close()
    return kept


def test_precompute_knns_writes_jax_nns(data_root, tmp_path):  # noqa: F811
    """The same caches, file for file, as the JAX package's knn_app with
    the same trunk weights (JAX's init from PRNGKey(0), carried to the
    port as a DINO .pth)."""
    jcfg = jax_cfg(data_root, tmp_path)
    written = jax_precompute_knns(jcfg, dataset_names=["directory"],
                                  crop_types=[None], vit_cfg=JAX_CFG,
                                  res=RES, batch_size=8)
    want = {os.path.basename(p): np.load(p)["nns"] for p in written}
    for p in written:
        os.remove(p)
    weights = str(tmp_path / "dino.pth")
    torch.save(vit_state_dict(init_vit_params(jax.random.PRNGKey(0),
                                              JAX_CFG)), weights)
    got = precompute_knns(
        torch_config(jcfg).replace(pretrained_weights=weights),
        dataset_names=["directory"], crop_types=[None], vit_cfg=VIT,
        res=RES, batch_size=8, device=CPU)
    assert [os.path.basename(p) for p in got] == list(want)
    for p in got:
        nns = np.load(p)["nns"]
        assert nns.dtype == np.int32
        np.testing.assert_array_equal(nns, want[os.path.basename(p)])
    # existing caches are skipped
    assert precompute_knns(torch_config(jcfg), dataset_names=["directory"],
                           crop_types=[None], vit_cfg=VIT, res=RES,
                           device=CPU) == []


@pytest.mark.parametrize("extra", [0, 2])
def test_run_validation_matches_jax(data_root, tmp_path, extra):  # noqa: F811
    """The metrics of a validation epoch in batches of 3 (the last one
    short, padded), exactly equal to the JAX app's, with the weights
    carried across."""
    jcfg = jax_cfg(data_root, tmp_path, extra_clusters=extra)
    jseg, bb, state, seg = setup(jcfg)
    kw = dict(pytorch_data_dir=data_root, dataset_name="directory",
              crop_type=None, image_set="val", mask=True)
    jds = JaxDataset(transform=jax_get_transform(RES, False, "center"),
                     target_transform=jax_get_transform(RES, True, "center"),
                     cfg=jcfg, **kw)
    ds = ContrastiveSegDataset(
        transform=get_transform(RES, False, "center"),
        target_transform=get_transform(RES, True, "center"),
        cfg=torch_config(jcfg), **kw)
    want = jax_app.run_validation(
        jseg, jax.jit(jax_make_val_step(jseg)), bb, state["params"],
        JaxLoader(jds, 3, drop_last=False), make_mesh(1), 3)
    got = app.run_validation(seg, make_val_step(seg),
                             DataLoader(ds, 3, drop_last=False), 3, CPU)
    assert got == want
    assert set(got) == KEYS


@pytest.mark.parametrize("extra", [0, 2])
def test_validation_figures_match_jax(data_root, tmp_path, extra,  # noqa: F811
                                      capsys, monkeypatch):
    """figure_prefix: the confusion-matrix and frequency figures of the
    JAX app's validation, byte for byte (the same matched histogram, drawn
    by the same matplotlib code), and a panel of the same size (the JAX
    panel draws its images from the uint8 wire format, which the port does
    not have); without matplotlib, one line names each figure not
    written."""
    jcfg = jax_cfg(data_root, tmp_path, extra_clusters=extra)
    jseg, bb, state, seg = setup(jcfg)
    kw = dict(pytorch_data_dir=data_root, dataset_name="directory",
              crop_type=None, image_set="val", mask=True)
    jds = JaxDataset(transform=jax_get_transform(RES, False, "center"),
                     target_transform=jax_get_transform(RES, True, "center"),
                     cfg=jcfg, **kw)
    ds = ContrastiveSegDataset(
        transform=get_transform(RES, False, "center"),
        target_transform=get_transform(RES, True, "center"),
        cfg=torch_config(jcfg), **kw)
    jax_app.run_validation(
        jseg, jax.jit(jax_make_val_step(jseg)), bb, state["params"],
        JaxLoader(jds, 3, drop_last=False), make_mesh(1), 3,
        figure_prefix=str(tmp_path / "jax_"))
    app.run_validation(seg, make_val_step(seg),
                       DataLoader(ds, 3, drop_last=False), 3, CPU,
                       figure_prefix=str(tmp_path / "port_"))
    for name in ("confusion.png", "freqs.png"):
        assert (tmp_path / f"port_{name}").read_bytes() == \
            (tmp_path / f"jax_{name}").read_bytes(), name
    from PIL import Image

    assert Image.open(tmp_path / "port_panel.png").size == \
        Image.open(tmp_path / "jax_panel.png").size
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    app.run_validation(seg, make_val_step(seg),
                       DataLoader(ds, 3, drop_last=False), 3, CPU,
                       figure_prefix=str(tmp_path / "none_"))
    assert capsys.readouterr().out.splitlines() == [
        f"{tmp_path / ('none_' + n)}: not written, matplotlib does not "
        f"import" for n in ("panel.png", "confusion.png", "freqs.png")]


def test_train_end_to_end(data_root, tmp_path):  # noqa: F811
    """train() on the fixture: finite metrics with the JAX app's keys,
    metrics.jsonl with the losses every scalar_log_freq steps and the
    validations, the checkpoints the JAX manager keeps for the same metric
    sequence, the config beside them, and a .ckpt that the JAX package's
    loader reads as the trained segmenter's parameters."""
    cfg = make_cfg(data_root, tmp_path, max_steps=9, save_top_k=2)
    trainer = app.Trainer(cfg, vit_cfg=VIT, device=CPU)
    metrics = trainer.run()
    jm = JaxMetrics("test/linear/", 3, 0, False).compute()
    jc = JaxMetrics("test/cluster/", 3, 0, True).compute()
    assert set(metrics) == set(jm) | set(jc) == KEYS
    assert all(np.isfinite(v) for v in metrics.values())
    lines = log_lines(trainer)
    losses = [ln for ln in lines if "loss/total" in ln]
    vals = {ln["step"]: ln for ln in lines if "test/cluster/mIoU" in ln}
    assert [ln["step"] for ln in losses] == [2, 4, 6, 8]
    assert all(np.isfinite(ln["loss/total"]) for ln in losses)
    assert "imgs_per_sec" in losses[-1]
    assert sorted(vals) == [3, 6, 9]
    assert {k: vals[9][k] for k in KEYS} == metrics
    mgr = trainer.mgr
    assert mgr.all_steps() == jax_kept_steps(
        tmp_path, {s: {k: vals[s][k] for k in KEYS} for s in vals}, 2)
    assert load_config(mgr.directory) == cfg
    # the .ckpt of the last step, through the JAX package's loader
    loaded = jax_load_stego_checkpoint(mgr.checkpoint_path(9),
                                       vit_cfg=JAX_CFG)
    backbone, params = to_jax_params(trainer.seg)
    jax.tree.map(np.testing.assert_array_equal, loaded["backbone"], backbone)
    np.testing.assert_array_equal(loaded["head"]["cluster1"]["kernel"],
                                  params["head"]["cluster1"]["kernel"])
    np.testing.assert_array_equal(loaded["linear_probe"]["kernel"],
                                  params["linear_probe"]["kernel"])
    np.testing.assert_array_equal(loaded["cluster_probe"]["clusters"],
                                  params["cluster_probe"]["clusters"])
    assert loaded["cfg_dict"]["dim"] == cfg.dim


def test_bf16_trunk_checkpoints_f32_backbone(data_root, tmp_path):  # noqa: F811
    """A bf16 trunk computes with bf16 block weights; backbone.pt and the
    .ckpt keep the f32 source weights (the seeded init, not its bf16
    rounding)."""
    cfg = make_cfg(data_root, tmp_path, backbone_dtype="bfloat16",
                   max_steps=2, val_freq=2, checkpoint_freq=2)
    trainer = app.Trainer(cfg, vit_cfg=VIT, device=CPU)
    trainer.run()
    assert trainer.seg.net.model.blocks[0].attn.qkv.weight.dtype == \
        torch.bfloat16
    want = UnsupervisedSegmenter(
        3, cfg, vit_cfg=VIT, generator=torch.Generator().manual_seed(
            cfg.seed)).net.model.state_dict()
    saved = trainer.mgr.restore_backbone()
    ckpt = torch.load(trainer.mgr.checkpoint_path(2), weights_only=True)
    qkv = "blocks.0.attn.qkv.weight"
    assert not torch.equal(want[qkv], want[qkv].bfloat16().float())
    for k, w in want.items():
        assert saved[k].dtype == torch.float32
        assert torch.equal(saved[k], w), k
        assert torch.equal(ckpt["state_dict"]["net.model." + k], w), k


@pytest.mark.parametrize("k,sequence", [
    (2, [10.0, 30.0, 20.0, 5.0]),
    (1, [5.0, 5.0, 3.0, 5.0]),
    (2, [7.0, 7.0, 7.0, 7.0]),
    (3, [1.0, None, 4.0, 2.0, 9.0, 2.0]),
])
def test_top_k_keeps_the_jax_managers_steps(tmp_path, k, sequence):
    """For the same metric sequence (None: a save before any validation,
    with no metrics) the port's manager keeps the steps the JAX package's
    orbax manager keeps, after every save."""
    jcfg = JaxConfig(dataset_name="directory", dim=6, res=RES)
    seg = UnsupervisedSegmenter(3, torch_config(jcfg), vit_cfg=VIT)
    mgr = CheckpointManager(str(tmp_path / "port"), torch_config(jcfg),
                            save_top_k=k)
    mgr.save_backbone(seg.net.model.state_dict())
    seen = {}
    for i, value in enumerate(sequence):
        step = 3 * (i + 1)
        metrics = {} if value is None else {"test/cluster/mIoU": value}
        seen[step] = metrics
        mgr.save(step, seg, metrics=metrics)
        assert mgr.all_steps() == top_k_steps(seen, k)
    assert mgr.all_steps() == jax_kept_steps(tmp_path, seen, k)


def test_resume_is_bit_for_bit(data_root, tmp_path):  # noqa: F811
    """4 steps straight equal 2 steps, a checkpoint and a resumed run of 2
    more, bit for bit: parameters, Adam moments and step counts,
    seg.step. The resumed run starts at step 2 with the loader
    fast-forwarded (batches of 5 of 16 images: mid-epoch)."""
    straight = app.Trainer(
        make_cfg(data_root, tmp_path, max_steps=4, val_freq=100,
                 checkpoint_freq=2, batch_size=5, experiment_name="a"),
        vit_cfg=VIT, device=CPU)
    straight.run()
    cut = make_cfg(data_root, tmp_path, max_steps=2, val_freq=100,
                   checkpoint_freq=2, batch_size=5, experiment_name="b")
    app.Trainer(cut, vit_cfg=VIT, device=CPU).run()
    resumed = app.Trainer(cut.replace(max_steps=4, resume=True),
                          vit_cfg=VIT, device=CPU)
    resumed.run()
    assert resumed.start_step == 2
    a, b = straight.seg, resumed.seg
    assert a.step == b.step == 4
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    for name, opt in a.optimizers().items():
        other = b.optimizers()[name]
        for p, q in zip(opt.param_groups[0]["params"],
                        other.param_groups[0]["params"]):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.state[p][key], other.state[q][key]), \
                    (name, key)
    steps_a = [ln["step"] for ln in log_lines(straight)
               if "loss/total" in ln]
    steps_b = [ln["step"] for ln in log_lines(resumed) if "loss/total" in ln]
    assert steps_a == [2, 4] and steps_b == [2, 4]


SIGTERM_WORKER = """
import sys
sys.modules["jax"] = None
sys.modules["stego_tpu"] = None
sys.modules["tensorboard"] = None  # metrics.jsonl only: a faster start
import torch
from stego_torch.config import Config
from stego_torch.models.vit import ViTConfig
from stego_torch.train.app import train
cfg = Config.from_dict(__import__("json").loads(sys.argv[1]))
train(cfg, vit_cfg=ViTConfig(patch_size=8, embed_dim=128, depth=2,
                             num_heads=2, img_size=32),
      device=torch.device("cpu"))
print("WORKER_DONE", flush=True)
"""


def test_sigterm_checkpoints_and_resumes(data_root, tmp_path):  # noqa: F811
    """SIGTERM mid-run: the step in flight ends, a preemption checkpoint
    lands outside the top-k and the process exits 0; resume=true continues
    from that step."""
    cfg = make_cfg(data_root, tmp_path, max_steps=10_000, val_freq=10_000,
                   checkpoint_freq=10_000, scalar_log_freq=1)
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    cmd = [sys.executable, "-c", SIGTERM_WORKER]
    p = subprocess.Popen(cmd + [cfg.to_json()], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    jsonl = os.path.join(cfg.output_root, "logs", "directory_exp1",
                         "metrics.jsonl")
    deadline = time.time() + 200
    while not (os.path.exists(jsonl) and os.path.getsize(jsonl) > 0):
        if p.poll() is not None or time.time() > deadline:
            p.kill()
            raise AssertionError(p.stdout.read().decode()[-3000:])
        time.sleep(0.2)
    p.send_signal(signal.SIGTERM)
    out = p.communicate(timeout=120)[0].decode()
    assert p.returncode == 0, out[-3000:]
    assert "will checkpoint and exit" in out and "WORKER_DONE" in out
    ckpt_dir = os.path.join(cfg.output_root, "checkpoints", "directory_exp1")
    with open(os.path.join(ckpt_dir, "preempt_step.json")) as f:
        pstep = json.load(f)["step"]
    assert pstep >= 1
    assert os.path.exists(os.path.join(ckpt_dir, "preempt", "model.ckpt"))
    resume = cfg.replace(resume=True, max_steps=pstep + 2)
    p2 = subprocess.run(cmd + [resume.to_json()], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=200)
    assert p2.returncode == 0, p2.stdout[-3000:] + p2.stderr[-3000:]
    assert f"resumed from checkpoint step {pstep}" in p2.stdout
    assert "WORKER_DONE" in p2.stdout


def test_cached_mode_trains(data_root, tmp_path):  # noqa: F811
    """cache_backbone_feats through train(): cached steps, the cached
    validation epoch, the hist variant, a probe reset and the profiler's
    trace of steps 10-20."""
    cfg = make_cfg(data_root, tmp_path, cache_backbone_feats=True,
                   max_steps=21, val_freq=7, checkpoint_freq=7,
                   reset_probe_steps=5, profile_dir=str(tmp_path / "prof"))
    trainer = app.Trainer(cfg, vit_cfg=VIT, device=CPU)
    metrics = trainer.run()
    assert trainer.feat_cache["feats"].shape == (16, 4, 4, 128)
    assert set(metrics) == KEYS
    assert all(np.isfinite(v) for v in metrics.values())
    assert trainer.seg.step == 21 and len(trainer.val_seconds) == 3
    assert os.path.exists(tmp_path / "prof" / "train_steps.json")
    # the cached validation's figures: its panel decodes the first index
    # batch's images from the val dataset
    assert sorted(f for f in os.listdir(trainer.log_dir)
                  if f.endswith(".png")) == [
        f"val_{s}_{n}.png" for s in (14, 21, 7)
        for n in ("confusion", "freqs", "panel")]
    assert trainer.mgr.all_steps() == jax_kept_steps(
        tmp_path, {s: {k: ln[k] for k in KEYS} for ln in log_lines(trainer)
                   for s in [ln["step"]] if "test/cluster/mIoU" in ln}, 2)


def test_unported_modes_raise(data_root, tmp_path):  # noqa: F811
    """steps_per_dispatch > 1 raises naming ROADMAP.md; a Trainer whose
    num_devices is not its process group's size (here one process) raises
    and says how to start the processes (tests/test_torch_ddp_app.py runs
    two)."""
    cfg = torch_config(jax_cfg(data_root, tmp_path))
    with pytest.raises(NotImplementedError,
                       match="Do not port these TPU workarounds"):
        app.Trainer(cfg.replace(cache_backbone_feats=True,
                                steps_per_dispatch=2), vit_cfg=VIT,
                    device=CPU)
    with pytest.raises(ValueError, match="num_devices=2 asks for 2 processes "
                       "and this is one of 1: start them with python -m "
                       "stego_torch.train"):
        app.Trainer(cfg.replace(num_devices=2), vit_cfg=VIT, device=CPU)


def test_nonfinite_metrics_raise_with_the_step():
    app._check_finite(3, {"loss/total": torch.tensor(1.0),
                          "hist/x": torch.zeros(4)})
    with pytest.raises(FloatingPointError, match=r"train step 7: .*loss/rec"):
        app._check_finite(7, {"loss/total": torch.tensor(1.0),
                              "loss/rec": torch.tensor(float("nan"))})


@pytest.mark.parametrize("main", [app.main, knn_app_main])
def test_entry_points_need_a_cuda_device(main, monkeypatch):
    """``python -m stego_torch.train`` and ``python -m
    stego_torch.train.knn_app`` exit with an error, having done nothing,
    where there is no CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="runs on a CUDA device and found "
                       "none"):
        main(["dataset_name=directory", "dir_dataset_name=synth"])
