"""The training app, dataset evaluation and KNN build on 2 CPU processes
over gloo (``parallel/dist.py``), against one process of the port: a
directory dataset of 17 train and 9 val images (odd, so that the stripes
drop a tail), the small trunk at res 32, global batch 4. Both ranks run
every stage in one start (``tests/_torch_ddp_app_worker.py``):

* ``precompute_knns``: the files equal a one-process build's;
* ``Trainer``: both ranks end with equal states; 2 steps, a checkpoint and
  a resumed run of 2 more equal 4 steps straight, bit for bit; the
  validation's summed confusion matrices equal one process's on the first
  8 val images; a SIGTERM on rank 1 makes both ranks checkpoint after the
  same step, and a resume starts there;
* ``Evaluator``: the summed confusion matrices equal a one-process
  evaluation of the first 8 val images, exactly."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from stego_torch.config import Config
from stego_torch.data.contrastive import ContrastiveSegDataset
from stego_torch.data.loader import DataLoader
from stego_torch.data.transforms import get_transform
from stego_torch.eval.evaluate import Evaluator, load_model_for_eval
from stego_torch.models.vit import ViTConfig
from stego_torch.train.knn_app import precompute_knns
from stego_torch.train.segmenter import make_val_step
from tests.test_torch_ddp import WORLD, start_ranks, wait_ranks
from tests.test_torch_vit import SMALL

VIT = ViTConfig(**SMALL)
CPU = torch.device("cpu")
RES, N_TRAIN, N_VAL, STEPS = 32, 17, 9, 4


def write_data(root):
    """The directory dataset: class-coloured images with some ignore
    pixels."""
    rng = np.random.default_rng(0)
    for split, count in {"train": N_TRAIN, "val": N_VAL}.items():
        for kind in ("imgs", "labels"):
            os.makedirs(os.path.join(root, "synth", kind, split))
        for i in range(count):
            base = np.zeros((RES, RES, 3), np.uint8)
            base[:, :, i % 3] = 200
            base += rng.integers(0, 55, (RES, RES, 3), dtype=np.uint8)
            lbl = np.full((RES, RES), i % 3, dtype=np.uint8)
            lbl[:4, :4] = 255
            Image.fromarray(base).save(
                os.path.join(root, "synth", "imgs", split, f"{i:03d}.png"))
            Image.fromarray(lbl).save(
                os.path.join(root, "synth", "labels", split, f"{i:03d}.png"))
    return root


def make_cfg(root, out):
    return Config(
        output_root=out, pytorch_data_dir=root, dataset_name="directory",
        dir_dataset_name="synth", dir_dataset_n_classes=3, res=RES,
        val_res=RES, dino_patch_size=8, dim=6, feature_samples=4,
        neg_samples=2, batch_size=4, val_batch_size=4, max_steps=STEPS,
        val_freq=2, checkpoint_freq=2, scalar_log_freq=1, hist_freq=2,
        num_neighbors=4, backbone_dtype="float32", crop_type=None,
        loader_crop_type="center", model_type="vit_small", num_workers=0)


class First:
    """The first ``n`` items of a dataset."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


def val_dataset(cfg):
    return ContrastiveSegDataset(
        pytorch_data_dir=cfg.pytorch_data_dir, dataset_name="directory",
        crop_type=None, image_set="val",
        transform=get_transform(RES, False, "center"),
        target_transform=get_transform(RES, True, "center"), mask=True,
        cfg=cfg)


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_app")
    ranks_root = write_data(str(tmp / "data_ranks"))
    cfg = make_cfg(ranks_root, str(tmp / "out"))
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"cfg": json.loads(cfg.to_json()),
                                "vit": SMALL, "knn_batch": 4}))
    work = tmp / "work"
    work.mkdir()
    procs = start_ranks("_torch_ddp_app_worker.py", spec, work)
    try:
        # the one-process KNN caches, on a copy of the dataset
        one_cfg = cfg.replace(pytorch_data_dir=write_data(
            str(tmp / "data_one")))
        one = precompute_knns(one_cfg, dataset_names=["directory"],
                              crop_types=[None], vit_cfg=VIT, res=RES,
                              batch_size=4, device=CPU)
    finally:
        wait_ranks(procs)
    outs = [torch.load(work / f"app_{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return cfg, outs, one, work


def test_knn_equals_one_process(app_runs):
    """Each rank embedded its stripe of the loader's batches and rank 0
    wrote the file: the nns equal a one-process build, row for row."""
    cfg, outs, one, _ = app_runs
    assert [os.path.basename(p) for p in outs[0]["knn"]] == \
        [os.path.basename(p) for p in one]
    assert outs[1]["knn"] == outs[0]["knn"]
    for got, want in zip(outs[0]["knn"], one):
        np.testing.assert_array_equal(np.load(got)["nns"],
                                      np.load(want)["nns"])


def test_app_ranks_agree_and_resume_is_bit_for_bit(app_runs):
    """Both ranks' trained states are equal bit for bit, and 2 steps, a
    checkpoint and a resumed run of 2 more equal 4 steps straight."""
    _, outs, _, _ = app_runs
    for r in range(WORLD):
        assert outs[r]["resumed_start"] == STEPS // 2
        for k, v in outs[0]["straight"].items():
            assert torch.equal(outs[r]["straight"][k], v), (r, k)
            assert torch.equal(outs[r]["resumed"][k], v), (r, k)
    assert outs[0]["straight_metrics"] == outs[1]["straight_metrics"]
    assert set(outs[0]["straight_metrics"]) == {
        f"test/{p}/{m}" for p in ("linear", "cluster")
        for m in ("mIoU", "Accuracy")}


def test_app_validation_equals_one_process(app_runs):
    """The 2-rank validation's confusion matrices (each rank's stripe of
    the 9 val images, the ninth dropped, summed over the ranks) equal one
    process's on the first 8 images, with the trained weights."""
    cfg, outs, _, _ = app_runs
    seg = load_model_for_eval(outs[0]["ckpt"], CPU, vit_cfg=VIT)
    step = make_val_step(seg)
    loader = DataLoader(First(val_dataset(cfg), 8), 4, drop_last=False)
    want = [torch.zeros((3, 3), dtype=torch.long)] * 2
    for batch in loader:
        out = step({k: torch.from_numpy(batch[k]) for k in ("img", "label")})
        want = [want[0] + out["conf_linear"], want[1] + out["conf_cluster"]]
    assert int(want[0].sum()) > 0
    for r in range(WORLD):
        for got, w in zip(outs[r]["val"], want):
            assert torch.equal(got, w), r


def test_sigterm_on_one_rank_stops_both_at_one_step(app_runs):
    """Rank 1's SIGTERM: both ranks checkpoint after the same step and
    exit; a resume starts from that step on both."""
    cfg, outs, _, _ = app_runs
    stopped = outs[0]["stopped_at"]
    assert 3 <= stopped < 100
    ckpt_dir = os.path.join(cfg.output_root, "checkpoints", "directory_c")
    with open(os.path.join(ckpt_dir, "preempt_step.json")) as f:
        assert json.load(f)["step"] == stopped
    for r in range(WORLD):
        assert outs[r]["stopped_at"] == stopped
        assert outs[r]["again_start"] == stopped
        assert outs[r]["again_step"] == stopped + 2


def test_eval_equals_one_process_on_the_stripes(app_runs):
    """evaluate() on 2 ranks over the 9 val images: the confusion matrices
    equal one process's over the first 8, exactly; rank 0 wrote the PNG
    trees."""
    cfg, outs, _, work = app_runs
    ev = Evaluator(cfg.replace(experiment_name="ev_one", batch_size=2),
                   outs[0]["ckpt"], CPU, vit_cfg=VIT,
                   val_dataset=First(val_dataset(cfg), 8))
    want = ev.run(save_outputs=False)
    for r in range(WORLD):
        assert outs[r]["eval_metrics"] == want
        assert np.array_equal(outs[r]["eval"][0], ev.linear_metrics.stats)
        assert np.array_equal(outs[r]["eval"][1], ev.cluster_metrics.stats)
    assert os.path.isdir(work / "results" / "predictions" / "ev" / "img")
