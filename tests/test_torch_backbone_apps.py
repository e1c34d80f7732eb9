"""The applications on the ResNet-50 backbones, on the CPU at res 32 on the
directory-dataset fixture of ``tests/test_integration.py``: the KNN
precompute with each cut embedder (ResNet-50, VGG-11, DenseNet-121) against
the JAX package's knn_app on the same torchvision-layout weights, file for
file; the training app on the feature-pyramid arch (``backbone.pt`` the
ResNet's f32 state dict, resume bit for bit with the BatchNorm running
statistics); its checkpoint through ``load_model_for_eval``, the dataset
eval and serving; and the PiCIE rows of the eval against the JAX package's
arithmetic."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.config import Config as JaxConfig
from stego_tpu.models import picie as jax_picie
from stego_tpu.models.probes import cluster_lookup as jax_cluster_lookup
from stego_tpu.ops.interp import interpolate as jax_interpolate
from stego_tpu.train.knn_app import precompute_knns as jax_precompute_knns
from stego_tpu.utils.metrics import UnsupervisedMetrics as JaxMetrics
from stego_torch.config import Config
from stego_torch.data.contrastive import ContrastiveSegDataset
from stego_torch.data.transforms import get_transform
from stego_torch.eval import evaluate as ev
from stego_torch.models.convert import save_stego_checkpoint
from stego_torch.models.fpn import FeaturePyramidNet
from stego_torch.serve import ServingModel, package
from stego_torch.train import app
from stego_torch.models.zoo import CutBackboneEmbedder
from stego_torch.train.knn import make_embed_fn
from stego_torch.train.knn_app import precompute_knns
from stego_torch.train.segmenter import UnsupervisedSegmenter

from tests.test_fpn import make_torch_resnet50_sd
from tests.test_integration import data_root  # noqa: F401
from tests.test_torch_resnet import picie_sd
from tests.test_zoo import make_densenet_sd, make_vgg11_sd
from tests._torch_cpu import one_intra_op_thread  # noqa: F401

CPU = torch.device("cpu")
RES = 32


def fpn_fields(data_root, tmp_path, **kw):  # noqa: F811
    base = dict(
        output_root=str(tmp_path / "out"), pytorch_data_dir=data_root,
        dataset_name="directory", dir_dataset_name="synth",
        dir_dataset_n_classes=3, res=RES, val_res=RES, arch="feature-pyramid",
        model_type="resnet50", granularity=3, dim=6, feature_samples=3,
        neg_samples=2, batch_size=5, val_batch_size=8, max_steps=4,
        val_freq=100, checkpoint_freq=2, scalar_log_freq=2, num_neighbors=4,
        backbone_dtype="float32", crop_type=None, loader_crop_type="center",
        num_workers=2)
    base.update(kw)
    return base


@pytest.mark.parametrize("model_type,make_sd", [
    ("resnet50", make_torch_resnet50_sd), ("vgg11", make_vgg11_sd),
    ("densenet121", make_densenet_sd)])
def test_knn_app_cut_embedders_match_jax(data_root, tmp_path,  # noqa: F811
                                         model_type, make_sd):
    """A non-dino arch's KNN caches: each cut embedder loaded from the same
    torchvision-layout file in both packages gives the JAX knn_app's
    neighbour tables, file for file, up to the order of neighbours whose
    cosine similarities tie within 1e-5 (the synthetic images of a class
    are near-duplicates, and the embeddings differ in their last bits)."""
    weights = str(tmp_path / "w.pth")
    torch.save(make_sd(0), weights)
    fields = fpn_fields(data_root, tmp_path, model_type=model_type,
                        pretrained_weights=weights)
    jroot, root = tmp_path / "jax", tmp_path / "port"
    for d in (jroot, root):  # each package writes its caches under its root
        d.mkdir()
        os.symlink(os.path.join(data_root, "synth"), d / "synth")
    written = jax_precompute_knns(
        JaxConfig(**dict(fields, pytorch_data_dir=str(jroot))),
        dataset_names=["directory"], crop_types=[None], res=RES,
        batch_size=8)
    got = precompute_knns(Config(**dict(fields, pytorch_data_dir=str(root))),
                          dataset_names=["directory"], crop_types=[None],
                          res=RES, batch_size=8, device=CPU)
    assert sorted(os.path.basename(p) for p in got) == \
        sorted(os.path.basename(p) for p in written)
    assert all(f"nns_{model_type}_" in os.path.basename(p) for p in got)
    net = CutBackboneEmbedder(model_type)
    net.load_pretrained(weights)
    embed = make_embed_fn(net.eval())
    for mine, theirs in zip(sorted(got), sorted(written)):
        split = "train" if "_train_" in mine else "val"
        ds = ContrastiveSegDataset(
            pytorch_data_dir=str(root), dataset_name="directory",
            crop_type=None, image_set=split,
            transform=get_transform(RES, False, "center"),
            target_transform=get_transform(RES, True, "center"),
            cfg=Config(**fields))
        e = embed(torch.from_numpy(np.stack([ds[i]["img"]
                                             for i in range(len(ds))])))
        sims = (e @ e.T).numpy()
        a, b = np.load(mine)["nns"], np.load(theirs)["nns"]
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        rows = np.arange(a.shape[0])[:, None]
        np.testing.assert_allclose(sims[rows, a], sims[rows, b], rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def fpn_run(tmp_path_factory):
    """The port's config of a feature-pyramid run on the directory dataset
    of ``tests/test_integration.py``, with its KNN caches, and its trainer
    after 4 steps straight (experiment "a", one intra-op thread:
    :func:`one_thread`); shared by the module's tests."""
    tmp = tmp_path_factory.mktemp("fpn")
    cfg = Config(**fpn_fields(data_root.__wrapped__(tmp), tmp))
    precompute_knns(cfg, dataset_names=["directory"], crop_types=[None],
                    res=RES, batch_size=8, device=CPU)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        straight = app.Trainer(cfg.replace(experiment_name="a"), device=CPU)
        straight.run()
    finally:
        torch.set_num_threads(threads)
    return cfg, straight


@pytest.fixture
def one_thread():
    """One intra-op thread for the test. The FPN head's weight gradients
    reduce over every pixel of the batch (K = B x 56 x 56 for a cluster
    map), and a CPU BLAS splits such a reduction over as many threads as
    it takes under load, so two runs round a gradient's last bits
    differently; where the gradient is analytically 0 (a conv bias before
    a train-mode BatchNorm, an input channel constant over the batch) it
    is that rounding alone, and Adam's first steps turn it into a move of
    up to lr. One thread fixes the order of every sum."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fpn_app_resume_is_bit_for_bit(fpn_run, one_thread):
    """4 steps straight equal 2 steps, a checkpoint and a resumed run of 2
    more, bit for bit: the head's parameters and BatchNorm running
    statistics, the probes, the Adam states (one intra-op thread:
    :func:`one_thread`). ``backbone.pt`` holds the ResNet-50's f32 state
    dict."""
    cfg, straight = fpn_run
    cut = cfg.replace(max_steps=2, experiment_name="b")
    app.Trainer(cut, device=CPU).run()
    resumed = app.Trainer(cut.replace(max_steps=4, resume=True), device=CPU)
    resumed.run()
    assert resumed.start_step == 2
    a, b = straight.seg, resumed.seg
    assert isinstance(a.net, FeaturePyramidNet) and a.step == b.step == 4
    sa, sb = a.state_dict(), b.state_dict()
    assert any("running_mean" in k for k in sa)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    assert int(sa["net.conv2.double_conv.1.num_batches_tracked"]) == 4
    for name, opt in a.optimizers().items():
        other = b.optimizers()[name]
        for p, q in zip(opt.param_groups[0]["params"],
                        other.param_groups[0]["params"]):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.state[p][key], other.state[q][key])
    backbone = torch.load(os.path.join(straight.ckpt_dir, "backbone.pt"),
                          weights_only=True)
    assert set(backbone) == set(a.net.model.state_dict())
    assert all(v.dtype == torch.float32 for v in backbone.values())


def test_fpn_checkpoint_eval_and_serving(fpn_run, tmp_path, monkeypatch):
    """The app's newest .ckpt through ``load_model_for_eval`` gives the
    trained segmenter's flip-TTA code bit for bit (56 x 56, the running
    statistics); the dataset eval's summed confusion matrices equal a
    recount of its predictions; the served artifact (3 input channels, no
    custom ops) gives the eval step's log-probs and predictions; the
    feature cache refuses the arch."""
    cfg, trainer = fpn_run
    ckpt = trainer.mgr.checkpoint_path()
    seg = ev.load_model_for_eval(ckpt, CPU)
    assert seg.vit_cfg is None and isinstance(seg.net, FeaturePyramidNet)
    val = ContrastiveSegDataset(
        pytorch_data_dir=cfg.pytorch_data_dir, dataset_name="directory",
        crop_type=None, image_set="val",
        transform=get_transform(RES, False, "center"),
        target_transform=get_transform(RES, True, "center"), cfg=cfg)
    img = torch.from_numpy(np.stack([val[i]["img"] for i in range(4)]))
    with torch.no_grad():
        code = ev.flip_tta_code(seg, img)
        trainer.seg.eval()
        want = ev.flip_tta_code(trainer.seg, img)
    assert code.shape == (4, 56, 56, 6)
    assert torch.equal(code, want)

    monkeypatch.chdir(tmp_path)
    evaluator = ev.Evaluator(cfg.replace(batch_size=2), ckpt, device=CPU,
                             val_dataset=val)
    seen = []
    metrics = evaluator.run(save_outputs=False,
                            on_batch=lambda b, lp, cp: seen.append(
                                (b["label"], lp.numpy(), cp.numpy())))
    assert set(metrics) >= {"final/linear/mIoU", "final/cluster/mIoU"}
    recount = np.zeros((3, 3), np.int64)
    for label, lp, _ in seen:
        ok = (label >= 0) & (label < 3)
        np.add.at(recount, (lp[ok], label[ok]), 1)
    np.testing.assert_array_equal(evaluator.linear_metrics.stats, recount)

    art = package(ckpt, str(tmp_path / "art"), res=RES, batch_size=2,
                  device="cpu")
    served = ServingModel.load(art, devices=["cpu"])
    assert served.meta["in_chans"] == 3
    img01 = np.clip(np.random.default_rng(0).random((3, RES, RES, 3)), 0, 1) \
        .astype(np.float32)
    out = served.predict(img01)
    from stego_torch.data.transforms import channel_stats

    mean, std = (torch.as_tensor(s) for s in channel_stats(3))
    step = ev.make_eval_step(seg, return_probs=True)
    lp, cp, _ = step((torch.from_numpy(img01) - mean) / std,
                     torch.zeros(3, RES, RES, dtype=torch.int32))
    np.testing.assert_allclose(out["linear_probs"], lp.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out["cluster_probs"], cp.numpy(), rtol=1e-5,
                               atol=1e-5)
    from stego_torch.train.feat_cache import validate_feat_cache_cfg

    with pytest.raises(ValueError, match="arch=dino"):
        validate_feat_cache_cfg(cfg.replace(cache_backbone_feats=True))


def test_picie_rows_match_jax(tmp_path, monkeypatch):
    """The eval's PiCIE rows: the released file's layout (pickled modules,
    the cluster probe and the saved confusion matrix) read by the port, its
    predictions mapped by the matrix's assignment and resized by nearest
    neighbour, against the JAX package's arithmetic
    (``evaluate.py:237-257, 315-320``); and the evaluator of a cocostuff27
    checkpoint with ``run_picie`` draws the row."""
    g = torch.Generator().manual_seed(3)
    sd = picie_sd(1)
    probe = torch.nn.Module()
    probe.clusters = torch.nn.Parameter(torch.randn(27, 256, generator=g))
    stats = torch.randint(0, 50, (27, 27), generator=g)
    (tmp_path / "saved_models").mkdir()
    path = str(tmp_path / "saved_models" / "picie_and_probes.pth")
    torch.save({"model": sd, "cluster_probe": probe,
                "cluster_metrics": types.SimpleNamespace(stats=stats)}, path)
    img = np.random.default_rng(5).standard_normal((2, 64, 64, 3)) \
        .astype(np.float32)

    js = jax_picie.load_picie_checkpoint(path)
    jmetrics = JaxMetrics("picie/", 27, 0, True)
    jmetrics.merge_stats(js["cluster_stats"])
    jmetrics.compute()
    feats = jax_picie.picie_features(js["backbone"], js["decoder"],
                                     jnp.asarray(img))
    _, probs = jax_cluster_lookup(js["cluster_probe"], feats, alpha=None)
    jpred = jmetrics.map_clusters(np.asarray(jnp.argmax(probs, axis=-1)))
    want = np.asarray(jax_interpolate(jnp.asarray(jpred[..., None],
                                                  jnp.float32), (40, 40),
                                      "nearest"))[..., 0].astype(np.int64)

    net, metrics = ev.load_picie_rows(path, 27, CPU)
    got = np.stack(ev.picie_rows(net, metrics, torch.from_numpy(img),
                                 (40, 40)))
    assert got.shape == (2, 40, 40)
    assert (got == want).mean() > 0.99

    monkeypatch.chdir(tmp_path)
    cfg = Config(dataset_name="cocostuff27", arch="feature-pyramid",
                 model_type="resnet50", granularity=2, dim=6, res=RES,
                 crop_type=None, n_images=2, run_picie=True,
                 experiment_name="picie")
    seg = UnsupervisedSegmenter(27, cfg)
    ckpt = str(tmp_path / "fpn.ckpt")
    save_stego_checkpoint(ckpt, seg)
    items = [(np.zeros((RES, RES, 3), np.float32),
              np.zeros((RES, RES), np.int64)) for _ in range(2)]
    rows = {}
    from stego_torch.utils import viz

    monkeypatch.setattr(viz, "write_figures",
                        lambda figures: [draw(p) for p, draw in figures])
    monkeypatch.setattr(viz, "save_confusion_matrix", lambda *a, **k: None)
    monkeypatch.setattr(viz, "save_comparison_grid",
                        lambda p, r, *a, **k: rows.update(r))
    evaluator = ev.Evaluator(cfg, ckpt, device=CPU,
                             val_dataset=ContrastiveSegDataset.from_items(
                                 items, 27, mask=False))
    evaluator.run(save_outputs=True)
    assert rows["PiCIE\n(Baseline)"].shape == (2, RES, RES)
