"""The stego_torch flip-TTA slice as a whole against the JAX make_eval_step,
the dataset eval (``evaluate``) with and without both CRFs against the JAX
``evaluate``, and the demo and eval entry points."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stego_tpu.data.transforms import get_transform
from stego_tpu.eval.demo import demo as jax_demo
from stego_tpu.eval.evaluate import evaluate as jax_evaluate
from stego_tpu.eval.evaluate import make_eval_step as jax_make_eval_step
from stego_tpu.models.export import export_stego_checkpoint
from stego_torch.data.contrastive import ContrastiveSegDataset
from stego_torch.eval.demo import demo, load_image
from stego_torch.eval.evaluate import (
    Evaluator,
    evaluate,
    flip_tta_code,
    load_model_for_eval,
    make_eval_step,
)
from stego_torch.utils.metrics import update_conf_matrix
from stego_torch.models.convert import from_jax_params
from stego_torch.models.probes import linear_probe_logits
from stego_torch.ops.interp import interpolate
from stego_torch.ops.math import l2_normalize

from tests.test_torch_config import torch_config
from tests.test_torch_convert import jax_model, make_cfg
from tests.test_torch_vit import JAX_CFG

RES = 32


def batch(seed, b=2, res=RES):
    """ImageNet-normalized random [0, 1] images and a label of their size."""
    rng = np.random.default_rng(seed)
    img01 = rng.random((b, res, res, 3)).astype(np.float32)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (img01 - mean) / std, np.zeros((b, res, res), np.int32)


def both(cfg, seed=0):
    jseg, bb, params = jax_model(cfg, seed)
    seg = from_jax_params(bb, params, torch_config(cfg)).eval()
    return jseg, bb, params, seg


def jax_code(jseg, bb, params, img):
    _, c1 = jseg.net.apply(bb, params["head"], img, train=False)
    _, c2 = jseg.net.apply(bb, params["head"], img[:, :, ::-1], train=False)
    return np.asarray((c1 + c2[:, :, ::-1]) / 2.0)


def top2_margins(seg, code, hw):
    """Top-1 minus top-2 of both probes' full-resolution scores."""
    with torch.no_grad():
        linear = interpolate(linear_probe_logits(seg.linear_probe, code), hw)
        clusters = l2_normalize(seg.cluster_probe.clusters, dim=1)
        cluster = interpolate(code @ clusters.T, hw)
    out = []
    for s in (linear, cluster):
        top = torch.topk(s, 2, dim=-1).values
        out.append((top[..., 0] - top[..., 1]).numpy())
    return out


@pytest.mark.parametrize("res", [RES, 48])
def test_eval_step_f32_matches_jax(res):
    """f32: code atol 1e-4; predictions equal wherever the top-two scores
    differ by more than 1e-3."""
    cfg = make_cfg(res=res)
    jseg, bb, params, seg = both(cfg)
    img, label = batch(1, res=res)
    want_code = jax_code(jseg, bb, params, jnp.asarray(img))
    want = jax.jit(jax_make_eval_step(jseg, run_crf=False))(
        bb, params, jnp.asarray(img), jnp.asarray(label))
    timg = torch.from_numpy(img)
    with torch.no_grad():
        code = flip_tta_code(seg, timg)
    np.testing.assert_allclose(code.numpy(), want_code, atol=1e-4, rtol=0)
    got = make_eval_step(seg, run_crf=False)(timg, torch.from_numpy(label))
    for g, w, margin in zip(got, want, top2_margins(seg, code, (res, res))):
        assert g.dtype == torch.int32 and g.shape == label.shape
        sure = margin > 1e-3
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(g.numpy()[sure], np.asarray(w)[sure])


def test_eval_step_return_probs_f32_matches_jax():
    """The log-prob path: log-probs atol 1e-4, unnormalized RGB 1e-6."""
    cfg = make_cfg()
    jseg, bb, params, seg = both(cfg, seed=1)
    img, label = batch(2)
    want = jax.jit(jax_make_eval_step(jseg, run_crf=False,
                                      return_probs=True))(
        bb, params, jnp.asarray(img), jnp.asarray(label))
    got = make_eval_step(seg, return_probs=True)(torch.from_numpy(img),
                                                 torch.from_numpy(label))
    for g, w, atol in zip(got, want, (1e-4, 1e-4, 1e-6)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=0)


def test_eval_step_bf16_matches_jax():
    """bf16 trunk through the kernels' paths (JAX: Pallas in interpret
    mode; port: the plain versions on the CPU): >= 99% of predictions agree
    where the top-two margin is above 5e-2."""
    cfg = make_cfg(backbone_dtype="bfloat16")
    jseg, bb, params, seg = both(cfg, seed=2)
    img, label = batch(3, b=4)
    want = jax.jit(jax_make_eval_step(jseg, run_crf=False))(
        bb, params, jnp.asarray(img), jnp.asarray(label))
    timg = torch.from_numpy(img)
    got = make_eval_step(seg)(timg, torch.from_numpy(label))
    with torch.no_grad():
        code = flip_tta_code(seg, timg)
    for g, w, margin in zip(got, want, top2_margins(seg, code, (RES, RES))):
        sure = margin > 5e-2
        assert sure.mean() > 0.5
        agree = (g.numpy() == np.asarray(w))[sure].mean()
        assert agree >= 0.99, agree


def test_load_model_for_eval_reads_jax_export(tmp_path):
    """A JAX-exported .ckpt drives the port's eval step to the same
    predictions as the segmenter built from the same pytrees."""
    cfg = make_cfg(backbone_dtype="bfloat16")
    _, bb, params, seg = both(cfg, seed=4)
    path = str(tmp_path / "m.ckpt")
    export_stego_checkpoint(path, cfg, bb, params)
    loaded = load_model_for_eval(path, "cpu")
    assert loaded.net.model.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert loaded.net.model.norm.weight.dtype == torch.float32
    img, label = batch(5)
    timg, tlabel = torch.from_numpy(img), torch.from_numpy(label)
    for g, w in zip(make_eval_step(loaded)(timg, tlabel),
                    make_eval_step(seg.eval())(timg, tlabel)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_demo_writes_png_trees(tmp_path):
    """Two PNGs through the demo: the same image preprocessing as the JAX
    transform, the trees the JAX demo writes, and its predictions."""
    demo_against_jax(tmp_path, run_crf=False)


def test_demo_with_grid_crf_writes_jax_predictions(tmp_path):
    """The same with the grid CRF, the Config's default (``run_crf``)."""
    demo_against_jax(tmp_path, run_crf=True)


def demo_against_jax(tmp_path, run_crf):
    cfg = make_cfg(run_crf=run_crf, batch_size=1)
    _, bb, params = jax_model(cfg, seed=5)
    ckpt = str(tmp_path / "m.ckpt")
    export_stego_checkpoint(ckpt, cfg, bb, params)
    image_dir = tmp_path / "imgs"
    image_dir.mkdir()
    rng = np.random.default_rng(6)
    for name, (h, w) in (("a.png", (40, 36)), ("b.png", (30, 50))):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) \
            .save(image_dir / name)
        np.testing.assert_array_equal(
            load_image(str(image_dir / name), RES),
            get_transform(RES, False, "center")(str(image_dir / name),
                                                force_rgb=True))

    out, jax_out = tmp_path / "port", tmp_path / "jax"
    assert demo(torch_config(cfg), ckpt, str(image_dir), str(out),
                "cpu") == 2
    jax_demo(cfg, ckpt, str(image_dir), str(jax_out), vit_cfg=JAX_CFG)
    step = make_eval_step(load_model_for_eval(ckpt, "cpu"), run_crf)
    for i, name in enumerate(("a.png", "b.png")):
        img = torch.from_numpy(load_image(str(image_dir / name), RES))[None]
        preds = step(img, img[..., 0])
        for tree, pred in zip(("linear", "cluster"), preds):
            got = np.asarray(Image.open(out / tree / name))
            assert got.shape == (RES, RES) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, pred[0].numpy())
            want = np.asarray(Image.open(jax_out / tree / name))
            assert (got == want).mean() >= 0.99
    assert sorted(os.listdir(out / "cluster")) == ["a.png", "b.png"]


def test_demo_main_needs_a_cuda_device(tmp_path, monkeypatch):
    """``python -m stego_torch.eval.demo`` runs on the card: without one it
    exits with an error that says so and writes nothing (a caller of
    ``demo`` asks for the CPU by passing a CPU device)."""
    from stego_torch.eval import demo as demo_module

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "imgs").mkdir()
    with pytest.raises(SystemExit, match="CUDA device"):
        demo_module.main([f"model_path={tmp_path / 'm.ckpt'}",
                          f"image_dir={tmp_path / 'imgs'}", "run_crf=false"])
    assert sorted(os.listdir(tmp_path)) == ["imgs"]


def labels(seed, shape, n_classes=5):
    """Random labels in [-1, n_classes): -1 is ignored."""
    rng = np.random.default_rng(seed)
    return rng.integers(-1, n_classes, shape).astype(np.int32)


def host_confs(seg, linear, cluster, label):
    """The confusion matrices recounted on the host from predictions."""
    nc, extra = seg.n_classes, seg.cfg.extra_clusters
    t = torch.from_numpy(np.asarray(label))
    return (update_conf_matrix(torch.zeros((nc, nc), dtype=torch.long),
                               torch.as_tensor(np.asarray(linear)), t, nc, 0),
            update_conf_matrix(torch.zeros((nc + extra, nc),
                                           dtype=torch.long),
                               torch.as_tensor(np.asarray(cluster)), t, nc,
                               extra))


@pytest.mark.parametrize("run_crf", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_with_conf_matches_jax(dtype, run_crf):
    """with_conf: the step's confusion matrices are the host's recount of
    its predictions, exactly. f32, with and without the grid CRF:
    predictions and matrices equal JAX's exactly. bf16 (the trunks differ
    by bf16 roundings): predictions agree on >= 99% of the pixels, and the
    matrices differ by at most two counts per disagreeing pixel (it leaves
    one cell and enters another)."""
    cfg = make_cfg(backbone_dtype=dtype)
    jseg, bb, params, seg = both(cfg, seed=3)
    img, _ = batch(7, b=4)
    label = labels(1, (4, RES, RES))
    want = jax.jit(jax_make_eval_step(jseg, run_crf, with_conf=True))(
        bb, params, jnp.asarray(img), jnp.asarray(label))
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in make_eval_step(seg, run_crf, with_conf=True)(
        torch.from_numpy(img), torch.from_numpy(label))]
    assert got[0].dtype == got[1].dtype == np.int32
    assert got[2].dtype == got[3].dtype == np.int64
    for g, h in zip(got[2:], host_confs(seg, got[0], got[1], label)):
        np.testing.assert_array_equal(g, h.numpy())
    assert int(got[2].sum()) == int((label >= 0).sum())
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        for g, w, cg, cw in zip(got[:2], want[:2], got[2:], want[2:]):
            differ = int((g != w).sum())
            assert differ <= 0.01 * g.size, differ
            assert int(np.abs(cg - cw).sum()) <= 2 * differ


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_crf_and_return_probs_match_jax(dtype):
    """run_crf=True: the grid CRF's argmax equals the JAX step's (bf16:
    on >= 99% of the pixels); and the return_probs path's log-probs and
    RGB (f32: 1e-4 and 1e-6; bf16: the trunk's differences, 5e-2 on the
    log-probs)."""
    cfg = make_cfg(backbone_dtype=dtype)
    jseg, bb, params, seg = both(cfg, seed=6)
    img, label = batch(8, b=2, res=48)
    jimg, jlabel = jnp.asarray(img), jnp.asarray(label)
    timg, tlabel = torch.from_numpy(img), torch.from_numpy(label)
    want = jax.jit(jax_make_eval_step(jseg, run_crf=True))(bb, params, jimg,
                                                           jlabel)
    for g, w in zip(make_eval_step(seg, run_crf=True)(timg, tlabel), want):
        agree = float((g.numpy() == np.asarray(w)).mean())
        assert agree == 1.0 if dtype == "float32" else agree >= 0.99, agree
    want = jax.jit(jax_make_eval_step(jseg, run_crf=True,
                                      return_probs=True))(bb, params, jimg,
                                                          jlabel)
    got = make_eval_step(seg, run_crf=True, return_probs=True)(timg, tlabel)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for g, w, atol in zip(got, want, (tol, tol, 1e-6)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=0)


N_EVAL = 8


def eval_items(seed=11, n=N_EVAL, res=RES):
    """In-memory (img, label, mask) items: uint8 pixels normalized as the
    loader normalizes them (the JAX loop's uint8 wire format then restores
    them exactly), labels in [-1, 5)."""
    rng = np.random.default_rng(seed)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    items = []
    for _ in range(n):
        u8 = rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
        # smooth the labels into blocks so the CRF has regions to find
        label = np.kron(rng.integers(-1, 5, (res // 8, res // 8)),
                        np.ones((8, 8), np.int64))
        items.append(((u8.astype(np.float32) / 255.0 - mean) / std, label,
                      (label >= 0).astype(np.float32)))
    return items


class JaxItems:
    """The same items as the JAX evaluate's dataset (dicts of img and
    label)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        img, label, _ = self.items[i]
        return {"img": img, "label": label}


@pytest.fixture
def exported(tmp_path, monkeypatch):
    """A checkpoint exported by the JAX package, the working directory
    (results/ goes there) and the eval items."""
    monkeypatch.chdir(tmp_path)
    cfg = make_cfg(backbone_dtype="float32")
    _, bb, params = jax_model(cfg, seed=9)
    path = str(tmp_path / "m.ckpt")
    export_stego_checkpoint(path, cfg, bb, params)
    return cfg, path, eval_items()


@pytest.mark.parametrize("crf", ["none", "grid", "exact"])
def test_evaluate_matches_jax(exported, crf):
    """evaluate() over 8 in-memory images in batches of 2 x 3 (the last
    padded from 2 to 6) from the JAX export: the same metric keys and
    values within 1e-6 as the JAX evaluate, with run_crf false, the grid
    CRF and the exact CRF."""
    cfg, path, items = exported
    eval_cfg = cfg.replace(run_crf=crf != "none",
                           crf_backend="exact" if crf == "exact" else "grid",
                           batch_size=3, num_devices=1, n_images=2)
    want = jax_evaluate(eval_cfg, path, vit_cfg=JAX_CFG,
                        val_dataset=JaxItems(items), save_outputs=False)
    got = evaluate(torch_config(eval_cfg), path, "cpu",
                   val_dataset=ContrastiveSegDataset.from_items(items, 5),
                   save_outputs=False)
    assert got.keys() == want.keys() == {
        f"final/{p}/{m}" for p in ("linear", "cluster")
        for m in ("mIoU", "Accuracy")}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_evaluate_writes_png_trees_and_figures(exported):
    """save_outputs: the kept images' img/label/cluster/linear trees and
    the two figures; max_batches stops the loop, the padded last batch
    counts only its real pixels, and on_batch sees every batch."""
    cfg, path, items = exported
    eval_cfg = cfg.replace(run_crf=False, batch_size=3, n_images=3,
                           experiment_name="t")
    ev = Evaluator(torch_config(eval_cfg), path, "cpu",
                   val_dataset=ContrastiveSegDataset.from_items(items, 5))
    seen = []
    metrics = ev.run(on_batch=lambda b, lp, cp: seen.append(
        (np.asarray(b["label"]), lp.numpy(), cp.numpy())))
    assert [s[0].shape[0] for s in seen] == [6, 6]
    assert all(np.isfinite(v) for v in metrics.values())
    labels_ = np.concatenate([s[0] for s in seen])
    assert (labels_[N_EVAL:] == -1).all()  # the padding
    linear, cluster = host_confs(ev.seg, np.concatenate([s[1] for s in seen]),
                                 np.concatenate([s[2] for s in seen]),
                                 labels_)
    np.testing.assert_array_equal(ev.linear_metrics.stats, linear.numpy())
    np.testing.assert_array_equal(ev.cluster_metrics.stats, cluster.numpy())
    out = os.path.join("results", "predictions", "t")
    for tree, ext in (("img", "jpg"), ("label", "png"), ("cluster", "png"),
                      ("linear", "png")):
        assert sorted(os.listdir(os.path.join(out, tree))) == [
            f"{i}.{ext}" for i in range(3)]
    for fig in ("comparison.png", "conf_matrix.png"):
        assert os.path.getsize(os.path.join(out, fig)) > 0
    ev.run(save_outputs=False, max_batches=1)  # a run counts afresh
    assert int(ev.linear_metrics.stats.sum()) == int((labels_[:6] >= 0).sum())


def test_figures_without_matplotlib_print_one_line_each(exported, capsys,
                                                        monkeypatch):
    """Where matplotlib does not import (the card's machine), the PNG trees
    are written and each figure not written is named on a line."""
    cfg, path, items = exported
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    evaluate(torch_config(cfg.replace(run_crf=False, experiment_name="u")),
             path, "cpu",
             val_dataset=ContrastiveSegDataset.from_items(items, 5))
    out = os.path.join("results", "predictions", "u")
    assert len(os.listdir(os.path.join(out, "img"))) == 5
    said = [ln for ln in capsys.readouterr().out.splitlines()
            if "not written, matplotlib does not import" in ln]
    assert said == [f"{os.path.join(out, f)}: not written, matplotlib does "
                    f"not import" for f in ("comparison.png",
                                            "conf_matrix.png")]


def test_evaluate_refuses_picie_and_several_devices(exported):
    """run_picie on a cocostuff27 checkpoint (the JAX loop's condition)
    raises, naming ROADMAP.md; num_devices > 1 in one process raises and
    says how to start the processes (tests/test_torch_ddp_app.py runs
    two)."""
    cfg, path, _ = exported
    coco = cfg.replace(dataset_name="cocostuff27", run_picie=True)
    coco_path = path.replace("m.ckpt", "coco.ckpt")
    _, bb, params = jax_model(cfg, seed=9)
    export_stego_checkpoint(coco_path, coco, bb, params)
    with pytest.raises(NotImplementedError, match="ROADMAP.*Other backbones"):
        Evaluator(torch_config(coco), coco_path, "cpu", val_dataset=[])
    with pytest.raises(ValueError, match="num_devices=2 asks for 2 "
                       "processes and this is one of 1: start them with "
                       "python -m stego_torch.eval"):
        Evaluator(torch_config(cfg.replace(num_devices=2)), path, "cpu",
                  val_dataset=[])


def test_eval_main_needs_a_cuda_device(tmp_path):
    """``python -m stego_torch.eval`` runs on the card: in a process that
    sees no CUDA device it exits with an error that says so and writes
    nothing."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-m", "stego_torch.eval",
         f"model_path={tmp_path / 'm.ckpt'}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "runs on a CUDA device and found none" in proc.stderr
    assert os.listdir(tmp_path) == []
