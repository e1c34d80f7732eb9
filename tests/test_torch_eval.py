"""The stego_torch flip-TTA slice as a whole against the JAX make_eval_step,
and the demo entry point."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stego_tpu.data.transforms import get_transform
from stego_tpu.eval.demo import demo as jax_demo
from stego_tpu.eval.evaluate import make_eval_step as jax_make_eval_step
from stego_tpu.models.export import export_stego_checkpoint
from stego_torch.eval.demo import demo, load_image
from stego_torch.eval.evaluate import (
    flip_tta_code,
    load_model_for_eval,
    make_eval_step,
)
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


def test_run_crf_raises():
    cfg = make_cfg()
    seg = both(cfg)[3]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_eval_step(seg, run_crf=True)


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
    cfg = make_cfg(run_crf=False, batch_size=1)
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
    step = make_eval_step(load_model_for_eval(ckpt, "cpu"))
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
