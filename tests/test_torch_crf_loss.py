"""The in-training CRF loss (stego_torch/ops/crf_loss.py), the train step's
``crf_weight > 0`` branch and the CRF experiment app
(stego_torch/train/crf_app.py) against the JAX package's, on the same seeded
inputs and the JAX runs' own random draws (coordinates, initial code
table), reproduced from their keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.config import Config as JaxConfig
from stego_tpu.ops.crf_loss import CRFLossCfg as JaxCRFLossCfg
from stego_tpu.ops.crf_loss import contrastive_crf_loss as jax_crf_loss
from stego_tpu.train.crf_app import rgb_to_normed_lab as jax_lab
from stego_tpu.train.crf_app import train_crf_codes as jax_train_crf_codes
from stego_tpu.train.segmenter import _split_step_keys
from stego_tpu.train.segmenter import make_train_step as jax_make_train_step
from stego_torch.ops.crf_loss import CRFLossCfg, contrastive_crf_loss
from stego_torch.train.crf_app import rgb_to_normed_lab, train_crf_codes
from stego_torch.train.segmenter import (CRF_RES, UnsupervisedSegmenter,
                                         draw_step_randomness,
                                         make_cached_train_step,
                                         make_train_step)

from tests.test_torch_config import torch_config
from tests.test_torch_train_step import (B, METRIC_TOL, assert_state_close,
                                         jax_step_draws, make_batch,
                                         make_cfg, setup, to_torch)
from tests.test_torch_vit import CFG


def crf_coords(key, s, h, w):
    """contrastive_crf_loss's draws from ``key`` (``crf_loss.py:49-52``)."""
    ky, kx = jax.random.split(key)
    return (np.array(jax.random.randint(ky, (s,), 0, h)),
            np.array(jax.random.randint(kx, (s,), 0, w)))


@pytest.mark.parametrize("shift", [0.0, 0.3])
def test_contrastive_crf_loss_matches_jax(shift):
    """(B, S, S) losses within rtol 1e-5, atol 1e-5, with coordinates
    drawn from a JAX key and handed to both; and the gradient through the
    clusters."""
    rng = np.random.default_rng(0)
    guidance = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)
    clusters = rng.standard_normal((2, 12, 10, 7)).astype(np.float32)
    clusters /= np.linalg.norm(clusters, axis=-1, keepdims=True)
    ys, xs = crf_coords(jax.random.PRNGKey(3), 50, 12, 10)
    jcfg = JaxCRFLossCfg(n_samples=50, shift=shift)
    want = jax_crf_loss(jcfg, None, jnp.asarray(guidance),
                        jnp.asarray(clusters), coords=(ys, xs))
    cfg = CRFLossCfg(n_samples=50, shift=shift)
    tc = torch.from_numpy(clusters).requires_grad_(True)
    got = contrastive_crf_loss(cfg, torch.from_numpy(guidance), tc,
                               (torch.from_numpy(ys), torch.from_numpy(xs)))
    assert got.shape == (2, 50, 50)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got.mean().backward()
    want_grad = jax.grad(lambda c: jnp.mean(jax_crf_loss(
        jcfg, None, jnp.asarray(guidance), c, coords=(ys, xs))))(
            jnp.asarray(clusters))
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-7)


def test_draws_and_cached_step():
    """draw_step_randomness draws crf_samples rows and columns of the 56 x
    56 maps; the cached step, which has no images, refuses the loss as the
    JAX package's feature cache does."""
    cfg = torch_config(make_cfg(crf_weight=0.1, crf_samples=300))
    seg = UnsupervisedSegmenter(5, cfg, vit_cfg=CFG)
    rand = draw_step_randomness(seg, B, torch.Generator().manual_seed(0))
    for k in ("crf_ys", "crf_xs"):
        assert rand[k].shape == (300,) and rand[k].dtype == torch.int64
        assert 0 <= int(rand[k].min()) and int(rand[k].max()) < CRF_RES
    with pytest.raises(ValueError, match="feature cache"):
        make_cached_train_step(seg)
    seg.cfg = cfg.replace(crf_weight=0.0)
    assert "crf_ys" not in draw_step_randomness(
        seg, B, torch.Generator().manual_seed(0))


def test_train_step_with_crf_loss_matches_jax_two_steps():
    """crf_weight=0.1 (1000 samples): two steps against the JAX step with
    its own draws, the CRF's from ``_split_step_keys(key)["crf"]``; every
    metric (loss/crf among them) and the updated parameters and Adam
    moments at the image step's tolerances."""
    cfg = make_cfg(crf_weight=0.1)
    jseg, bb, jstate, seg = setup(cfg)
    jstep = jax.jit(jax_make_train_step(jseg, with_hist=False))
    step = make_train_step(seg, with_hist=False)
    batch = make_batch(3)
    tb = to_torch(batch)
    for i in range(2):
        key = jax.random.PRNGKey(200 + i)
        rand = jax_step_draws(jseg, key, B)
        ys, xs = crf_coords(_split_step_keys(key)["crf"], cfg.crf_samples,
                            CRF_RES, CRF_RES)
        rand["crf_ys"], rand["crf_xs"] = (torch.from_numpy(ys).long(),
                                          torch.from_numpy(xs).long())
        jstate, jm = jstep(bb, jstate, batch, key)
        jstate = jax.tree.map(np.asarray, jstate)
        m = step(tb, rand)
        assert m.keys() == jm.keys() and "loss/crf" in m
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       **METRIC_TOL, err_msg=k)
        assert_state_close(seg, jstate)


def test_rgb_to_normed_lab_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.random((3, 9, 7, 3), dtype=np.float32)
    img[0, 0, 0] = 0.0  # the linear branches of both piecewise maps
    np.testing.assert_allclose(
        rgb_to_normed_lab(torch.from_numpy(img)).numpy(),
        np.asarray(jax_lab(jnp.asarray(img))), rtol=1e-5, atol=2e-6)


def smooth_images(rng, n, h, w):
    """(n, h, w, 3) images that vary linearly across each image, so that
    every pixel's neighbours have nearly its colour and so a large weight
    in the CRF loss's appearance kernel."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    a, b, c = (rng.standard_normal((3, n, 1, 1, 3)).astype(np.float32))
    return a * (ys / h)[None, :, :, None] + b * (xs / w)[None, :, :, None] + c


CODE_SAMPLES = 240  # twice the pixels of a 12x10 image


@pytest.mark.parametrize("continuous", [True, False])
@pytest.mark.parametrize("color_space", ["rgb", "lab"])
def test_train_crf_codes_matches_jax(continuous, color_space):
    """3 epochs of the code table on 2 images, handed the JAX run's initial
    table and each epoch's coordinates: every epoch's loss within rtol
    1e-5, and every entry of the final table within rtol 1e-4, atol 1e-5,
    where at least 90% of the entries moved by over 1e-3.

    The images are smooth and the samples twice the pixels, so every
    sampled pixel has sampled neighbours of a like colour. A sampled pixel
    without one gets only its self-similarity, whose gradient through the
    l2 normalisation of continuous codes is 0 up to f32 rounding; Adam
    scales such a gradient to a step of ~lr in a direction set by that
    rounding, which the two packages need not share."""
    rng = np.random.default_rng(2)
    imgs = smooth_images(rng, 2, 12, 10)
    jcfg = JaxConfig(dim=5, continuous=continuous, color_space=color_space,
                     crf_samples=CODE_SAMPLES)
    want = jax_train_crf_codes(jcfg, imgs, epochs=3, log_every=1, seed=4)
    key = jax.random.PRNGKey(4)
    init = np.asarray(0.1 * jax.random.normal(key, (2, 12, 10, 5),
                                              jnp.float32))
    got = train_crf_codes(
        torch_config(jcfg), imgs, epochs=3, log_every=1, device="cpu",
        init_codes=init,
        draw_coords=lambda i: tuple(torch.from_numpy(c) for c in crf_coords(
            jax.random.fold_in(key, i), CODE_SAMPLES, 12, 10)))
    assert got["losses"].shape == (3,)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
    moved = float(np.mean(np.abs(want["codes"] - init) > 1e-3))
    assert moved >= 0.9, moved
    np.testing.assert_allclose(got["codes"], want["codes"], rtol=1e-4,
                               atol=1e-5)


def test_train_crf_codes_loss_falls_and_writes_figures(tmp_path, capsys,
                                                       monkeypatch):
    """The app's own draws on a CPU: 20 epochs, the loss falls; a figure
    every log_every epochs, or a line naming it without matplotlib."""
    import sys

    from stego_torch.config import Config

    rng = np.random.default_rng(3)
    imgs = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)
    cfg = Config(dim=5, crf_samples=60)
    out = train_crf_codes(cfg, imgs, epochs=20, log_every=10, device="cpu",
                          out_dir=str(tmp_path / "a"))
    assert out["losses"][-1] < out["losses"][0]
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "codes_0.png", "codes_10.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    train_crf_codes(cfg, imgs, epochs=1, device="cpu",
                    out_dir=str(tmp_path / "b"))
    assert "codes_0.png: not written" in capsys.readouterr().out
