"""The port's grid CRF (stego_torch/ops/crf.py) against the JAX package's
(stego_tpu/ops/crf.py) on the same seeded inputs.

The gate. Both are the same f32 function, and both round: the bilateral
messages sum ~M x stride^2 terms (over 10^4 at these shapes), and the
softmax after them saturates, so one f32 rounding of a message can move a
near-tied pixel's probabilities by up to ~1e-2 (measured on the CPU: up to
6.7e-3 at 160 x 160 after 3 iterations, 1.6e-3 on a scene after 10). The
JAX package is no closer than the port to the same function evaluated in
f64 (its largest error there is 0.4-2.3 times the port's). So the port is
held (1) to JAX's argmax everywhere, (2) to JAX's probabilities within
atol 1e-4 on at least 99.5% of the elements, with a mean |difference| under
2e-6, and (3) to the f64 evaluation at most 3 times as far as JAX is, by
the largest and by the mean error. The control, the same function with
non-antialiased pooling (what ``jax.image.resize`` does not do), must fail
(1) and (2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stego_tpu.ops.crf import _bilateral_kernel_coarse
from stego_tpu.ops.crf import dense_crf as jax_dense_crf
from stego_torch.data.synthetic import render_scene
from stego_torch.ops import crf
from stego_torch.ops.crf import bilateral_kernel, dense_crf
from tests._torch_cpu import one_intra_op_thread  # noqa: F401

SHAPES = [(2, 64, 64, 5, 16), (1, 60, 52, 27, 15), (1, 160, 160, 27, 40)]
ATOL, SHARE, MEAN, F64_RATIO = 1e-4, 0.995, 2e-6, 3.0


def inputs(shape, kind, seed=0):
    """(B, H, W, 3) image in [0, 1] (uniform noise, or synthetic scenes of
    textured regions) and (B, h, w, C) logits at a quarter of the size."""
    b, h, w, c, lr = shape
    rng = np.random.default_rng(seed)
    if kind == "noise":
        img = rng.random((b, h, w, 3), dtype=np.float32)
    else:
        img = np.stack([render_scene(rng, max(h, w), c)[0][:h, :w]
                        for _ in range(b)]).astype(np.float32)
    logits = 2.0 * rng.standard_normal((b, lr, lr, c)).astype(np.float32)
    return img, logits


def port(img, logits, n_iter):
    return dense_crf(torch.from_numpy(img), torch.from_numpy(logits),
                     n_iter).numpy()


def jax_crf(img, logits, n_iter):
    return np.asarray(jax_dense_crf(jnp.asarray(img), jnp.asarray(logits),
                                    n_iter=n_iter))


def gate(got, want):
    """(argmax equal everywhere, share within ATOL, mean |diff|)."""
    d = np.abs(got - want)
    return (bool((got.argmax(-1) == want.argmax(-1)).all()),
            float((d <= ATOL).mean()), float(d.mean()))


@pytest.mark.parametrize("n_iter", [10, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["noise", "scene"])
def test_dense_crf_matches_jax(shape, n_iter, kind):
    img, logits = inputs(shape, kind)
    want = jax_crf(img, logits, n_iter)
    got = port(img, logits, n_iter)
    assert got.shape == want.shape and got.dtype == np.float32
    argmax_equal, share, mean = gate(got, want)
    assert argmax_equal and share >= SHARE and mean <= MEAN, (share, mean)
    ref = dense_crf(torch.from_numpy(img).double(),
                    torch.from_numpy(logits).double(), n_iter).numpy()
    for reduce in (np.max, np.mean):
        port_err = reduce(np.abs(got - ref))
        jax_err = reduce(np.abs(want - ref))
        assert port_err <= F64_RATIO * max(jax_err, 1e-9), (reduce, port_err,
                                                            jax_err)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_non_antialiased_pooling_fails_the_gate(shape, monkeypatch):
    """The control: the port with a 2 x 2 bilinear tap in place of the
    antialiased triangle filter."""
    monkeypatch.setattr(crf, "pool", lambda x, hw: F.interpolate(
        x, size=tuple(hw), mode="bilinear", align_corners=False))
    img, logits = inputs(shape, "noise")
    want = jax_crf(img, logits, 10)
    argmax_equal, share, _ = gate(port(img, logits, 10), want)
    assert not argmax_equal and share < SHARE


def test_bilateral_kernel_matches_jax():
    """The coarse kernel alone, at res 64: f32 roundings of the pooled
    guidance (0-255) times 1 / (2 * 3^2) in the exponent."""
    img, _ = inputs(SHAPES[0], "scene")
    want = np.asarray(_bilateral_kernel_coarse(jnp.asarray(img) * 255.0, 8))
    got = bilateral_kernel(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.all(np.diagonal(got, axis1=1, axis2=2) == 0)


def test_shared_kernel_gives_the_same_result():
    """The eval step builds the bilateral kernel once for both probes."""
    img, logits = inputs(SHAPES[0], "scene")
    timg = torch.from_numpy(img)
    kern = bilateral_kernel(timg)
    np.testing.assert_array_equal(
        dense_crf(timg, torch.from_numpy(logits), 3, kern=kern).numpy(),
        port(img, logits, 3))


def test_output_is_a_distribution():
    img, logits = inputs((1, 32, 32, 4, 8), "noise")
    out = port(img, logits, 3)
    assert out.shape == (1, 32, 32, 4) and (out >= 0).all()
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
