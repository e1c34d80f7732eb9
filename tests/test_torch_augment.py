"""stego_torch.ops.augment (the device route of the aug-alignment loss's
augmented view) against ``stego_tpu/ops/augment.py`` at the same injected
parameters: ``coord_aug`` exactly, images within 1e-5 (f32 sums in another
order); and the port's own parameter draws within their ranges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.ops import augment as jaug
from stego_torch.ops import augment as aug
from tests._torch_cpu import one_intra_op_thread  # noqa: F401


def jax_params(seed, b, h, w):
    kg, kp = jax.random.split(jax.random.PRNGKey(seed))
    return jaug.sample_geometric(kg, b, h, w), jaug.sample_photometric(kp, b)


def to_torch(p, cls):
    return cls(*(torch.from_numpy(np.array(f)) for f in p))


def image(seed, b, h, w, c=3):
    return np.random.default_rng(seed).random((b, h, w, c)).astype(
        np.float32)


@pytest.mark.parametrize("b,h,w,out", [(6, 32, 32, 32), (4, 24, 40, 24),
                                       (3, 64, 64, 48)])
def test_geometric_matches_jax(b, h, w, out):
    jg, _ = jax_params(h + w, b, h, w)
    # every flip, and a crop that is the whole image
    jg = jg._replace(flip=jnp.arange(b) % 2 == 0)
    img = image(1, b, h, w)
    want_img, want_coord = jaug.apply_geometric_device(jnp.asarray(img), jg,
                                                       out)
    got_img, got_coord = aug.apply_geometric_device(
        torch.from_numpy(img), to_torch(jg, aug.GeomParams), out)
    np.testing.assert_array_equal(got_coord.numpy(), np.asarray(want_coord))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [3, 4])
def test_photometric_matches_jax(c):
    """Every op order of the draw, grayscale and blur on some images; a
    fourth channel (Potsdam's IR) skips the colour ops."""
    b = 8
    _, jp = jax_params(7, b, 32, 32)
    jp = jp._replace(grayscale=jnp.arange(b) % 3 == 0,
                     blur=jnp.arange(b) % 2 == 1)
    img = image(2, b, 32, 32, c)
    img[0, :4] = 0.0  # black pixels: the HSV round trip's zero branches
    img[1, :, :4] = 0.5  # grey pixels: delta = 0
    want = np.asarray(jaug.apply_photometric_device(jnp.asarray(img), jp))
    got = aug.apply_photometric_device(torch.from_numpy(img),
                                       to_torch(jp, aug.PhotoParams))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_device_augment_matches_jax():
    """The whole device route on an ImageNet-normalised batch, with JAX's
    draws from the key ``device_augment`` splits."""
    b, h = 4, 32
    key = jax.random.PRNGKey(11)
    img = np.random.default_rng(3).standard_normal((b, h, h, 3)).astype(
        np.float32)
    want_img, want_coord = jaug.device_augment(key, jnp.asarray(img))
    kg, kp = jax.random.split(key)
    gp = to_torch(jaug.sample_geometric(kg, b, h, h), aug.GeomParams)
    pp = to_torch(jaug.sample_photometric(kp, b), aug.PhotoParams)
    got_img, got_coord = aug.device_augment(torch.from_numpy(img), gp, pp)
    np.testing.assert_array_equal(got_coord.numpy(), np.asarray(want_coord))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=0, atol=1e-5)


def test_sampling_bounds():
    """The port's draws keep the ranges ``tests/test_augment.py`` checks of
    the JAX package's."""
    b, h, w = 8, 28, 28
    g = torch.Generator().manual_seed(0)
    gp = aug.sample_geometric(g, b, h, w)
    assert gp.top.shape == (b,) and gp.flip.dtype == torch.bool
    top, left, ch, cw = (x.numpy() for x in (gp.top, gp.left, gp.ch, gp.cw))
    assert (ch >= 1).all() and (ch <= h).all()
    assert (cw >= 1).all() and (cw <= w).all()
    assert (top >= 0).all() and (top + ch <= h).all()
    assert (left >= 0).all() and (left + cw <= w).all()
    assert (ch * cw / (h * w) > 0.5).all()

    pp = aug.sample_photometric(g, b)
    np.testing.assert_array_equal(np.sort(pp.order.numpy(), axis=1),
                                  np.tile(np.arange(4), (b, 1)))
    assert (pp.brightness.numpy() >= 0.7).all()
    assert (pp.brightness.numpy() <= 1.3).all()
    assert (np.abs(pp.hue.numpy()) <= 0.1).all()
    assert (pp.blur_sigma.numpy() >= 0.1).all()
    assert (pp.blur_sigma.numpy() <= 2.0).all()


def test_device_augment_keeps_tf32_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        g = torch.Generator().manual_seed(1)
        img = torch.randn(2, 16, 16, 3, generator=g)
        out, coord = aug.device_augment(img, aug.sample_geometric(g, 2, 16,
                                                                  16),
                                        aug.sample_photometric(g, 2))
        assert out.shape == img.shape and coord.shape == (2, 16, 16, 2)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
