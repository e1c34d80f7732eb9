"""The port's permutohedral lattice (stego_torch/native, the JAX package's
C++ source byte for byte, built with the same g++ flags) and its exact CRF
(stego_torch/ops/crf_exact.py, the same numpy code) against brute force and
against the JAX package's: on the same inputs the outputs are equal bit for
bit."""

import filecmp
from pathlib import Path

import numpy as np
import pytest

from stego_tpu.native import PermutohedralLattice as JaxLattice
from stego_tpu.native import permutohedral_filter as jax_filter
from stego_tpu.ops import crf_exact as jax_exact
from stego_torch import native
from stego_torch.native import PermutohedralLattice, permutohedral_filter
from stego_torch.ops import crf_exact

REPO = Path(__file__).resolve().parents[1]


def brute_force(pos, vals):
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    k = np.exp(-d2 / 2)
    return (k @ vals) / k.sum(1, keepdims=True)


def test_source_is_the_jax_packages():
    assert filecmp.cmp(REPO / "stego_torch" / "native" / "permutohedral.cpp",
                       REPO / "stego_tpu" / "native" / "permutohedral.cpp",
                       shallow=False)


@pytest.mark.parametrize("pd,vd,scale,corr", [(2, 3, 4, 0.98), (5, 2, 3, 0.95)])
def test_lattice_matches_brute_force(rng, pd, vd, scale, corr):
    """As tests/test_native_crf.py: the normalised lattice filter against
    the dense Gaussian, and bit for bit against the JAX package's."""
    pos = rng.random((300, pd), dtype=np.float32) * scale
    vals = rng.random((300, vd), dtype=np.float32)
    got = permutohedral_filter(pos, vals, normalize=True)
    want = brute_force(pos, vals)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > corr
    if pd == 2:
        assert np.abs(got - want).mean() < 0.02
    np.testing.assert_array_equal(got, jax_filter(pos, vals, normalize=True))


def test_lattice_handle_matches_oneshot(rng):
    """The build-once handle equals the one-shot filter bit for bit, its
    applies do not change it, and it equals the JAX package's handle."""
    pos = rng.random((500, 5), dtype=np.float32) * 20
    vals = rng.random((500, 4), dtype=np.float32)
    lat = PermutohedralLattice(pos)
    one_shot = permutohedral_filter(pos, vals)
    np.testing.assert_array_equal(lat.apply(vals), one_shot)
    np.testing.assert_array_equal(lat.apply(vals), one_shot)
    np.testing.assert_array_equal(
        lat.apply(vals[:, :1]), permutohedral_filter(pos, vals[:, :1]))
    np.testing.assert_array_equal(lat.apply(vals),
                                  JaxLattice(pos).apply(vals))
    with pytest.raises(ValueError, match="values must be"):
        lat.apply(vals[:10])


def test_library_build_failure_names_the_compiler_error(tmp_path,
                                                         monkeypatch):
    """No other backend: a source that does not compile raises with g++'s
    message."""
    bad = tmp_path / "permutohedral.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr("stego_torch.kernels.build.BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="(?s)did not build.*error:"):
        native.load_library()


def crf_inputs(rng, b=2, h=28, w=24, lr=(7, 6), classes=(5, 3)):
    imgs = rng.random((b, h, w, 3), dtype=np.float32)
    logits = [rng.standard_normal((b, *lr, c)).astype(np.float32)
              for c in classes]
    return imgs, logits


def test_dense_crf_exact_matches_jax_bit_for_bit(rng):
    imgs, (la, lb) = crf_inputs(rng)
    for n_iter in (3, 10):
        np.testing.assert_array_equal(
            crf_exact.dense_crf_exact(imgs[0], la[0], n_iter),
            jax_exact.dense_crf_exact(imgs[0], la[0], n_iter))
    got = crf_exact.dense_crf_exact(imgs[0], la[0], 3)
    assert got.shape == (28, 24, 5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-4)


def test_dense_crf_exact_multi_matches_jax_bit_for_bit(rng):
    """One bilateral lattice shared by two logit sets, one of them already
    at full resolution."""
    imgs, (la, lb) = crf_inputs(rng, lr=(28, 24))
    got = crf_exact.dense_crf_exact_multi(imgs[1], [la[1], lb[1]], 4)
    want = jax_exact.dense_crf_exact_multi(imgs[1], [la[1], lb[1]], 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        got[1], crf_exact.dense_crf_exact(imgs[1], lb[1], 4))


@pytest.mark.parametrize("batch", [1, 3])
def test_dense_crf_exact_batch_multi_matches_jax_bit_for_bit(rng, batch):
    """A batch of one on the caller's thread, of three on the pool."""
    imgs, logits = crf_inputs(rng, b=batch)
    got = crf_exact.dense_crf_exact_batch_multi(imgs, logits, 4)
    want = jax_exact.dense_crf_exact_batch_multi(imgs, logits, 4)
    assert [g.shape for g in got] == [(batch, 28, 24, 5), (batch, 28, 24, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_spatial_cache_is_bounded_and_bit_exact(rng):
    crf_exact._SPATIAL_CACHE.clear()
    img = rng.random((20, 20, 3), dtype=np.float32)
    logits = rng.standard_normal((5, 5, 4)).astype(np.float32)
    fresh = crf_exact.dense_crf_exact(img, logits, 3)
    assert (20, 20) in crf_exact._SPATIAL_CACHE
    np.testing.assert_array_equal(crf_exact.dense_crf_exact(img, logits, 3),
                                  fresh)
    for size in (8, 10, 12, 14, 16):
        crf_exact._spatial_kernel(size, size)
        assert len(crf_exact._SPATIAL_CACHE) <= crf_exact._SPATIAL_CACHE_MAX
    assert crf_exact._SPATIAL_CACHE_MAX == 4
    assert list(crf_exact._SPATIAL_CACHE) == [(10, 10), (12, 12), (14, 14),
                                              (16, 16)]
