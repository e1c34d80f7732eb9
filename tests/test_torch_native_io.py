"""stego_torch's native image decoder (``stego_torch/data/native_io.py``
and its copy of ``imageio.cpp``) against the JAX package's and PIL's: the
source is the JAX package's byte for byte, it builds under
``build/stego_torch/``, and every decode of the JAX tests' corpus, random
crops' draws included, equals the JAX decoder's and the PIL pipeline's;
ineligible files and late failures fall back to PIL with the same arrays
and the same rng stream."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from stego_tpu.data import native_io as jax_native_io
from stego_torch.data import native_io
from stego_torch.data.transforms import get_transform
from stego_torch.kernels.build import BUILD_DIR

from tests.test_native_io import _write_corpus
from tests._torch_cpu import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]



@pytest.fixture(autouse=True)
def needs_the_decoder():
    """Decided at run time, so every test process collects the same
    tests."""
    if not native_io.native_loader_available():
        pytest.skip("native imageio unavailable (no g++ or libjpeg/libpng "
                    "dev files)")


def test_source_is_the_jax_packages_copy():
    assert (REPO / "stego_torch" / "data" / "imageio.cpp").read_bytes() == \
        (REPO / "stego_tpu" / "native" / "imageio.cpp").read_bytes()
    assert not list((REPO / "stego_torch" / "data").glob("*.so"))
    assert list(BUILD_DIR.glob("libstego_imageio_*.so"))


@pytest.mark.parametrize("crop", [None, "center", "random"])
def test_decodes_match_jax_and_pil(tmp_path, crop):
    rng = np.random.default_rng(0)
    checked = 0
    for path in _write_corpus(tmp_path, rng):
        for is_label in (False, True):
            res = int(rng.integers(32, 200))
            for force_rgb in ((False, True) if not is_label else (False,)):
                draws = [np.random.default_rng(42) for _ in range(3)]
                got = native_io.decode_transform_path(
                    path, res, crop, is_label, draws[0], force_rgb)
                want = jax_native_io.decode_transform_path(
                    path, res, crop, is_label, draws[1], force_rgb)
                img = Image.open(path)
                if force_rgb and img.mode != "RGB":
                    img = img.convert("RGB")
                pil = get_transform(res, is_label, crop)(img, draws[2])
                assert got is not None, (path, is_label)
                for ref in (want, pil):
                    assert got.dtype == ref.dtype and got.shape == ref.shape
                    np.testing.assert_array_equal(got, ref)
                tails = [r.integers(0, 1000, 4) for r in draws]
                np.testing.assert_array_equal(tails[0], tails[1])
                np.testing.assert_array_equal(tails[0], tails[2])
                checked += 1
    assert checked == 6 * 3


def test_fast_decode_matches_jax(tmp_path):
    arr = np.random.default_rng(5).integers(0, 255, (400, 520, 3), np.uint8)
    p = str(tmp_path / "big.jpg")
    Image.fromarray(arr).save(p, quality=90)
    got = native_io.decode_transform_path(p, 64, "center", False, None,
                                          True, fast=True)
    want = jax_native_io.decode_transform_path(p, 64, "center", False, None,
                                               True, fast=True)
    np.testing.assert_array_equal(got, want)


def test_ineligible_and_failed_decodes_fall_back_to_pil(tmp_path,
                                                        monkeypatch):
    """A CMYK JPEG is refused before any draw; a decode that fails after
    the crop's draws leaves the caller's rng as it was. Either way the
    Transform gives the PIL pipeline's arrays and rng stream."""
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 255, (90, 130, 3), np.uint8)
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(arr).convert("CMYK").save(cmyk, quality=90)
    png = str(tmp_path / "x.png")
    Image.fromarray(arr).save(png)
    assert native_io.decode_transform_path(
        cmyk, 48, "random", False, np.random.default_rng(7), False) is None
    t = get_transform(48, False, "random")

    def same_as_pil(path):
        r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
        np.testing.assert_array_equal(t(path, r1, force_rgb=True),
                                      t(Image.open(path).convert("RGB"), r2))
        np.testing.assert_array_equal(r1.integers(0, 1000, 4),
                                      r2.integers(0, 1000, 4))

    same_as_pil(cmyk)

    class _FailLib:
        @staticmethod
        def stego_decode_transform(*a, **k):
            return -7  # E_DECODE

    monkeypatch.setattr(native_io, "_lib", lambda: _FailLib())
    same_as_pil(png)
    monkeypatch.setattr(native_io, "_DISABLED", True)
    monkeypatch.setattr(native_io, "_lib", lambda: None)
    same_as_pil(png)


def test_a_library_that_cannot_load_takes_the_pil_path(tmp_path,
                                                       monkeypatch):
    """A decoder library built on another machine whose libjpeg or libpng
    this one lacks (dlopen fails) turns the native path off instead of
    raising."""
    def no_dlopen(path):
        raise OSError("libjpeg.so.62: cannot open shared object file")

    monkeypatch.setattr(native_io, "_img_lib", None)
    monkeypatch.setattr(native_io.ctypes, "CDLL", no_dlopen)
    assert native_io.load_imageio_library() is None
    assert not native_io.native_loader_available()
    arr = np.random.default_rng(6).integers(0, 255, (40, 50, 3), np.uint8)
    p = str(tmp_path / "x.png")
    Image.fromarray(arr).save(p)
    t = get_transform(32, False, "center")
    np.testing.assert_array_equal(t(p), t(Image.open(p)))
