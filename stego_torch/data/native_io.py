"""Native fast path for the host transform pipeline; counterpart of
``stego_tpu/data/native_io.py`` and of the image half of
``stego_tpu/native/__init__.py``.

Routes ``Transform`` calls that receive a file *path* through the C++ fused
decoder (``data/imageio.cpp``, the JAX package's ``native/imageio.cpp``
byte for byte): header-only PIL open to learn format/mode/
size, resize+crop geometry computed here with the exact arithmetic of the PIL
path (``transforms._resize_short_side`` / ``_center_crop`` / ``_random_crop``
— including identical ``rng.integers`` draws, so downstream sampling stays in
sync), then one ctypes call that decodes only the kept scanlines and writes
the final normalized array. Any ineligible input (CMYK JPEG, interlaced or
16-bit PNG, exotic modes, pad-needed crops, decode errors) returns ``None``
and the caller runs the ordinary PIL path — behavior is identical either way
(asserted bit-exactly in tests/test_native_io.py and
tests/test_torch_native_io.py).

The decoder builds at first use with one ``g++`` call (``-ljpeg -lpng``)
into ``build/stego_torch/`` at the root of the checkout (git-ignored), named
by a hash of the source; when it cannot build, every call takes the PIL
path. ``STEGO_NATIVE_LOADER=0`` turns the native path off, as in the JAX
package.

Reference behavior being accelerated: src/utils.py:128-183 (get_transform)
driven by torch DataLoader native workers (src/train_segmentation.py:453).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

_SRC = Path(__file__).resolve().parent / "imageio.cpp"
_lock = threading.Lock()
_img_lib = None  # CDLL | None; False = the build failed, do not retry
_MODE_IMG_RGB = 0
_MODE_IMG_KEEP_ALPHA = 1
_MODE_LABEL = 2

# PIL modes the C++ decoder handles per container. Anything else -> PIL path.
_OK_MODES = {"JPEG": {"L", "RGB"}, "PNG": {"L", "P", "RGB", "RGBA"}}

_DISABLED = os.environ.get("STEGO_NATIVE_LOADER", "1") == "0"


def load_imageio_library():
    """The image decoder's CDLL, or None when it cannot build (no g++ or
    no libjpeg/libpng development files) or load (no libjpeg/libpng);
    callers then take the PIL path."""
    global _img_lib
    with _lock:
        if _img_lib is not None:
            return _img_lib or None
        from stego_torch.kernels.build import BUILD_DIR

        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"libstego_imageio_{digest}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                   "-std=c++17", str(_SRC), "-o", str(tmp), "-ljpeg",
                   "-lpng"]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except (subprocess.CalledProcessError, OSError):
                _img_lib = False
                return None
            os.replace(tmp, lib_path)
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:  # built elsewhere, and its libjpeg/libpng are absent
            _img_lib = False
            return None
        lib.stego_decode_transform.restype = ctypes.c_int
        lib.stego_decode_transform.argtypes = [
            ctypes.c_char_p,                 # path
            ctypes.c_int, ctypes.c_int,      # exp_w, exp_h
            ctypes.c_int, ctypes.c_int,      # resized_h, resized_w
            ctypes.c_int, ctypes.c_int,      # top, left
            ctypes.c_int, ctypes.c_int,      # out_h, out_w
            ctypes.c_int, ctypes.c_int,      # mode, normalize
            ctypes.c_int,                    # fast (DCT-scaled jpeg decode)
            ctypes.POINTER(ctypes.c_float),  # mean
            ctypes.POINTER(ctypes.c_float),  # stdv
            ctypes.c_int,                    # out_c
            ctypes.c_void_p,                 # out
        ]
        _img_lib = lib
        return lib


def _lib():
    if _DISABLED:
        return None
    return load_imageio_library()


def native_loader_available() -> bool:
    return _lib() is not None


def resized_dims(h: int, w: int, res: Union[int, Tuple[int, int]]
                 ) -> Tuple[int, int]:
    """(h, w) after ``_resize_short_side`` — identical integer arithmetic."""
    if isinstance(res, tuple):
        return res
    if (w <= h and w == res) or (h <= w and h == res):
        return h, w
    if w < h:
        return int(res * h / w), res
    return res, int(res * w / h)


def decode_transform_path(
    path: str,
    res: int,
    crop_type: Optional[str],
    is_label: bool,
    rng: Optional[np.random.Generator],
    force_rgb: bool,
    fast: bool = False,
) -> Optional[np.ndarray]:
    """Run the fused native pipeline for one file, or None to use PIL.

    Output matches the PIL path bit-for-bit: float32 HWC ImageNet-normalized
    images (RGB, or RGBA when the source carries alpha and ``force_rgb`` is
    off) / int64 HW labels. ``fast`` (config ``fast_decode``) additionally
    lets JPEG images decode at a reduced DCT scale that still covers the
    resize target — ~2x faster on large downscales, pixel values no longer
    PIL-identical (the IDCT's area downscale replaces part of the NEAREST
    subsample; arguably higher-quality, but it is a documented deviation).
    """
    lib = _lib()
    if lib is None:
        return None
    from PIL import Image

    try:
        with Image.open(path) as im:  # header-only: no decode
            fmt, mode, (w, h) = im.format, im.mode, im.size
    except Exception:
        return None
    if fmt not in _OK_MODES or mode not in _OK_MODES[fmt]:
        return None

    size: Union[int, Tuple[int, int]] = (res, res) if crop_type is None else res
    rh, rw = resized_dims(h, w, size)
    committed_rng_state = None
    if crop_type is None:
        top, left, oh, ow = 0, 0, rh, rw
    elif crop_type == "center":
        if rh < res or rw < res:
            return None  # pad path: PIL fallback (unreachable after resize)
        top, left, oh, ow = (rh - res) // 2, (rw - res) // 2, res, res
    elif crop_type == "random":
        if rh < res or rw < res:
            return None
        # Same draws in the same order as transforms._random_crop — but from
        # a CLONE: the caller's rng only advances if the native decode
        # succeeds, so a late failure leaves the PIL fallback's draws (and
        # everything downstream) identical to a pure-PIL run.
        r = np.random.default_rng()
        src = rng if rng is not None else np.random.default_rng()
        r.bit_generator.state = src.bit_generator.state
        top = int(r.integers(0, rh - res + 1))
        left = int(r.integers(0, rw - res + 1))
        oh = ow = res
        if rng is not None:
            committed_rng_state = r.bit_generator.state
    else:
        return None

    from stego_torch.data.transforms import channel_stats

    if is_label:
        cmode, out_c = _MODE_LABEL, 1
        out = np.empty((oh, ow), np.int32)
        mean = std = np.zeros(1, np.float32)
    else:
        keep_alpha = (not force_rgb) and mode == "RGBA"
        cmode = _MODE_IMG_KEEP_ALPHA if keep_alpha else _MODE_IMG_RGB
        out_c = 4 if keep_alpha else 3
        out = np.empty((oh, ow, out_c), np.float32)
        mean, std = channel_stats(out_c)
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)

    fp = ctypes.POINTER(ctypes.c_float)
    ret = lib.stego_decode_transform(
        path.encode(), w, h, rh, rw, top, left, oh, ow, cmode,
        0 if is_label else 1, 1 if (fast and not is_label) else 0,
        mean.ctypes.data_as(fp), std.ctypes.data_as(fp),
        out_c, out.ctypes.data_as(ctypes.c_void_p),
    )
    if ret != 0:
        return None
    if committed_rng_state is not None:
        rng.bit_generator.state = committed_rng_state
    return out.astype(np.int64) if is_label else out
