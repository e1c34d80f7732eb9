"""NHWC resize with PyTorch ``F.interpolate``'s semantics; counterpart of
``stego_tpu/ops/interp.py:interpolate``.

As in the JAX package, a separable resize is two small dense matmuls,
out = W_h @ x @ W_w^T, whose (out, in) weight matrices are computed in f64
with numpy (bilinear, and bicubic with A = -0.75; ``align_corners`` either
way; target given by size), rounded to f32 and kept on each device. Torch's
own operator takes its source positions from an f32 scale, which at a
ratio that is not an integer (40 -> 56) moves a bilinear output by far
more than the f32 rounding of the matrices; its CUDA backward adds with
atomics, the matmuls' does not.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

METHODS = ("bilinear", "bicubic")


def _source_coords(out_size: int, in_size: int,
                   align_corners: bool) -> np.ndarray:
    """Output index -> fractional input coordinate, torch's semantics."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            return np.zeros(1, dtype=np.float64)
        return i * (in_size - 1) / (out_size - 1)
    return (i + 0.5) * (in_size / out_size) - 0.5


def _linear_weight_matrix(out_size: int, in_size: int,
                          align_corners: bool) -> np.ndarray:
    """(out_size, in_size) f64 bilinear weights (``interp.py:35-50``)."""
    src = _source_coords(out_size, in_size, align_corners)
    if not align_corners:
        src = np.clip(src, 0.0, None)  # torch clamps the source at 0
    x0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    t = np.clip(src - x0, 0.0, 1.0)
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(w, (rows, x0), 1.0 - t)
    np.add.at(w, (rows, x1), t)
    return w


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys' cubic convolution kernel, torch's A = -0.75."""
    at = np.abs(t)
    at2, at3 = at * at, at * at * at
    return np.where(
        at <= 1.0, (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0,
        np.where(at < 2.0, a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a,
                 0.0))


def _cubic_weight_matrix(out_size: int, in_size: int,
                         align_corners: bool) -> np.ndarray:
    """(out_size, in_size) f64 bicubic weights (``interp.py:66-76``): the
    four taps of each output, clamped to the border."""
    src = _source_coords(out_size, in_size, align_corners)
    x0 = np.floor(src).astype(np.int64)
    t = src - x0
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    for k in range(-1, 3):
        idx = np.clip(x0 + k, 0, in_size - 1)
        np.add.at(w, (rows, idx), _cubic_kernel(k - t))
    return w


@functools.lru_cache(maxsize=256)
def _weight_matrix(out_size: int, in_size: int, method: str,
                   align_corners: bool) -> np.ndarray:
    builder = (_linear_weight_matrix if method == "bilinear"
               else _cubic_weight_matrix)
    return builder(out_size, in_size, align_corners).astype(np.float32)


_ON_DEVICE: Dict[Tuple, torch.Tensor] = {}


def _weights(out_size: int, in_size: int, method: str, align_corners: bool,
             device: torch.device) -> torch.Tensor:
    """The f32 weight matrix on ``device``, copied there once (a copy made
    while ``torch.export`` traces is one of its fake tensors, and is not
    kept)."""
    key = (out_size, in_size, method, align_corners, str(device))
    if key in _ON_DEVICE:
        return _ON_DEVICE[key]
    w = torch.from_numpy(_weight_matrix(out_size, in_size, method,
                                        align_corners)).to(device)
    if type(w) is torch.Tensor:
        _ON_DEVICE[key] = w
    return w


def interpolate(x: torch.Tensor, size: Union[int, Sequence[int]],
                method: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """Resize NHWC ``x`` to ``size`` (int or (h, w)); computes in f32 and
    returns x's dtype."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    out_hw = (size, size) if isinstance(size, int) else (int(size[0]),
                                                          int(size[1]))
    h, w = x.shape[1:3]
    if (h, w) == out_hw:
        return x
    wh, ww = (_weights(o, i, method, align_corners, x.device)
              for o, i in zip(out_hw, (h, w)))
    y = torch.einsum("ih,bhwc->biwc", wh, x.float())
    y = torch.einsum("jw,biwc->bijc", ww, y)
    return y.to(x.dtype)
