"""Bilinear grid sampling with the reference's ``F.grid_sample`` semantics;
counterpart of ``stego_tpu/ops/sampling.py``.

The reference samples feature and code maps at random normalized
coordinates with ``F.grid_sample(t, coords.permute(0, 2, 1, 3),
padding_mode='border', align_corners=True)`` (src/modules.py:287-288).
:func:`sample_from_coords` is exactly that, on NHWC maps.
:func:`bilinear_sample_weights` is the same sampling as a (B, S, H*W) weight
matrix, built with the JAX package's corner math; the plain version of
kernel C1 samples with it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def corner_weights(hw: Sequence[int], grid: torch.Tensor):
    """(y0, y1, x0, x1, fy, fx) of each grid point, border-clamped with
    aligned corners, shaped like the grid's leading dims
    (``sampling.py:33-59``). ``grid[..., 0]`` indexes width,
    ``grid[..., 1]`` height, both in [-1, 1]."""
    h, w = int(hw[0]), int(hw[1])
    ix = (grid[..., 0].float() + 1.0) * 0.5 * (w - 1)
    iy = (grid[..., 1].float() + 1.0) * 0.5 * (h - 1)
    ix = torch.clamp(ix, 0.0, w - 1)
    iy = torch.clamp(iy, 0.0, h - 1)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = ix - x0
    fy = iy - y0
    x0 = x0.long()
    y0 = y0.long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    return y0, y1, x0, x1, fy, fx


def bilinear_sample_weights(hw: Sequence[int],
                            grid: torch.Tensor) -> torch.Tensor:
    """(B, Hg*Wg, H*W) f32 bilinear weight matrix of a (B, Hg, Wg, 2) grid:
    row s is the outer product of a row weight (y0: 1-fy, y1: fy) and a
    column weight (``sampling.py:85-110``). On a border clamp (y0 == y1)
    both terms land on one entry."""
    h, w = int(hw[0]), int(hw[1])
    y0, y1, x0, x1, fy, fx = corner_weights((h, w), grid)
    bg = grid.shape[0]
    s = grid.shape[1] * grid.shape[2]
    y0, y1, x0, x1, fy, fx = (t.reshape(bg, s, 1)
                              for t in (y0, y1, x0, x1, fy, fx))
    yy = torch.arange(h, device=grid.device)
    xx = torch.arange(w, device=grid.device)
    zero = torch.zeros((), device=grid.device)
    wy = torch.where(yy == y0, 1.0 - fy, zero) + torch.where(yy == y1, fy,
                                                             zero)
    wx = torch.where(xx == x0, 1.0 - fx, zero) + torch.where(xx == x1, fx,
                                                             zero)
    return (wy[:, :, :, None] * wx[:, :, None, :]).reshape(bg, s, h * w)


def sample_from_coords(t: torch.Tensor,
                       coords: torch.Tensor) -> torch.Tensor:
    """Reference ``modules.sample`` (src/modules.py:287-288) on an NHWC map
    (B, H, W, C): bilinear, border padding, aligned corners, coords in torch
    (x, y) order. The grid's two spatial axes are transposed before
    sampling, so (B, S1, S2, 2) coords give (B, S2, S1, C)."""
    grid = coords.transpose(1, 2).to(t.dtype)
    out = F.grid_sample(t.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)
