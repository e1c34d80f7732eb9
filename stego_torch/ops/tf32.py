"""Plain emulations of the kernels' TF32 arithmetic (``csrc/tf32x3.cuh``).

Kernels A-f32 and C2 take their f32 products on the tensor cores by 3xTF32:
each f32 operand is split into a TF32 high part, ``hi = round_tf32(x)``,
and a TF32 low part, ``lo = round_tf32(x - hi)``, and each 8-deep step of a
product is ``a_lo b_hi + a_hi b_lo + a_hi b_hi``, summed apart and then
added to the running f32 sum. These functions do the same arithmetic in
plain PyTorch so that tests can hold it, and a single TF32 pass as its
control, against the JAX package's f32 functions; ``chip_smoke.py`` uses
the single pass as a control on the card. No main path calls them.
"""

from __future__ import annotations

import torch

STEP = 8  # depth of one m16n8k8 product


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``), on the f32 bit pattern; infinities
    and NaNs pass unchanged."""
    x = x.float()
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000  # half an ulp, cut
    out = (bits & 0x80000000) | mag
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)
    return torch.where(torch.isfinite(x), out.view(torch.float32), x)


def split_tf32(x: torch.Tensor):
    """(hi, lo): hi = round_tf32(x), lo = round_tf32(x - hi)."""
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass: both operands rounded to TF32, f32 sums."""
    return round_tf32(a) @ round_tf32(b)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b by 3xTF32 as the kernels take it: for each 8-deep step of the
    contracted axis, in order, a_lo b_hi + a_hi b_lo + a_hi b_hi summed
    apart in f32 and added to the running f32 sum."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    depth = a.shape[-1]
    out = None
    for k0 in range(0, depth, STEP):
        ks = slice(k0, k0 + STEP)
        part = a_lo[..., ks] @ b_hi[..., ks, :] \
            + a_hi[..., ks] @ b_lo[..., ks, :]
        part = part + a_hi[..., ks] @ b_hi[..., ks, :]
        out = part if out is None else out + part
    return out
