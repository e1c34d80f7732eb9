"""Plain emulations of the kernels' TF32 arithmetic (``csrc/tf32x3.cuh``).

Kernels A-f32 and C2 take their f32 products on the tensor cores by 3xTF32:
each f32 operand is split into a TF32 high part, ``hi = round_tf32(x)``,
and a TF32 low part, ``lo = round_tf32(x - hi)``, and each 8-deep step of a
product is ``a_lo b_hi + a_hi b_lo + a_hi b_hi``, summed apart and then
added to the running f32 sum. These functions do the same arithmetic in
plain PyTorch so that tests can hold it, and a single TF32 pass as its
control, against the JAX package's f32 functions; ``chip_smoke.py`` uses
the single pass as a control on the card. No main path calls them.

C2's forward takes its f32 cd by 3xTF32 too and recomputes by f32 FMA in
channel order every entry within :func:`fixup_eps` of a clamp bound
(``csrc/corr_stream.cu:fixup_eps`` derives the margin):
:func:`cd_tf32x3_fixup` is that arithmetic, :func:`cd_fma` the FMA chain
emulated exactly, and :func:`near_bound_code` code rows whose cd lie many
within 1e-6 of the bounds 0 and 0.8, the inputs that hold the fix-up to
the FMA's masks.
"""

from __future__ import annotations

import numpy as np
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


def fixup_eps(cc: int) -> float:
    """The margin of C2's fix-up at ``cc`` code channels, (300 + 10 cc)
    2^-24 in f32 arithmetic, as ``csrc/corr_stream.cu:fixup_eps`` takes it:
    8x a bound on |3xTF32 cd - FMA cd| for code rows of norm <= 1."""
    return float(np.float32(300 + 10 * cc) * np.float32(5.9604645e-8))


def fma_f32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
            ) -> torch.Tensor:
    """fmaf(x, y, z) of f32 tensors, exactly: x y is exact in f64, x y + z
    is rounded once to f64 and its error kept (TwoSum), and the f64 sum is
    rounded to f32, unless it lies on the midpoint of two f32 values, where
    the error's sign picks the side (a double rounding would round to
    even)."""
    p = x.double() * y.double()
    zd = z.double()
    s = p + zd
    bb = s - p
    err = (p - (s - bb)) + (zd - bb)
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, -float("inf")))
    other = torch.nextafter(r, toward)
    mid = (d != 0) & (2 * d == other.double() - r.double())
    beyond = mid & (err != 0) & ((err > 0) == (d > 0))
    return torch.where(beyond, other, r)


def cd_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cd = a b^T of f32 rows (..., N, K) and (..., M, K) by f32 FMA in
    channel order from 0, as C2's fix-up (and the forward before it) takes it:
    v = fmaf(a_k, b_k, v) for k = 0 .. K - 1, emulated exactly."""
    a, b = a.float(), b.float()
    v = torch.zeros(a.shape[:-1] + b.shape[-2:-1], dtype=torch.float32,
                    device=a.device)
    for k in range(a.shape[-1]):
        v = fma_f32(a[..., :, None, k], b[..., None, :, k], v)
    return v


def cd_tf32x3_fixup(a: torch.Tensor, b: torch.Tensor, lo: float, hi: float,
                    eps: float | None = None) -> torch.Tensor:
    """C2's f32 cd of rows a (..., N, K) and b (..., M, K): by 3xTF32
    (:func:`matmul_tf32x3`), then every entry within ``eps`` (default
    :func:`fixup_eps` of K) of the clamp bound lo or hi replaced by f32 FMA
    in channel order (:func:`cd_fma`)."""
    a, b = a.float(), b.float()
    cd = matmul_tf32x3(a, b.transpose(-1, -2))
    eps = fixup_eps(a.shape[-1]) if eps is None else eps
    near = ((cd - lo).abs() < eps) | ((cd - hi).abs() < eps)
    where = near.nonzero(as_tuple=True)
    if where[0].numel():
        lead, i, j = where[:-2], where[-2], where[-1]
        rows = cd_fma(a[lead + (i,)][:, None], b[lead + (j,)][:, None])
        cd = cd.index_put(where, rows.reshape(-1))
    return cd


def near_bound_code(maps: int, n: int, cc: int, seed: int) -> torch.Tensor:
    """(maps, n, cc) f32 code rows of norm 1 (l2-normalised in f32 as
    ``prep`` does), cc >= 3, whose cd lie many within 1e-6 of 0 and of 0.8:
    row i is of kind i % 4 in an orthonormal basis (e0, X, Y) drawn from
    ``seed``: a unit vector in X; one in Y; p e0 + q x; r e0 + s y, with
    p r = 0.8 (1 +- 6e-7). X against Y, and either against the other
    subspace's e0 kind, give cd of f32 rounding's size around 0; the two
    e0 kinds give cd within ~1e-6 of 0.8."""
    if cc < 3:
        raise ValueError(f"near_bound_code needs cc >= 3, got {cc}")
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.standard_normal((cc, cc)))
    e0, xs, ys = basis[:, 0], basis[:, 1:1 + (cc - 1) // 2], \
        basis[:, 1 + (cc - 1) // 2:]

    def unit(sub, count):
        v = rng.standard_normal((count, sub.shape[1])) @ sub.T
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    total = maps * n
    kind = np.arange(total) % 4
    out = np.empty((total, cc))
    out[kind == 0] = unit(xs, int((kind == 0).sum()))
    out[kind == 1] = unit(ys, int((kind == 1).sum()))
    for k, sub, mag in ((2, xs, 0.9), (3, ys, 0.8 / 0.9)):
        count = int((kind == k).sum())
        p = mag * (1 + rng.uniform(-3e-7, 3e-7, count))
        out[kind == k] = (p[:, None] * e0
                          + np.sqrt(1 - p ** 2)[:, None] * unit(sub, count))
    code = torch.from_numpy(out.reshape(maps, n, cc)).float()
    return code / torch.sqrt((code * code).sum(-1, keepdim=True))
