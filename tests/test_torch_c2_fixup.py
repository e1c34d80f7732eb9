"""The arithmetic of kernel C2's f32 cd, on the CPU: 3xTF32 with every entry
within ``fixup_eps`` of a clamp bound recomputed by f32 FMA in channel order
(``stego_torch/ops/tf32.py:cd_tf32x3_fixup``, the plain version of
``csrc/corr_stream.cu``'s fix-up). Its clamp masks and clamped values equal
the FMA chain's bit for bit on inputs built to put many cd within 1e-6 of
the bounds; without the fix-up (eps = 0) they do not; the margin is 8x the
largest |3xTF32 cd - FMA cd| seen; and the losses it gives agree with the
JAX streamed kernel (interpret mode)."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from stego_tpu.ops.pallas_corr import \
    fused_correlation_loss_multi as jax_stream_multi
from stego_torch.ops import corr_stream
from stego_torch.ops import tf32

CODE_WIDTHS = [3, 16, 70, 128, 160, 300]
# zero_clamp (lo = 0), stabalize (hi = 0.8), and both
BOUNDS = [(0.0, float("inf")), (-9999.0, 0.8), (0.0, 0.8)]


def sides(cc, seed, n=24):
    """Side 1 and side 2 rows of near_bound_code: two maps of n rows."""
    code = tf32.near_bound_code(2, n, cc, seed)
    return code[0], code[1]


def mask_and_clamp(cd, lo, hi):
    return (cd >= lo) & (cd <= hi), torch.clamp(cd, lo, hi)


def f32_round(x: Fraction) -> float:
    """x rounded to the nearest f32, ties to even, by exact arithmetic."""
    r = np.float32(float(x))
    cands = {r, np.nextafter(r, np.float32(np.inf)),
             np.nextafter(r, np.float32(-np.inf))}
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.int32)) & 1))
    return float(best)


@pytest.mark.parametrize("lo,hi", BOUNDS)
@pytest.mark.parametrize("cc", CODE_WIDTHS)
def test_fixup_masks_equal_fma_masks_bit_for_bit(cc, lo, hi):
    """The masks of the fixed-up cd equal those of the FMA chain exactly,
    and so do cd and its clamped values within the margin of a bound (the
    entries the fix-up recomputes), on inputs
    with many cd within 1e-6 of 0 and 0.8; farther out cd moves by less
    than the margin."""
    a, b = sides(cc, seed=cc)
    exact = a.double() @ b.double().T
    near = ((exact - 0.0).abs() < 1e-6) | ((exact - 0.8).abs() < 1e-6)
    assert float(near.float().mean()) > 0.4
    want = tf32.cd_fma(a, b)
    got = tf32.cd_tf32x3_fixup(a, b, lo, hi)
    (got_mask, got_clamp), (want_mask, want_clamp) = (
        mask_and_clamp(got, lo, hi), mask_and_clamp(want, lo, hi))
    assert torch.equal(got_mask, want_mask)
    eps = tf32.fixup_eps(cc)
    cd3 = tf32.matmul_tf32x3(a, b.T)
    fixed = ((cd3 - lo).abs() < eps) | ((cd3 - hi).abs() < eps)
    assert int(fixed.sum()) > 0
    assert torch.equal(got[fixed], want[fixed])
    assert torch.equal(got_clamp[fixed], want_clamp[fixed])
    torch.testing.assert_close(got, want, rtol=0, atol=eps / 8)


@pytest.mark.parametrize("cc", CODE_WIDTHS)
def test_fixup_control_without_margin_fails(cc):
    """The control: with eps = 0 (3xTF32 alone) the masks at the zero bound
    differ from the FMA chain's on the same inputs."""
    a, b = sides(cc, seed=cc)
    want = mask_and_clamp(tf32.cd_fma(a, b), 0.0, float("inf"))[0]
    got = mask_and_clamp(tf32.cd_tf32x3_fixup(a, b, 0.0, float("inf"),
                                              eps=0.0), 0.0, float("inf"))[0]
    assert not torch.equal(got, want)


@settings(max_examples=40, deadline=None)
@given(cc=st.integers(3, 300), seed=st.integers(0, 2 ** 31 - 1),
       near=st.booleans())
def test_tf32x3_cd_within_an_eighth_of_the_margin(cc, seed, near):
    """|3xTF32 cd - FMA cd| < fixup_eps / 8 for l2-normalised rows, random
    or near the bounds."""
    if near:
        a, b = sides(cc, seed, n=8)
    else:
        rng = np.random.default_rng(seed)
        code = corr_stream.prep(torch.from_numpy(
            rng.standard_normal((2, 1, 8, cc)).astype(np.float32)))
        a, b = code[0], code[1]
    diff = (tf32.matmul_tf32x3(a, b.T) - tf32.cd_fma(a, b)).abs().max()
    assert float(diff) < tf32.fixup_eps(cc) / 8


def test_fma_emulation_rounds_once():
    """fma_f32 equals x y + z rounded once to f32 (exact rational
    arithmetic), on random values and on sums built to lie a hair off an
    f32 midpoint, where rounding first to f64 would round twice."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(200).astype(np.float32)
    y = rng.standard_normal(200).astype(np.float32)
    z = rng.standard_normal(200).astype(np.float32)
    # x y = +-2^-24 (1 - 2^-46), z of an odd last bit: x y + z lies 2^-70
    # inside the midpoint next to z, which an f64 sum rounds onto
    x[:2] = np.float32(2.0 ** -12 * (1 + 2.0 ** -23))
    x[1] = -x[1]
    y[:2] = np.float32(2.0 ** -12 * (1 - 2.0 ** -23))
    z[0] = np.float32(1 + 2.0 ** -23)
    z[1] = np.float32(1 + 3 * 2.0 ** -23)
    got = tf32.fma_f32(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(z)).numpy()
    want = [f32_round(Fraction(float(a)) * Fraction(float(b))
                      + Fraction(float(c))) for a, b, c in zip(x, y, z)]
    np.testing.assert_array_equal(got, np.array(want, dtype=np.float32))


@pytest.mark.parametrize("pointwise,zero_clamp,stabalize", [
    (True, True, False), (False, False, True)])
@pytest.mark.parametrize("cc", [16, 70])
def test_fixup_losses_match_jax(cc, pointwise, zero_clamp, stabalize):
    """The losses and cd means of the fixed-up cd (with fd in f32) against
    the JAX streamed kernel (interpret mode) on the same near-bound code
    maps, within C2's tolerances (rtol 1e-4, atol 1e-5)."""
    b, hw, cf = 2, 6, 32
    rng = np.random.default_rng(cc)
    feats = [rng.standard_normal((b, hw, hw, cf)).astype(np.float32)
             for _ in range(3)]
    codes = [c.reshape(b, hw, hw, cc).numpy() for c in
             tf32.near_bound_code(3, b * hw * hw, cc, seed=cc)]
    shifts = [0.18, 0.12, 0.46]
    pairs = [(feats[0], feats[k], codes[0], codes[k]) for k in range(3)]
    want = jax_stream_multi(
        [tuple(jnp.asarray(x) for x in p) for p in pairs], shifts,
        pointwise=pointwise, zero_clamp=zero_clamp, stabalize=stabalize,
        interpret=True)
    lo, hi = corr_stream.clamp_bounds(zero_clamp, stabalize)
    f = [corr_stream.prep(torch.from_numpy(x)) for x in feats]
    c = [corr_stream.prep(torch.from_numpy(x)) for x in codes]
    fd = torch.cat([torch.bmm(f[0], f[k].transpose(1, 2)) for k in range(3)])
    cd = torch.cat([tf32.cd_tf32x3_fixup(c[0], c[k], lo, hi)
                    for k in range(3)])
    cdc = torch.clamp(cd, lo, hi)
    losses, cd_means, _ = corr_stream.finalize_rows(
        (cdc * fd).sum(-1), cdc.sum(-1), fd.sum(-1), cd.sum(-1), shifts,
        [b] * 3, pointwise)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cd_means.numpy(), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scale,code_bf16,ok", [
    (1.0, False, True), (1 + 2 ** -18, False, False), (1.5, False, False),
    (1.5, True, True)])
def test_pre_prepped_code_rows_of_norm_above_one_raise(scale, code_bf16, ok):
    """The fix-up's margin holds for code rows of norm <= 1, which prep
    gives; fused_correlation_loss_multi(pre_prepped=True) hands the
    caller's rows to the kernel, so with f32 code (whose cd the fix-up
    corrects) it raises for a row of norm above 1 + 2^-20 and takes
    l2-normalised rows; code_bf16's cd has no fix-up."""
    rng = np.random.default_rng(5)
    f, c = (corr_stream.prep(torch.from_numpy(
        rng.standard_normal((2, 4, 4, ch)).astype(np.float32)))
        for ch in (16, 8))
    c = c.clone()
    c[1, 3] *= scale
    pairs = [(f, f, c, c)]
    if ok:
        losses, _ = corr_stream.fused_correlation_loss_multi(
            pairs, [0.1], pre_prepped=True, code_bf16=code_bf16)
        assert bool(torch.isfinite(losses).all())
    else:
        with pytest.raises(ValueError, match="norm <= 1"):
            corr_stream.fused_correlation_loss_multi(pairs, [0.1],
                                                     pre_prepped=True)
