"""stego_torch's correlation loss against the JAX package: the plain
versions of kernels C1 and C2 against the JAX fused-sampling and streamed
kernels (interpret mode), the loss's front end in its fused, full-field and
grid-sampled forms, the einsum oracle, the sampler and the closed-form
finalize, on the same seeded inputs and the same coordinate and permutation
draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.ops import math as jax_math
from stego_tpu.ops.correlation import CorrLossCfg as JaxCorrLossCfg
from stego_tpu.ops.correlation import \
    contrastive_correlation_loss as jax_corr_loss
from stego_tpu.ops.pallas_corr import _finalize as jax_finalize
from stego_tpu.ops.pallas_corr import _Static
from stego_tpu.ops.pallas_corr import \
    contrastive_correlation_loss_fused as jax_corr_loss_fused
from stego_tpu.ops.pallas_corr import \
    fused_correlation_loss_multi as jax_stream_multi
from stego_tpu.ops.pallas_corr_fused_sampling import \
    sampled_corr_fused as jax_sampled_corr_fused
from stego_tpu.ops.sampling import \
    bilinear_sample_weights as jax_bilinear_sample_weights
from stego_tpu.ops.sampling import sample_from_coords as jax_sample
from stego_torch.ops import corr_stream
from stego_torch.ops.corr_fused_sampling import (sampled_corr_fused,
                                                 sampled_corr_plain)
from stego_torch.ops.correlation import CorrLossCfg, \
    contrastive_correlation_loss
from stego_torch.ops.math import (block_local_super_perm, one_hot_feats,
                                  super_perm, tensor_correlation)
from stego_torch.ops.sampling import (bilinear_sample_weights,
                                      sample_from_coords)

# losses and cd means; code gradients (PARITY_r05.json, sampled-loss rows)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
# the streamed loss C2 (PARITY_r05.json, corr rows)
STREAM_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
B, HW, CF, CC = 4, 8, 32, 16


def maps(seed, b=B, hw=HW, cf=CF, cc=CC):
    """Seeded (feats, feats_pos, code, code_pos) NHWC f32 arrays."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, hw, hw, c)).astype(np.float32)
                 for c in (cf, cf, cc, cc))


def coords(seed, b=B, s1=2, s2=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (b, s1, s2, 2)).astype(np.float32)
                 for _ in range(2))


def loss_draws(key, b, s, neg):
    """The JAX loss's draws from its key (``split(key, 3)``: coordinates,
    then one block_local_super_perm per ``split(k_neg, neg)``), as numpy."""
    k_c1, k_c2, k_neg = jax.random.split(key, 3)
    c1, c2 = (np.asarray(jax.random.uniform(k, (b, s, s, 2), jnp.float32,
                                            -1.0, 1.0)) for k in (k_c1, k_c2))
    perms = ([np.asarray(jax_math.block_local_super_perm(b, nk, 1))
              for nk in jax.random.split(k_neg, neg)] if neg else [])
    return c1, c2, perms


def t(x):
    return torch.from_numpy(np.array(x))


def weights(g, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(g).astype(np.float32), \
        rng.standard_normal(g).astype(np.float32)


def jax_sampled(arrs, cs, perms, shifts, fdt, **kw):
    """JAX sampled_corr_fused in interpret mode: (losses, cds, code grads)
    of the seeded combination of its outputs."""
    wl, wc = weights(len(shifts))
    f1, f2, c1, c2 = arrs

    def fn(c1, c2):
        losses, cds = jax_sampled_corr_fused(
            jnp.asarray(f1), jnp.asarray(f2), c1, c2, jnp.asarray(cs[0]),
            jnp.asarray(cs[1]), [jnp.asarray(p) for p in perms], shifts,
            feat_dtype=fdt, interpret=True, **kw)
        return jnp.sum(losses * wl) + jnp.sum(cds * wc), (losses, cds)

    (_, (losses, cds)), grads = jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True)(jnp.asarray(c1), jnp.asarray(c2))
    return np.asarray(losses), np.asarray(cds), [np.asarray(g) for g in grads]


def port_sampled(fn, arrs, cs, perms, shifts, fdt, **kw):
    wl, wc = weights(len(shifts))
    f1, f2, c1, c2 = (t(a) for a in arrs)
    c1.requires_grad_(True)
    c2.requires_grad_(True)
    losses, cds = fn(f1, f2, c1, c2, t(cs[0]), t(cs[1]),
                     [t(p) for p in perms], shifts, feat_dtype=fdt, **kw)
    total = (losses * t(wl)).sum() + (cds * t(wc)).sum()
    grads = torch.autograd.grad(total, [c1, c2])
    return (losses.detach().numpy(), cds.detach().numpy(),
            [g.numpy() for g in grads])


@pytest.mark.parametrize("fdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pointwise,zero_clamp,stabalize", [
    (True, True, False), (False, False, True), (True, False, True),
    (False, True, False)])
def test_sampled_corr_plain_matches_jax_kernel(fdt, pointwise, zero_clamp,
                                               stabalize):
    """C1's plain version against the JAX fused-sampling kernel (interpret
    mode), forward and code gradients, 2 negatives, 2 x 3 coordinates."""
    arrs = maps(0)
    cs = coords(1, s1=2, s2=3)
    perms = [np.array([1, 2, 3, 0]), np.array([3, 0, 1, 2])]
    shifts = [0.18, 0.12, 0.46, 0.46]
    opts = dict(pointwise=pointwise, zero_clamp=zero_clamp,
                stabalize=stabalize)
    want = jax_sampled(arrs, cs, perms, shifts, getattr(jnp, fdt), **opts)
    got = port_sampled(sampled_corr_plain, arrs, cs, perms, shifts,
                       getattr(torch, fdt), **opts)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **LOSS_TOL)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_sampled_corr_plain_matches_jax_kernel_without_negatives():
    arrs = maps(2, b=3)
    cs = coords(3, b=3, s1=3, s2=3)
    want = jax_sampled(arrs, cs, [], [0.18, 0.12], jnp.float32)
    got = port_sampled(sampled_corr_plain, arrs, cs, [], [0.18, 0.12],
                       torch.float32)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **LOSS_TOL)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_sampled_corr_fused_takes_plain_version_on_cpu():
    """On CPU tensors the dispatching wrapper is the plain version, and
    feature maps get no gradient."""
    arrs = maps(4)
    cs = coords(5)
    perms = [np.array([1, 0, 3, 2])]
    shifts = [0.1, 0.2, 0.3]
    a = port_sampled(sampled_corr_fused, arrs, cs, perms, shifts,
                     torch.float32)
    b = port_sampled(sampled_corr_plain, arrs, cs, perms, shifts,
                     torch.float32)
    for x, y in zip(a[:2] + tuple(a[2]), b[:2] + tuple(b[2])):
        np.testing.assert_array_equal(x, y)
    f1 = t(arrs[0]).requires_grad_(True)
    losses, _ = sampled_corr_fused(f1, t(arrs[1]), t(arrs[2]), t(arrs[3]),
                                   t(cs[0]), t(cs[1]), [t(perms[0])], shifts)
    assert not losses.requires_grad


def test_sampled_corr_rejects_one_image_batch():
    arrs = maps(0, b=1)
    cs = coords(1, b=1)
    with pytest.raises(ValueError, match="1-image batch"):
        sampled_corr_fused(*(t(a) for a in arrs), t(cs[0]), t(cs[1]),
                           [torch.zeros(1, dtype=torch.long)],
                           [0.1, 0.2, 0.3])


@pytest.mark.parametrize("neg", [0, 2])
@pytest.mark.parametrize("pointwise,stabalize", [(True, False),
                                                 (False, True)])
def test_einsum_oracle_matches_jax(neg, pointwise, stabalize):
    """contrastive_correlation_loss with the JAX draws injected: losses, cd
    tensors and code gradients."""
    arrs = maps(6, cf=CF, cc=CC)
    jcfg = JaxCorrLossCfg(feature_samples=2, neg_samples=neg,
                          pointwise=pointwise, stabalize=stabalize)
    cfg = CorrLossCfg(feature_samples=2, neg_samples=neg,
                      pointwise=pointwise, stabalize=stabalize)
    key = jax.random.PRNGKey(11)
    c1d, c2d, perms = loss_draws(key, B, 2, neg)

    def jfn(c1, c2):
        out = jax_corr_loss(jcfg, key, jnp.asarray(arrs[0]),
                            jnp.asarray(arrs[1]), c1, c2,
                            sampling_impl="gather")
        total = (out["pos_intra_loss"] + 2 * out["pos_inter_loss"]
                 + 3 * jnp.mean(out["neg_inter_loss"]))
        return total, out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(arrs[2]), jnp.asarray(arrs[3]))
    c1 = t(arrs[2]).requires_grad_(True)
    c2 = t(arrs[3]).requires_grad_(True)
    out = contrastive_correlation_loss(cfg, t(arrs[0]), t(arrs[1]), c1, c2,
                                       t(c1d), t(c2d), [t(p) for p in perms])
    total = (out["pos_intra_loss"] + 2 * out["pos_inter_loss"]
             + 3 * out["neg_inter_loss"].mean())
    grads = torch.autograd.grad(total, [c1, c2])
    for k in jout:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), **LOSS_TOL,
                                   err_msg=k)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("return_cd_tensors", [False, True])
def test_fused_loss_front_end_matches_jax(return_cd_tensors):
    """corr_stream.contrastive_correlation_loss_fused against the JAX
    fused front end (sampling_impl="fused", interpret mode): the output
    dict, including the hist cd tensors."""
    arrs = maps(7)
    jcfg = JaxCorrLossCfg(feature_samples=2, neg_samples=2)
    cfg = CorrLossCfg(feature_samples=2, neg_samples=2)
    key = jax.random.PRNGKey(5)
    c1d, c2d, perms = loss_draws(key, B, 2, 2)
    jout = jax_corr_loss_fused(jcfg, key, *(jnp.asarray(a) for a in arrs),
                               interpret=True,
                               return_cd_tensors=return_cd_tensors,
                               sampling_impl="fused")
    out = corr_stream.contrastive_correlation_loss_fused(
        cfg, *(t(a) for a in arrs), t(c1d), t(c2d), [t(p) for p in perms],
        return_cd_tensors=return_cd_tensors)
    assert out.keys() == jout.keys()
    for k in jout:
        assert tuple(out[k].shape) == tuple(jout[k].shape), k
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), **LOSS_TOL,
                                   err_msg=k)


def stream_pairs(seed, b=2, hw=8, cf=CF, cc=CC, neg=2):
    """Seeded NHWC maps of the three pair types, as the loss hands them to
    C2: (feats, feats, code, code), (feats, feats_pos, code, code_pos) and
    one (feats, feats_neg_k, code, code_neg_k) a negative. Returns the
    distinct maps, ``[feats, feats_pos, feats_neg_0, ...]`` and the same
    for the code, as numpy."""
    rng = np.random.default_rng(seed)
    fs = [rng.standard_normal((b, hw, hw, cf)).astype(np.float32)
          for _ in range(2 + neg)]
    cs = [rng.standard_normal((b, hw, hw, cc)).astype(np.float32)
          for _ in range(2 + neg)]
    return fs, cs


def pair_list(fs, cs):
    return [(fs[0], fs[k], cs[0], cs[k]) for k in range(len(fs))]


def jax_stream(fs, cs, shifts, **kw):
    """JAX fused_correlation_loss_multi in interpret mode: (losses, cds,
    gradients of a seeded combination of them in every code map)."""
    wl, wc = weights(len(shifts))
    n_groups = len(shifts)

    def fn(cs):
        losses, cds = jax_stream_multi(
            pair_list([jnp.asarray(f) for f in fs], cs), shifts,
            interpret=True, **kw)
        return (jnp.sum(losses * wl[:n_groups])
                + jnp.sum(cds * wc[:n_groups])), (losses, cds)

    (_, (losses, cds)), grads = jax.value_and_grad(fn, has_aux=True)(
        [jnp.asarray(c) for c in cs])
    return np.asarray(losses), np.asarray(cds), [np.asarray(g) for g in grads]


def port_stream(fs, cs, shifts, **kw):
    wl, wc = weights(len(shifts))
    c = [t(x).requires_grad_(True) for x in cs]
    losses, cds = corr_stream.fused_correlation_loss_multi(
        pair_list([t(f) for f in fs], c), shifts, **kw)
    total = (losses * t(wl)).sum() + (cds * t(wc)).sum()
    grads = torch.autograd.grad(total, c)
    return (losses.detach().numpy(), cds.detach().numpy(),
            [g.numpy() for g in grads])


def assert_stream_close(got, want):
    np.testing.assert_allclose(got[0], want[0], **STREAM_LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **STREAM_LOSS_TOL)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("fdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pointwise,zero_clamp,stabalize", [
    (True, True, False), (False, False, True), (True, False, True),
    (False, True, False)])
def test_stream_plain_matches_jax_kernel(fdt, pointwise, zero_clamp,
                                         stabalize):
    """C2's plain version against the JAX streamed kernel (interpret mode):
    losses and cd means within rtol 1e-4, atol 1e-5, code gradients within
    rtol 2e-4, atol 1e-5 (PARITY_r05's corr rows), 8 x 8 maps, two
    negatives."""
    fs, cs = stream_pairs(11)
    shifts = [0.18, 0.12, 0.46, 0.46]
    opts = dict(pointwise=pointwise, zero_clamp=zero_clamp,
                stabalize=stabalize)
    want = jax_stream(fs, cs, shifts, feat_dtype=getattr(jnp, fdt), **opts)
    got = port_stream(fs, cs, shifts, feat_dtype=getattr(torch, fdt), **opts)
    assert_stream_close(got, want)


@pytest.mark.parametrize("hw,opts", [
    (11, dict(pointwise=True, zero_clamp=True)),
    (8, dict(pointwise=False, stabalize=True)),
])
def test_stream_plain_code_bf16_matches_jax_kernel(hw, opts):
    """code_bf16 (pallas_loss_bf16): cd from bf16-rounded code and the
    backward's dL/dcd rounded to bf16, in both; the same tolerances as f32
    (both sides round at the same points, so only the f32 sums' order
    differs)."""
    fs, cs = stream_pairs(12, hw=hw)
    shifts = [0.18, 0.12, 0.46, 0.46]
    want = jax_stream(fs, cs, shifts, feat_dtype=jnp.bfloat16,
                      code_bf16=True, **opts)
    got = port_stream(fs, cs, shifts, feat_dtype=torch.bfloat16,
                      code_bf16=True, **opts)
    assert_stream_close(got, want)


@pytest.mark.parametrize("hw,neg,split", [(11, 2, 1), (8, 1, 2), (11, 0, 1)])
def test_stream_plain_ragged_split_and_no_negatives_match_jax(hw, neg,
                                                              split):
    """11 x 11 maps (121 rows: ragged against the TPU's 128-row tiles and
    the card's 64-row ones), split_groups=2 (one pointwise mean per half
    batch) and no negatives."""
    fs, cs = stream_pairs(13, b=4, hw=hw, neg=neg)
    shifts = [0.18, 0.12] + [0.46] * neg
    want = jax_stream(fs, cs, shifts, split_groups=split)
    got = port_stream(fs, cs, shifts, split_groups=split)
    assert_stream_close(got, want)


def test_stream_multi_dedupes_shared_maps_and_detaches_features():
    """A map two pairs share is normalized once (4 distinct maps for 4 pair
    types here), the losses equal the plain version on stacked copies, and
    the feature maps get no gradient."""
    fs, cs = stream_pairs(14)
    tf, tc = [t(f) for f in fs], [t(c) for c in cs]
    shifts = [0.18, 0.12, 0.46, 0.46]
    losses, cds = corr_stream.fused_correlation_loss_multi(
        pair_list(tf, tc), shifts)
    prep = corr_stream.prep
    stacked = corr_stream.fused_correlation_loss_plain(
        torch.cat([prep(tf[0])] * 4), torch.cat([prep(f) for f in tf]),
        torch.cat([prep(tc[0])] * 4), torch.cat([prep(c) for c in tc]),
        shifts, [2] * 4)
    torch.testing.assert_close(losses, stacked[0], rtol=0, atol=0)
    torch.testing.assert_close(cds, stacked[1], rtol=0, atol=0)
    tf[1].requires_grad_(True)
    losses, _ = corr_stream.fused_correlation_loss_multi(pair_list(tf, tc),
                                                         shifts)
    assert not losses.requires_grad


@pytest.mark.parametrize("n_real", [None, 121])
def test_stream_multi_takes_pre_prepped_rows(n_real):
    """pre_prepped (the JAX signature's option): normalized (B, N, C) rows
    give the losses and code gradients of the NHWC maps they come from;
    n_real, where given, is N."""
    fs, cs = stream_pairs(18, hw=11)
    shifts = [0.18, 0.12, 0.46, 0.46]
    want = port_stream(fs, cs, shifts, feat_dtype=torch.bfloat16)
    wl, wc = weights(len(shifts))
    c = [t(x).requires_grad_(True) for x in cs]
    prepped = pair_list([corr_stream.prep(t(f), torch.bfloat16) for f in fs],
                        [corr_stream.prep(x) for x in c])
    losses, cds = corr_stream.fused_correlation_loss_multi(
        prepped, shifts, pre_prepped=True, n_real=n_real)
    total = (losses * t(wl)).sum() + (cds * t(wc)).sum()
    grads = torch.autograd.grad(total, c)
    np.testing.assert_array_equal(losses.detach().numpy(), want[0])
    np.testing.assert_array_equal(cds.detach().numpy(), want[1])
    for g, w in zip(grads, want[2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-9)


def test_stream_multi_rejects_padded_n_real():
    fs, cs = stream_pairs(18, hw=4)
    prepped = pair_list([corr_stream.prep(t(f)) for f in fs],
                        [corr_stream.prep(t(x)) for x in cs])
    with pytest.raises(ValueError, match="pads nothing"):
        corr_stream.fused_correlation_loss_multi(
            prepped, [0.18, 0.12, 0.46, 0.46], pre_prepped=True, n_real=128)


@pytest.mark.parametrize("hw", [8, 11])
def test_stream_plain_code_bf16_backward_rounds_coefficients(hw):
    """code_bf16's backward rounds dL/dcd to bf16: against the same loss on
    bf16-rounded code without code_bf16 (the same forward bit for bit, an
    unrounded dL/dcd), the code gradients differ in most elements by more
    than the f32 tolerance (rtol 2e-4, atol 1e-5 at weights that make the
    largest gradient 1). That is what makes the card's code_bf16 gate (at
    least 99% of elements within that tolerance) tell a kernel that skips
    the rounding from one that keeps it."""
    fs, cs = stream_pairs(19, b=4, hw=hw)
    shifts = [0.18, 0.12, 0.46, 0.46]
    tf = [corr_stream.prep(t(f), torch.bfloat16) for f in fs]
    # halved, so that the pre_prepped rows have norm <= 1 (bf16 rounding
    # can lift a unit row's norm above 1) and stay bf16 values
    rounded = [corr_stream.prep(t(x)).bfloat16().float() / 2 for x in cs]

    def run(code, code_bf16, scale=1.0):
        c = [x.clone().requires_grad_(True) for x in code]
        losses, cds = corr_stream.fused_correlation_loss_multi(
            pair_list(tf, c), shifts, pre_prepped=True, code_bf16=code_bf16)
        wl, wc = weights(len(shifts))
        total = ((losses * t(wl)).sum() + (cds * t(wc)).sum()) * scale
        return losses, cds, torch.cat([g.flatten() for g in
                                       torch.autograd.grad(total, c)])

    scale = 1 / float(run(rounded, True)[2].abs().max())
    got, want = run(rounded, False, scale), run(rounded, True, scale)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    diff = (got[2] - want[2]).abs()
    inside = float((diff <= 1e-5 + 2e-4 * want[2].abs()).float().mean())
    assert inside < 0.5
    assert float(diff.max()) <= 2 ** -7


def test_finalize_rows_takes_unequal_groups():
    rng = np.random.default_rng(15)
    sums = [t(rng.standard_normal((5, 3)).astype(np.float32))
            for _ in range(4)]
    losses, cds, gm = corr_stream.finalize_rows(*sums, [0.1, 0.2],
                                                [2, 3], True)
    for g, (a, z) in enumerate(((0, 2), (2, 5))):
        want = corr_stream.finalize(*(s[None, a:z] for s in sums),
                                    [0.1 * (g + 1)], True)
        for x, w in zip((losses, cds, gm), want):
            torch.testing.assert_close(x[g], w[0])
    with pytest.raises(ValueError, match="rows"):
        corr_stream.finalize_rows(*sums, [0.1], [2, 3], True)


@pytest.mark.parametrize("mode", ["full_field", "gather", "gather_hist",
                                  "gather_bf16", "full_field_bf16"])
def test_streamed_front_end_matches_jax(mode):
    """contrastive_correlation_loss_fused's C2 branches (full-field and
    grid-sampled, sampling_impl="gather") against the JAX front end in
    interpret mode, with its coordinate and permutation draws injected: the
    output dict (the hist variant's cd tensors included) and the code
    gradients of a seeded combination of the losses."""
    arrs = maps(16, b=3, hw=6)
    full = mode.startswith("full_field")
    hist = mode == "gather_hist"
    bf16 = mode.endswith("bf16")
    jcfg = JaxCorrLossCfg(feature_samples=3, neg_samples=2)
    cfg = CorrLossCfg(feature_samples=3, neg_samples=2)
    key = jax.random.PRNGKey(17)
    c1d, c2d, perms = loss_draws(key, 3, 3, 2)
    kw = dict(full_field=full, return_cd_tensors=hist, code_bf16=bf16)
    fdt = "bfloat16" if bf16 else "float32"

    def total(out):
        return (out["pos_intra_loss"] + 2 * out["pos_inter_loss"]
                + 3 * out["neg_inter_loss"] + (0 if hist else
                                               out["pos_inter_cd"]))

    def jfn(c1, c2):
        out = jax_corr_loss_fused(jcfg, key, jnp.asarray(arrs[0]),
                                  jnp.asarray(arrs[1]), c1, c2,
                                  interpret=True, sampling_impl="gather",
                                  feat_dtype=getattr(jnp, fdt), **kw)
        return total(out), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(arrs[2]), jnp.asarray(arrs[3]))
    c1 = t(arrs[2]).requires_grad_(True)
    c2 = t(arrs[3]).requires_grad_(True)
    out = corr_stream.contrastive_correlation_loss_fused(
        cfg, t(arrs[0]), t(arrs[1]), c1, c2, t(c1d), t(c2d),
        [t(p) for p in perms], sampling_impl="gather",
        feat_dtype=getattr(torch, fdt), **kw)
    grads = torch.autograd.grad(total(out), [c1, c2])
    assert out.keys() == jout.keys()
    for k in jout:
        assert tuple(out[k].shape) == tuple(jout[k].shape), k
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), **STREAM_LOSS_TOL,
                                   err_msg=k)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("pointwise", [True, False])
def test_finalize_matches_jax(pointwise):
    """The closed form from row sums, 4 groups of 3 pairs of 5 samples."""
    rng = np.random.default_rng(8)
    g, b, n = 4, 3, 5
    sums = [rng.standard_normal((g, b, n)).astype(np.float32)
            for _ in range(4)]
    shifts = (0.18, 0.12, 0.46, 0.46)
    st = _Static(shifts=shifts, group_sizes=(b,) * g, pointwise=pointwise,
                 zero_clamp=True, stabalize=False, n_real=n, interpret=True)
    jl, jc, _, jgm = jax_finalize(*(jnp.asarray(s.reshape(g * b, n))
                                    for s in sums), st)
    losses, cds, gm = corr_stream.finalize(*(t(s) for s in sums), shifts,
                                           pointwise)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), **LOSS_TOL)
    np.testing.assert_allclose(cds.numpy(), np.asarray(jc), **LOSS_TOL)
    np.testing.assert_allclose(gm.numpy(), np.asarray(jgm)[::b], **LOSS_TOL)


def test_clamp_bounds():
    assert corr_stream.clamp_bounds(True, False) == (0.0, float("inf"))
    assert corr_stream.clamp_bounds(False, True) == (-9999.0, 0.8)


@pytest.mark.parametrize("hw,grid_hw", [((8, 8), (3, 4)), ((5, 7), (2, 2))])
def test_sampling_matches_jax(hw, grid_hw):
    """sample_from_coords (F.grid_sample, transposed grid) and the weight
    matrix against the JAX package, with points on the border clamp."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2,) + hw + (6,)).astype(np.float32)
    c = rng.uniform(-1.2, 1.2, (2,) + grid_hw + (2,)).astype(np.float32)
    c[0, 0, 0] = [1.0, 1.0]
    c[1, 0, 0] = [-1.0, 1.0]
    np.testing.assert_allclose(
        sample_from_coords(t(x), t(c)).numpy(),
        np.asarray(jax_sample(jnp.asarray(x), jnp.asarray(c),
                              impl="gather")), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        bilinear_sample_weights(hw, t(c)).numpy(),
        np.asarray(jax_bilinear_sample_weights(hw, jnp.asarray(c))))


def test_tensor_correlation_and_one_hot_match_jax():
    rng = np.random.default_rng(10)
    a = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    b = rng.standard_normal((2, 2, 3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tensor_correlation(t(a), t(b)).numpy(),
        np.asarray(jax_math.tensor_correlation(jnp.asarray(a),
                                               jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)
    labels = rng.integers(-1, 7, (2, 3, 4))
    np.testing.assert_array_equal(
        one_hot_feats(t(labels), 5).numpy(),
        np.asarray(jax_math.one_hot_feats(jnp.asarray(labels), 5)))


@pytest.mark.parametrize("size", [2, 3, 16])
def test_super_perm_is_a_near_derangement(size):
    """A permutation with its fixed points bumped by one (mod size), as the
    reference's: no image is its own negative (a bump can make two images
    share one), and the values stay in range."""
    g = torch.Generator().manual_seed(size)
    for _ in range(20):
        p = super_perm(size, g)
        assert p.dtype == torch.long and p.shape == (size,)
        assert int(p.min()) >= 0 and int(p.max()) < size
        assert not bool((p == torch.arange(size)).any())


def test_block_local_super_perm_blocks_and_guard():
    g = torch.Generator().manual_seed(0)
    p = block_local_super_perm(8, g, n_blocks=4)
    assert (p // 2 == torch.arange(8) // 2).all()
    with pytest.raises(ValueError, match=">=2 images per shard"):
        block_local_super_perm(4, g, n_blocks=4)
    with pytest.raises(ValueError, match="not divisible"):
        block_local_super_perm(6, g, n_blocks=4)


@pytest.mark.parametrize("fdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pointwise,zero_clamp,stabalize", [
    (True, True, False), (False, False, True)])
def test_sampled_corr_plain_matches_jax_kernel_vit_base_channels(
        fdt, pointwise, zero_clamp, stabalize):
    """C1's plain version at ViT-B's 768 feature channels (small 6 x 6
    maps, 3 x 3 samples) against the JAX kernel, which pads them to a
    multiple of 128 (pallas_corr_fused_sampling.py:436): the losses' and
    gradients' tolerances above."""
    arrs = maps(20, hw=6, cf=768)
    cs = coords(21, s1=3, s2=3)
    perms = [np.array([1, 2, 3, 0])]
    shifts = [0.18, 0.12, 0.46]
    opts = dict(pointwise=pointwise, zero_clamp=zero_clamp,
                stabalize=stabalize)
    want = jax_sampled(arrs, cs, perms, shifts, getattr(jnp, fdt), **opts)
    got = port_sampled(sampled_corr_plain, arrs, cs, perms, shifts,
                       getattr(torch, fdt), **opts)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **LOSS_TOL)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("fdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pointwise,zero_clamp,stabalize", [
    (True, True, False), (False, False, True)])
def test_stream_plain_matches_jax_kernel_vit_base_channels(
        fdt, pointwise, zero_clamp, stabalize):
    """C2's plain version at ViT-B's 768 feature channels (6 x 6 maps, one
    negative) against the JAX kernel, which takes cf whole
    (pallas_corr.py:138-148): the streamed loss's tolerances above."""
    fs, cs = stream_pairs(22, hw=6, cf=768, neg=1)
    shifts = [0.18, 0.12, 0.46]
    opts = dict(pointwise=pointwise, zero_clamp=zero_clamp,
                stabalize=stabalize)
    want = jax_stream(fs, cs, shifts, feat_dtype=getattr(jnp, fdt), **opts)
    got = port_stream(fs, cs, shifts, feat_dtype=getattr(torch, fdt), **opts)
    assert_stream_close(got, want)


@pytest.mark.parametrize("fdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pointwise,zero_clamp,stabalize", [
    (True, True, False), (False, False, True)])
def test_sampled_corr_plain_matches_jax_kernel_wide_code_many_samples(
        fdt, pointwise, zero_clamp, stabalize):
    """C1's plain version at 100 code channels and 12 x 12 = 144 samples
    (``dim=100, feature_samples=12``: on the card the kernel takes the code
    in two chunks and the samples in two tiles a side) against the JAX
    kernel, which pads both to multiples of 128
    (pallas_corr_fused_sampling.py:434-437), on 2 images of 8 x 8: the
    losses' and gradients' tolerances above."""
    arrs = maps(30, b=2, cc=100)
    cs = coords(31, b=2, s1=12, s2=12)
    perms = [np.array([1, 0])]
    shifts = [0.18, 0.12, 0.46]
    opts = dict(pointwise=pointwise, zero_clamp=zero_clamp,
                stabalize=stabalize)
    want = jax_sampled(arrs, cs, perms, shifts, getattr(jnp, fdt), **opts)
    got = port_sampled(sampled_corr_plain, arrs, cs, perms, shifts,
                       getattr(torch, fdt), **opts)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **LOSS_TOL)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("fdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pointwise,zero_clamp,stabalize", [
    (True, True, False), (False, False, True)])
def test_stream_plain_matches_jax_kernel_wide_code(fdt, pointwise,
                                                   zero_clamp, stabalize):
    """C2's plain version at 160 code channels (``dim=160``: on the card
    the kernel takes them in chunks of 128) against the JAX kernel, which
    pads every channel axis to 128 (pallas_corr.py:356-361), 8 x 8 maps,
    one negative: the streamed loss's tolerances above."""
    fs, cs = stream_pairs(32, cc=160, neg=1)
    shifts = [0.18, 0.12, 0.46]
    opts = dict(pointwise=pointwise, zero_clamp=zero_clamp,
                stabalize=stabalize)
    want = jax_stream(fs, cs, shifts, feat_dtype=getattr(jnp, fdt), **opts)
    got = port_stream(fs, cs, shifts, feat_dtype=getattr(torch, fdt), **opts)
    assert_stream_close(got, want)


def plain_forward(feats, code, idx1, idx2, lo, hi, code_bf16):
    """Kernel C2's forward by its plain arithmetic, with what it keeps for
    the backward: the row sums (R, 4, N), fd (R, N, N) f32 and the clamp
    mask (R, N, N) bool; a pair row with an out-of-range map index gets NaN
    row sums (its fd and mask are not read)."""
    m = code.shape[0]
    bad = (idx1 < 0) | (idx1 >= m) | (idx2 < 0) | (idx2 >= m)
    i1, i2 = idx1.clamp(0, m - 1), idx2.clamp(0, m - 1)
    fd = torch.bmm(feats[i1].float(), feats[i2].float().transpose(1, 2))
    c = code.bfloat16().float() if code_bf16 else code
    cd = torch.bmm(c[i1], c[i2].transpose(1, 2))
    cdc = torch.clamp(cd, lo, hi)
    acc = torch.stack([(cdc * fd).sum(-1), cdc.sum(-1), fd.sum(-1),
                       cd.sum(-1)], dim=1)
    acc[bad] = float("nan")
    return acc, fd, (cd >= lo) & (cd <= hi)


@pytest.mark.parametrize("fdt,hw,cc,opts,bad_row", [
    ("float32", 8, CC, dict(pointwise=True, zero_clamp=True), False),
    ("bfloat16", 8, CC, dict(pointwise=False, zero_clamp=False,
                             stabalize=True), False),
    ("bfloat16", 11, CC, dict(pointwise=True, zero_clamp=True), False),
    ("bfloat16", 8, CC, dict(pointwise=True, zero_clamp=True,
                             code_bf16=True), False),
    ("float32", 11, CC, dict(pointwise=False, zero_clamp=True,
                             code_bf16=True), False),
    ("float32", 8, 160, dict(pointwise=True, zero_clamp=True), False),
    ("bfloat16", 11, 160, dict(pointwise=False, stabalize=True), False),
    ("float32", 8, CC, dict(pointwise=True, zero_clamp=True), True),
    ("bfloat16", 11, CC, dict(pointwise=False, zero_clamp=False), True),
])
def test_stream_backward_plain_matches_jax_kernel(fdt, hw, cc, opts,
                                                  bad_row):
    """C2's backward as the card runs it, on the forward's fd and clamp
    mask (corr_stream.stream_backward_plain), against the JAX streamed
    kernel's gradient (interpret mode) and the autograd gradient of C2's
    plain version (fused_correlation_loss_plain), both within rtol 2e-4,
    atol 1e-5 (PARITY_r05's corr rows): bf16 and f32 features, pointwise
    on and off, both clamps, code_bf16, ragged n (121), 160 code channels
    (two of the kernel's chunks) and a pair row with an out-of-range map
    index in a group of its own, which adds nothing."""
    fs, cs = stream_pairs(40 + hw + cc, hw=hw, cc=cc)
    shifts = [0.18, 0.12, 0.46, 0.46]
    code_bf16 = opts.get("code_bf16", False)
    want = jax_stream(fs, cs, shifts, feat_dtype=getattr(jnp, fdt), **opts)
    autograd = port_stream(fs, cs, shifts, feat_dtype=getattr(torch, fdt),
                           **opts)
    wl, wc = weights(len(shifts))
    c = [t(x).requires_grad_(True) for x in cs]
    feats = torch.cat([corr_stream.prep(t(f), getattr(torch, fdt))
                       for f in fs])
    code = torch.cat([corr_stream.prep(x) for x in c])
    b, m = fs[0].shape[0], code.shape[0]
    ar = torch.arange(b)
    idx1 = ar.repeat(len(fs))
    idx2 = torch.cat([ar + k * b for k in range(len(fs))])
    groups, g_losses, g_cdms = [b] * len(fs), list(wl), list(wc)
    if bad_row:
        idx1, idx2 = torch.cat([idx1, t([0])]), torch.cat([idx2, t([m])])
        groups, shifts = groups + [1], shifts + [0.3]
        g_losses, g_cdms = g_losses + [1.0], g_cdms + [1.0]
    n = code.shape[1]
    lo, hi = corr_stream.clamp_bounds(opts.get("zero_clamp", True),
                                      opts.get("stabalize", False))
    acc, fd, mask = plain_forward(feats, code.detach(), idx1, idx2, lo, hi,
                                  code_bf16)
    losses, _, gm = corr_stream.finalize_rows(
        acc[:, 0], acc[:, 1], acc[:, 2], acc[:, 3], shifts, groups,
        opts.get("pointwise", True))
    np.testing.assert_allclose(losses[:len(fs)].numpy(), want[0],
                               **STREAM_LOSS_TOL)
    scal = corr_stream.backward_scalars(
        t(np.float32(g_losses)), t(np.float32(g_cdms)), gm, shifts, groups,
        n)[corr_stream.row_groups(groups, "cpu").long()]
    dcode = corr_stream.stream_backward_plain(
        fd, mask, code.detach(), idx1, idx2, acc, scal,
        opts.get("pointwise", True), code_bf16)
    assert bool(torch.isfinite(dcode).all())
    grads = [g.numpy() for g in torch.autograd.grad(code, c, dcode)]
    for g, w, a in zip(grads, want[2], autograd[2]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)
        np.testing.assert_allclose(g, a, **GRAD_TOL)


@pytest.mark.parametrize("n", [25, 121, 784])
def test_stream_mask_words_unpack_in_bit_order(n):
    """The forward's mask words (corr_stream.mask_words a row, a multiple
    of 4 for a 16-byte pitch): bit j % 32 of word j // 32 is column j, as
    numpy's little-endian unpacking reads them."""
    words = corr_stream.mask_words(n)
    assert words % 4 == 0 and 32 * words >= n > 32 * (words - 4)
    assert corr_stream.fd_pitch(n) % 4 == 0 and corr_stream.fd_pitch(n) >= n
    rng = np.random.default_rng(n)
    w = rng.integers(-2 ** 31, 2 ** 31, (3, 5, words), dtype=np.int64) \
        .astype(np.int32)
    want = np.unpackbits(w.view(np.uint8), bitorder="little") \
        .reshape(3, 5, 32 * words)[..., :n].astype(bool)
    np.testing.assert_array_equal(
        corr_stream.unpack_mask(torch.from_numpy(w), n).numpy(), want)


@pytest.mark.parametrize("n,cc,code_bf16", [(121, 70, False), (784, 70, True),
                                            (25, 160, False)])
def test_stream_code_tiles_layout(n, cc, code_bf16):
    """The backward's code tiles (corr_stream.code_tiles): (maps, tiles of
    64 rows, channels, 64) channel-major and contiguous, each value the
    code's (bf16 rounded to nearest even with code_bf16), zeros past n."""
    rng = np.random.default_rng(cc)
    code = t(rng.standard_normal((3, n, cc)).astype(np.float32))
    tiles = corr_stream.code_tiles(code, code_bf16)
    nt = -(-n // 64)
    assert tiles.shape == (3, nt, cc, 64) and tiles.is_contiguous()
    assert tiles.dtype == (torch.bfloat16 if code_bf16 else torch.float32)
    back = tiles.transpose(2, 3).reshape(3, nt * 64, cc).float()
    want = code.bfloat16().float() if code_bf16 else code
    assert torch.equal(back[:, :n], want)
    assert not bool(back[:, n:].any())
