"""stego_torch's correlation loss against the JAX package: the plain version
of kernel C1 against the JAX fused-sampling kernel (interpret mode), the
einsum oracle, the sampler and the closed-form finalize, on the same seeded
inputs and the same coordinate and permutation draws."""

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


@pytest.mark.parametrize("what", ["full_field", "code_bf16", "streamed",
                                  "salience"])
def test_fused_loss_unported_branches_raise(what):
    arrs = [t(a) for a in maps(0)]
    cs = [t(c) for c in coords(1)]
    cfg = CorrLossCfg(feature_samples=2, neg_samples=0,
                      use_salience=what == "salience")
    kw = {"full_field": dict(full_field=True),
          "code_bf16": dict(code_bf16=True),
          "streamed": dict(sampling_impl="gather"),
          "salience": {}}[what]
    with pytest.raises(NotImplementedError, match="not ported"):
        corr_stream.contrastive_correlation_loss_fused(cfg, *arrs, *cs, [],
                                                       **kw)


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
