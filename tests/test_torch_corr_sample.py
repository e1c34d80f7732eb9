"""Kernel C1's route on the card, by its plain versions on the CPU: every
sampled set gathered once (``sample_sets_plain``, the gather kernel's
twin), the products by C2's plain version at N = S on the pair rows
(g * B + b: set b against set b, or against set g * B + b), C2's backward on
the stored fd and mask, and the adjoint (``unsample_plain``) back to the
code maps. The same seeded numpy inputs go through C1's plain version
(``sampled_corr_plain``) and the JAX kernel (interpret mode), with
PARITY_r05's sampled-loss tolerances: losses and cd means rtol 1e-4 atol
1e-6, code gradients rtol 2e-4 atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_torch.ops import corr_fused_sampling as c1
from stego_torch.ops import corr_stream
from tests.test_torch_corr_loss import (GRAD_TOL, LOSS_TOL, coords,
                                        jax_sampled, maps, plain_forward,
                                        port_sampled, t, weights)

OPTS = [dict(pointwise=True, zero_clamp=True),
        dict(pointwise=False, zero_clamp=False, stabalize=True)]
# (batch, map side, feature and code channels, samples a side, negatives):
# no negatives, five (the train step's count), and dim=100 with 12 x 12
# samples
SHAPES = [(3, 8, 32, 16, 3, 0), (6, 8, 40, 16, 3, 5), (2, 8, 32, 100, 12, 1)]


def derangements(b, neg, seed):
    """``neg`` seeded shifts of range(b) (b >= 2): no fixed point."""
    rng = np.random.default_rng(seed)
    return [(np.arange(b) + rng.integers(1, b)) % b for _ in range(neg)]


def inputs(b, hw, cf, cc, s, neg, seed):
    return (maps(seed, b=b, hw=hw, cf=cf, cc=cc),
            coords(seed + 1, b=b, s1=s, s2=s), derangements(b, neg, seed),
            [0.18, 0.12] + [0.46] * neg)


def route(f1, f2, c1_, c2_, g1, g2, perms, shifts, pointwise=True,
          zero_clamp=True, stabalize=False, feat_dtype=torch.float32):
    """The card's forward, plain: the sets, then C2's plain version on the
    pair rows, one group of B rows per pair type."""
    b, g = f1.shape[0], 2 + len(perms)
    fsets, csets, _ = c1.sample_sets_plain(f1, f2, c1_, c2_, g1, g2, perms,
                                           feat_dtype)
    i1, i2 = c1.pair_rows(b, g, csets.device)
    return corr_stream.fused_correlation_loss_plain(
        fsets[i1], fsets[i2], csets[i1], csets[i2], shifts, [b] * g,
        pointwise, zero_clamp, stabalize)


def assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **LOSS_TOL)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("opts", OPTS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fdt", ["float32", "bfloat16"])
def test_sets_through_c2_match_sampled_plain_and_jax(fdt, shape, opts):
    """The sets through C2's plain version give C1's plain version's and
    the JAX kernel's losses, cd means and code gradients."""
    arrs, cs, perms, shifts = inputs(*shape, seed=sum(shape))
    fdt_t, fdt_j = getattr(torch, fdt), getattr(jnp, fdt)
    got = port_sampled(route, arrs, cs, perms, shifts, fdt_t, **opts)
    assert_close(got, port_sampled(c1.sampled_corr_plain, arrs, cs, perms,
                                   shifts, fdt_t, **opts))
    assert_close(got, jax_sampled(arrs, cs, perms, shifts, fdt_j, **opts))


@pytest.mark.parametrize("opts", OPTS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fdt", ["float32", "bfloat16"])
def test_stored_backward_and_adjoint_match_autograd(fdt, shape, opts):
    """The card's backward, plain: C2's backward on the forward's fd and
    clamp mask (``corr_stream.stream_backward_plain``) gives the sets' code
    gradient, and ``unsample_plain`` takes it to the code maps; against the
    autograd gradient of C1's plain version and the JAX kernel's."""
    arrs, cs, perms, shifts = inputs(*shape, seed=2 * sum(shape))
    fdt_t = getattr(torch, fdt)
    b, hw = arrs[0].shape[:2]
    g = 2 + len(perms)
    wl, wc = weights(g)
    f1, f2, k1, k2 = (t(a) for a in arrs)
    g1, g2 = t(cs[0]), t(cs[1])
    tp = [t(p) for p in perms]
    fsets, csets, norms = c1.sample_sets_plain(f1, f2, k1, k2, g1, g2, tp,
                                               fdt_t)
    i1, i2 = c1.pair_rows(b, g, "cpu")
    lo, hi = corr_stream.clamp_bounds(opts.get("zero_clamp", True),
                                      opts.get("stabalize", False))
    acc, fd, mask = plain_forward(fsets, csets, i1, i2, lo, hi, False)
    groups = [b] * g
    losses, cds, gm = corr_stream.finalize_rows(
        acc[:, 0], acc[:, 1], acc[:, 2], acc[:, 3], shifts, groups,
        opts["pointwise"])
    scal = corr_stream.backward_scalars(t(wl), t(wc), gm, shifts, groups,
                                        csets.shape[1])
    dsets = corr_stream.stream_backward_plain(
        fd, mask, csets, i1, i2, acc,
        scal[corr_stream.row_groups(groups, "cpu").long()],
        opts["pointwise"], False)
    grads = c1.unsample_plain(dsets, csets, norms, g1, g2, tp, (hw, hw))
    got = (losses.numpy(), cds.numpy(), [x.numpy() for x in grads])
    assert_close(got, port_sampled(c1.sampled_corr_plain, arrs, cs, perms,
                                   shifts, fdt_t, **opts))
    assert_close(got, jax_sampled(arrs, cs, perms, shifts,
                                  getattr(jnp, fdt), **opts))


@pytest.mark.parametrize("bad_entry", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_unsample_plain_is_the_vjp_of_sample_sets_plain(shape, bad_entry):
    """unsample_plain equals autograd's vector-Jacobian product of
    sample_sets_plain's code sets, for a random cotangent; a negative whose
    permutation entry is out of range is a zero set and adds nothing."""
    arrs, cs, perms, _ = inputs(*shape, seed=3 * sum(shape))
    if bad_entry:
        perms = [np.array([-1] + [0] * (shape[0] - 1))] + perms
    f1, f2, k1, k2 = (t(a) for a in arrs)
    k1.requires_grad_(True)
    k2.requires_grad_(True)
    g1, g2 = t(cs[0]), t(cs[1])
    tp = [t(p) for p in perms]
    _, csets, norms = c1.sample_sets_plain(f1, f2, k1, k2, g1, g2, tp)
    if bad_entry:
        assert not bool(csets[2 * shape[0]].any())
    rng = np.random.default_rng(shape[0])
    dsets = t(rng.standard_normal(csets.shape).astype(np.float32))
    want = torch.autograd.grad(csets, [k1, k2], dsets)
    hw = arrs[0].shape[1]
    got = c1.unsample_plain(dsets, csets.detach(), norms.detach(), g1, g2,
                            tp, (hw, hw))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_sample_sets_plain_layout():
    """Set b is image b at coords1 (side 1), set B + b the positive at
    coords2, set (2 + k) B + b image perm_k(b) at coords2; the pair rows
    read set b against itself, then against every other set in order; the
    code sets' raw norms are the samples' norms."""
    arrs, cs, perms, _ = inputs(3, 8, 16, 12, 3, 2, seed=9)
    f1, f2, k1, k2 = (t(a) for a in arrs)
    g1, g2 = t(cs[0]), t(cs[1])
    _, csets, norms = c1.sample_sets_plain(f1, f2, k1, k2, g1, g2,
                                           [t(p) for p in perms])
    from stego_torch.ops.sampling import sample_from_coords

    def sampled(x, c):
        z = sample_from_coords(x, c)
        return z.reshape(z.shape[0], -1, z.shape[-1])

    want = torch.cat([sampled(k1, g1), sampled(k2, g2)]
                     + [sampled(k1[t(p)], g2) for p in perms])
    torch.testing.assert_close(norms, want.norm(dim=-1), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(csets, want / want.norm(dim=-1,
                                                       keepdim=True),
                               rtol=1e-5, atol=1e-6)
    i1, i2 = c1.pair_rows(3, 4, "cpu")
    assert i1.tolist() == [0, 1, 2] * 4
    assert i2.tolist() == [0, 1, 2] + list(range(3, 12))
