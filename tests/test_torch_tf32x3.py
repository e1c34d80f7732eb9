"""The card's 3xTF32 arithmetic (``csrc/tf32x3.cuh``), emulated by
``stego_torch/ops/tf32.py``, against the JAX package's f32 functions on the
CPU: kernel A-f32's entry points and kernel C2's f32 fd row sums, losses
and code gradients hold the gates they are held to on the card, and a
single TF32 pass, the control, fails them.

Tolerances and their sources:

* attention, rtol = atol = 2e-5: the JAX package's f32 tolerance for its
  attention kernels (``tests/test_flash_attention.py``), the A-f32 gate of
  ``chip_smoke.py`` (F32_RTOL, F32_ATOL) and ``tests/test_torch_cuda.py``;
* C2's fd row sums, atol 1e-4: ``chip_smoke.py``'s ROW_SUM_ATOL;
* C2's losses and cd means, rtol 1e-4 and atol 1e-5, and code gradients at
  weights that make the largest 1, rtol 2e-4 and atol 1e-5:
  ``chip_smoke.py``'s STREAM_RTOL/STREAM_ATOL and GRAD_RTOL/GRAD_ATOL
  (PARITY_r05.json's corr rows).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.ops import flash_attention as jfa
from stego_tpu.ops.pallas_corr import _prep as jax_prep
from stego_tpu.ops.pallas_corr import _run_fwd as jax_run_fwd
from stego_tpu.ops.pallas_corr import _Static
from stego_tpu.ops.pallas_corr import \
    fused_correlation_loss_multi as jax_stream_multi
from stego_torch.ops import corr_stream
from stego_torch.ops import flash_attention as fa
from stego_torch.ops import tf32

D = 64
F32_TOL = dict(rtol=2e-5, atol=2e-5)
ROW_SUM_ATOL = 1e-4
STREAM_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
MATMULS = {"3xTF32": tf32.matmul_tf32x3, "TF32": tf32.matmul_tf32}


def _within(got, want, rtol, atol):
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


# --- round_tf32 and the products --------------------------------------------


def _round_tf32_reference(x):
    """Round to nearest, ties away, at 10 mantissa bits, with numpy's
    frexp: the value scaled to [2^10, 2^11), rounded, scaled back."""
    m, e = np.frexp(x.astype(np.float64))
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return np.ldexp(r, e).astype(np.float32)


def test_round_tf32_rounds_ties_away_from_zero():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + 1.5 * one_ulp,
                      1 + one_ulp / 2 - 2.0 ** -23, 0.0, 1.0, -3.0])
    want = [1 + one_ulp, -(1 + one_ulp), 1 + 2 * one_ulp, 1.0, 0.0, 1.0,
            -3.0]
    assert tf32.round_tf32(x).tolist() == want


def test_round_tf32_matches_reference_and_clears_low_bits():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(10000) * 10.0 ** rng.integers(-6, 6, 10000)
         ).astype(np.float32)
    got = tf32.round_tf32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _round_tf32_reference(x))
    assert int((got.view(torch.int32) & 0x1FFF).abs().max()) == 0
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    out = tf32.round_tf32(special)
    assert out[:2].tolist() == special[:2].tolist() and out[2].isnan()


def test_split_keeps_about_22_bits():
    """hi + lo is x to within 2^-22 of |x|: what 3xTF32 keeps."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(10000)
                         .astype(np.float32))
    hi, lo = tf32.split_tf32(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("depth", [8, 64, 70, 384])
def test_matmul_tf32x3_is_as_close_as_f32(depth):
    """Against an f64 product: 3xTF32 within 4x f32's own error, one TF32
    pass far outside it."""
    rng = np.random.default_rng(depth)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((3, 16, depth), (3, depth, 24)))
    want = a.double() @ b.double()
    f32_err = float((a @ b - want).abs().max())
    x3_err = float((tf32.matmul_tf32x3(a, b) - want).abs().max())
    one_err = float((tf32.matmul_tf32(a, b) - want).abs().max())
    assert x3_err <= 4 * f32_err
    assert one_err > 50 * f32_err


# --- kernel A-f32 -------------------------------------------------------------


def _attention_inputs(seed, b, n, h):
    """q, k ~ N(0, 4) and v ~ N(0, 1), token-major (B, N, H*64), as the
    card's A-f32 gate draws them (peaked softmax rows)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, h * D)).astype(np.float32)
               for _ in range(3))
    return 2 * q, 2 * k, v


def _heads(x, h):
    return np.ascontiguousarray(
        x.reshape(x.shape[0], x.shape[1], h, D).transpose(0, 2, 1, 3))


# the f32 entry points of A and the form of each: the token-major two-pass
# form (the f32 trunk's) and the head-major softmax forms
ENTRIES = {
    "pair_attention": "two_pass",
    "batch_resident_attention": "two_pass",
    "resident_attention": "resident",
    "flash_attention": "flash",
}


@functools.lru_cache(maxsize=None)
def _attention_case(entry, n):
    """(inputs, JAX's f32 output) of ``entry`` at B=2, H=2, N=n."""
    b, h = 2, 2
    q, k, v = _attention_inputs(n, b, n, h)
    if entry == "pair_attention":
        want = jfa.pair_attention(*(jnp.asarray(x) for x in (q, k, v)), h,
                                  D ** -0.5, interpret=True)
        return (q, k, v), np.asarray(want)
    heads = tuple(_heads(x, h) for x in (q, k, v))
    want = getattr(jfa, entry)(*(jnp.asarray(x) for x in heads), D ** -0.5,
                               interpret=True)
    return heads, np.asarray(want)


def _attention_emulated(entry, inputs, matmul):
    args = tuple(torch.from_numpy(x) for x in inputs)
    if entry == "pair_attention":
        return fa.attention_plain(*args, 2, D ** -0.5, matmul=matmul).numpy()
    return fa.attention_heads_plain(*args, D ** -0.5, ENTRIES[entry],
                                    matmul=matmul).numpy()


@pytest.mark.parametrize("n", [200, 600])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_attention_tf32x3_holds_f32_gate(entry, n):
    """A-f32's products by 3xTF32, through each form's plain version,
    within 2e-5 of the JAX kernel in f32."""
    inputs, want = _attention_case(entry, n)
    got = _attention_emulated(entry, inputs, tf32.matmul_tf32x3)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("n", [200, 600])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_attention_single_tf32_pass_fails_f32_gate(entry, n):
    """The control: one TF32 pass a product misses the same gate."""
    inputs, want = _attention_case(entry, n)
    got = _attention_emulated(entry, inputs, tf32.matmul_tf32)
    assert not _within(got, want, **F32_TOL)


def _online_softmax(q, k, v, scale, matmul, scale_q, tile=64):
    """A softmax form as A-f32 takes it: one pass over tiles of ``tile``
    keys with an online softmax (p against the running max, the sum and the
    accumulator rescaled when it grows, divided at the end), the scale on q
    (``scale_q``: two-pass) or on the logits (flash and resident),
    head-major f32."""
    if scale_q:
        q = q * torch.tensor(scale)
    shape = q.shape[:-1] + (1,)
    m = torch.full(shape, -torch.inf)
    l = torch.zeros(shape)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for k0 in range(0, k.shape[2], tile):
        s = matmul(q, k[:, :, k0:k0 + tile].transpose(-1, -2))
        if not scale_q:
            s = s * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + matmul(p, v[:, :, k0:k0 + tile])
        m = m_new
    return acc / l


@pytest.mark.parametrize("n", [200, 600])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_online_softmax_tf32x3_holds_f32_gate(entry, n):
    """The card's softmax forms take one pass with an online softmax in f32
    (p is not rounded there, so where the division falls changes only
    rounding; resident runs the flash form); with 3xTF32 products each holds
    the same gate against the JAX kernel, and with one TF32 pass none
    does."""
    inputs, want = _attention_case(entry, n)
    q, k, v = (torch.from_numpy(x) for x in inputs)
    if entry == "pair_attention":
        q, k, v = (x.unflatten(-1, (2, D)).transpose(1, 2)
                   for x in (q, k, v))
        want = _heads(want, 2)
    scale_q = ENTRIES[entry] == "two_pass"
    for name, matmul in MATMULS.items():
        got = _online_softmax(q, k, v, D ** -0.5, matmul, scale_q).numpy()
        assert _within(got, want, **F32_TOL) == (name == "3xTF32"), name


def test_no_softmax_elementwise_gate_measures_summation_order():
    """no_softmax's output is a sum of N unnormalised products with
    cancellation. At N = 785 the plain f32 version itself misses the
    elementwise 2e-5 gate against an f64 evaluation of the same form, so
    that gate (A-f32 against its plain version on the card) holds only a
    kernel that sums in the plain version's order: A-f32 keeps this form on
    f32 FMA in that order. 3xTF32 products are closer to f64 than the plain
    f32 version, and miss the gate against it too."""
    q, k, v = (torch.from_numpy(_heads(x, 2))
               for x in _attention_inputs(785, 2, 785, 2))
    scale = D ** -0.5
    qs = q * torch.tensor(scale)
    exact = (qs.double() @ k.double().transpose(-1, -2)) @ v.double()
    plain = fa.attention_heads_plain(q, k, v, scale, "no_softmax")
    emulated = fa.attention_heads_plain(q, k, v, scale, "no_softmax",
                                        matmul=tf32.matmul_tf32x3)
    assert not _within(plain.double().numpy(), exact.numpy(), **F32_TOL)
    assert not _within(emulated.numpy(), plain.numpy(), **F32_TOL)
    assert float((emulated.double() - exact).abs().max()) \
        < float((plain.double() - exact).abs().max())


# --- kernel C2 ----------------------------------------------------------------

B, HW, CF, CC, NEG = 2, 16, 384, 70, 1
SHIFTS = (0.18, 0.12, 0.46)
C2_OPTIONS = {
    "pointwise, zero_clamp": dict(pointwise=True, zero_clamp=True,
                                  stabalize=False),
    "stabalize": dict(pointwise=False, zero_clamp=False, stabalize=True),
}


@functools.lru_cache(maxsize=None)
def _c2_maps():
    """Seeded NHWC f32 feature and code maps of the self, positive and one
    negative pair: ViT-S's 384 feature and cocostuff27's 70 code channels
    on 16 x 16 maps."""
    rng = np.random.default_rng(5)
    fs = [rng.standard_normal((B, HW, HW, CF)).astype(np.float32)
          for _ in range(2 + NEG)]
    cs = [rng.standard_normal((B, HW, HW, CC)).astype(np.float32)
          for _ in range(2 + NEG)]
    return fs, cs


def _pairs(fs, cs):
    return [(fs[0], fs[k], cs[0], cs[k]) for k in range(len(fs))]


@functools.lru_cache(maxsize=None)
def _c2_jax(option):
    """JAX's f32 kernel in interpret mode: its row sums (s1, s2, s3, cd
    sums, each (R, N)), losses, cd means and the code gradients of a
    seeded combination scaled so that the largest gradient is 1."""
    fs, cs = _c2_maps()
    opts = C2_OPTIONS[option]
    n = HW * HW
    st = _Static(shifts=SHIFTS, group_sizes=(B,) * len(SHIFTS),
                 n_real=n, interpret=True, **opts)
    sides = [[jax_prep(jnp.asarray(x)) for x in pair]
             for pair in _pairs(fs, cs)]
    f1, f2, c1, c2 = (jnp.concatenate([s[j] for s in sides])
                      for j in range(4))
    sums = [np.asarray(x)[:, :n] for x in jax_run_fwd(f1, f2, c1, c2, st)]
    rng = np.random.default_rng(6)
    wl, wc = (rng.standard_normal(len(SHIFTS)).astype(np.float32)
              for _ in range(2))

    def fn(code, wl, wc):
        losses, cds = jax_stream_multi(
            _pairs([jnp.asarray(f) for f in fs], code), SHIFTS,
            interpret=True, **opts)
        return jnp.sum(losses * wl) + jnp.sum(cds * wc), (losses, cds)

    code = [jnp.asarray(c) for c in cs]
    (_, (losses, cds)), grads = jax.value_and_grad(fn, has_aux=True)(
        code, wl, wc)
    scale = 1.0 / max(float(jnp.abs(g).max()) for g in grads)
    grads = jax.grad(lambda c: fn(c, wl * scale, wc * scale)[0])(code)
    return (sums, np.asarray(losses), np.asarray(cds),
            [np.asarray(g) for g in grads], (wl * scale, wc * scale))


class _CodeDot(torch.autograd.Function):
    """cd = c1 c2^T in f32, as the kernel's FMA, with the backward's two
    products of dL/dcd with the code by ``matmul``, as the kernel takes
    them on the tensor cores."""

    @staticmethod
    def forward(ctx, c1, c2, matmul):
        ctx.save_for_backward(c1, c2)
        ctx.matmul = matmul
        return torch.bmm(c1, c2.transpose(1, 2))

    @staticmethod
    def backward(ctx, g):
        c1, c2 = ctx.saved_tensors
        return ctx.matmul(g, c2), ctx.matmul(g.transpose(1, 2), c1), None


def _c2_emulated(option, matmul):
    """C2's plain arithmetic (``corr_stream.fused_correlation_loss_plain``)
    with the products the kernel takes on the tensor cores by ``matmul``:
    fd, and the backward's products of dL/dcd with the code; cd stays f32,
    as the kernel's FMA. Row sums, losses, cd means and code gradients, as
    :func:`_c2_jax`."""
    fs, cs = _c2_maps()
    opts = C2_OPTIONS[option]
    *_, (wl, wc) = _c2_jax(option)
    code = [torch.from_numpy(c).requires_grad_(True) for c in cs]
    feats = [corr_stream.prep(torch.from_numpy(f)) for f in fs]
    prepped = [corr_stream.prep(c) for c in code]
    f1, c1 = (torch.cat([x[0]] * len(fs)) for x in (feats, prepped))
    f2, c2 = torch.cat(feats), torch.cat(prepped)
    fd = matmul(f1, f2.transpose(1, 2))
    cd = _CodeDot.apply(c1, c2, matmul)
    cdc = cd.clamp(*corr_stream.clamp_bounds(opts["zero_clamp"],
                                             opts["stabalize"]))
    sums = [(cdc * fd).sum(-1), cdc.sum(-1), fd.sum(-1), cd.sum(-1)]
    losses, cds, _ = corr_stream.finalize_rows(
        *sums, SHIFTS, [B] * len(SHIFTS), opts["pointwise"])
    total = (losses * torch.from_numpy(wl)).sum() \
        + (cds * torch.from_numpy(wc)).sum()
    grads = torch.autograd.grad(total, code)
    return ([s.detach().numpy() for s in sums], losses.detach().numpy(),
            cds.detach().numpy(), [g.numpy() for g in grads])


def _c2_gates(got, want):
    """{gate: passes} of the card's C2 gates."""
    sums, losses, cds, grads = got
    wsums, wlosses, wcds, wgrads, _ = want
    return {
        "fd row sums": float(np.abs(sums[2] - wsums[2]).max()) <= ROW_SUM_ATOL,
        "losses": _within(losses, wlosses, **STREAM_TOL),
        "cd means": _within(cds, wcds, **STREAM_TOL),
        "code gradients": all(_within(g, w, **GRAD_TOL)
                              for g, w in zip(grads, wgrads)),
    }


@pytest.mark.parametrize("option", sorted(C2_OPTIONS))
def test_c2_tf32x3_holds_f32_gates(option):
    """fd and the backward's products by 3xTF32 through C2's plain version:
    the fd row sums within 1e-4 of the JAX kernel's, and the losses, cd
    means and code gradients within the stream tolerances."""
    gates = _c2_gates(_c2_emulated(option, tf32.matmul_tf32x3),
                      _c2_jax(option))
    assert all(gates.values()), gates


@pytest.mark.parametrize("option", sorted(C2_OPTIONS))
def test_c2_tf32x3_row_sums_within_row_sum_gate(option):
    """Every one of the four row sums, not only fd's, within 1e-4."""
    got = _c2_emulated(option, tf32.matmul_tf32x3)[0]
    want = _c2_jax(option)[0]
    for g, w in zip(got, want):
        assert float(np.abs(g - w).max()) <= ROW_SUM_ATOL


@pytest.mark.parametrize("option", sorted(C2_OPTIONS))
def test_c2_single_tf32_pass_fails_row_sum_gate(option):
    """The control: with one TF32 pass a product the fd row sums miss
    the 1e-4 gate."""
    gates = _c2_gates(_c2_emulated(option, tf32.matmul_tf32),
                      _c2_jax(option))
    assert not gates["fd row sums"], gates
