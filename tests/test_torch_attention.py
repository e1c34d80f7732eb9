"""stego_torch kernel A (token-major attention) against the JAX pair kernels
(Pallas, interpret mode on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.ops import flash_attention as jfa
from stego_torch.ops import flash_attention as fa

D = 64


def _qkv(seed, b, n, h, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, n, h * D)) * scale).astype(np.float32)
            for _ in range(3)]


def _jax(fn, arrs, h, dtype):
    out = fn(*(jnp.asarray(a, dtype) for a in arrs), h, D ** -0.5,
             interpret=True)
    return np.array(out.astype(jnp.float32))


def _port(arrs, h, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrs)
    return fa.token_major_attention(q, k, v, h, D ** -0.5).float().numpy()


CASES = [(jfa.pair_attention, 2, 17, 2), (jfa.pair_attention, 1, 130, 4),
         (jfa.pair_kv_attention, 2, 300, 2)]


@pytest.mark.parametrize("fn,b,n,h", CASES)
def test_attention_f32_matches_jax(fn, b, n, h):
    """f32: 1e-5, the same softmax in f32 up to summation order."""
    arrs = _qkv(0, b, n, h)
    np.testing.assert_allclose(_port(arrs, h, torch.float32),
                               _jax(fn, arrs, h, jnp.float32),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn,b,n,h", CASES)
def test_attention_bf16_matches_jax(fn, b, n, h):
    """bf16: rtol 2e-2, atol 5e-3 (the attention rows of PARITY_r05.json):
    p is rounded to bf16 before PV on both sides, the f32 sums differ in
    order."""
    arrs = _qkv(1, b, n, h, scale=2.0)  # peaked, not uniform, softmax rows
    np.testing.assert_allclose(_port(arrs, h, torch.bfloat16),
                               _jax(fn, arrs, h, jnp.bfloat16),
                               rtol=2e-2, atol=5e-3)


def test_strided_views_equal_contiguous():
    """The trunk hands the kernel the column blocks of one packed qkv."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 33, 3 * 2 * D))
                           .astype(np.float32))
    q, k, v = qkv.split(2 * D, dim=-1)
    torch.testing.assert_close(
        fa.token_major_attention(q, k, v, 2, 0.125),
        fa.token_major_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), 2, 0.125), rtol=0, atol=0)


@pytest.mark.parametrize("heads", [1, 2, 3, 6, 12])
@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("n", [17, 785, 1601, 3137, 4097])
def test_use_pair_attention_predicate_matches_jax(heads, head_dim, n):
    assert fa.use_pair_attention(heads, head_dim, n) == \
        jfa.use_pair_attention(heads, head_dim, n)


def test_cpu_tensor_takes_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 9, 2))
    before = fa.LAUNCHES
    fa.token_major_attention(q, k, v, 2, 0.125)
    assert fa.LAUNCHES == before


def test_non_cuda_device_raises():
    q = torch.empty(1, 9, 2 * D, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.token_major_attention(q, q, q, 2, 0.125)



# --- head-major forms (A3: resident, batch_resident, kv_resident; A4: flash,
# packed) and trunk_attention, against the JAX kernels in interpret mode ---

HEAD_MAJOR = {
    "resident_attention": jfa.resident_attention,
    "batch_resident_attention": jfa.batch_resident_attention,
    "kv_resident_attention": jfa.kv_resident_attention,
    "flash_attention": jfa.flash_attention,
    "trunk_attention": jfa.trunk_attention,
}


def _heads_inputs(seed, b, h, n, d, scale):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, n, d)) * scale).astype(np.float32)
            for _ in range(3)]


def _head_major_pair(name, arrs, d, jdtype, tdtype):
    jargs = [jnp.asarray(a, jdtype) for a in arrs]
    if name == "trunk_attention":
        want = jfa.trunk_attention(*jargs, d ** -0.5)
    else:
        want = HEAD_MAJOR[name](*jargs, d ** -0.5, interpret=True)
    got = getattr(fa, name)(*(torch.from_numpy(a).to(tdtype) for a in arrs),
                            d ** -0.5)
    return got.float().numpy(), np.array(want.astype(jnp.float32))


@pytest.mark.parametrize("name", sorted(HEAD_MAJOR))
@pytest.mark.parametrize("n", [17, 200, 600])
@pytest.mark.parametrize("h", [3, 4])
@pytest.mark.parametrize("d", [8, 64])
def test_head_major_f32_matches_jax(name, n, h, d):
    """f32: rtol/atol 2e-5, the JAX package's own tolerance for these
    kernels (tests/test_flash_attention.py): the same rounding points, f32
    sums in another order."""
    got, want = _head_major_pair(name, _heads_inputs(n + h + d, 2, h, n, d,
                                                     1.0), d, jnp.float32,
                                 torch.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(HEAD_MAJOR))
@pytest.mark.parametrize("n", [17, 200, 600])
@pytest.mark.parametrize("h", [3, 4])
@pytest.mark.parametrize("d", [8, 64])
def test_head_major_bf16_matches_jax(name, n, h, d):
    """bf16: rtol 2e-2, atol 5e-3 (the attention rows of PARITY_r05.json).
    Both round q*scale (or the f32 logits' scale) and p at the same points;
    an f32 logit summed in another order may round p one bf16 ulp apart,
    which moves an output by ~2**-8 |v|. q, k scaled by 2: peaked rows."""
    got, want = _head_major_pair(name, _heads_inputs(n + h + d + 1, 2, h, n,
                                                     d, 2.0), d, jnp.bfloat16,
                                 torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("n", [17, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_attention_matches_jax(n, dtype):
    """(B, N, 3, H*64) packed qkv, H = 4 (the JAX kernel's contract: d = 64,
    an even head count); f32 at 2e-5, bf16 at rtol 2e-2, atol 5e-3."""
    h, d = 4, 64
    rng = np.random.default_rng(n)
    qkv = (rng.standard_normal((2, n, 3, h * d)) * 2).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.array(jfa.packed_attention(jnp.asarray(qkv, jd), h, d ** -0.5,
                                         interpret=True).astype(jnp.float32))
    got = fa.packed_attention(torch.from_numpy(qkv).to(td), h, d ** -0.5)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=5e-3)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_packed_attention_rejects_odd_heads():
    qkv = torch.zeros(1, 5, 3, 3 * 64)
    with pytest.raises(ValueError, match="even H"):
        fa.packed_attention(qkv, 3, 0.125)


@pytest.mark.parametrize("n", [1201, 4200])
def test_trunk_attention_long_sequences_match_jax(n):
    """N past RESIDENT_MAX_N: the kv-resident branch (n=1201, f32, 2e-5);
    past KV_RESIDENT_MAX_N both return None (the einsum path)."""
    arrs = _heads_inputs(n, 1, 3, n, 8, 1.0)
    if n > fa.KV_RESIDENT_MAX_N:
        assert fa.trunk_attention(*(torch.from_numpy(a) for a in arrs),
                                  0.125) is None
        assert jfa.trunk_attention(*(jnp.asarray(a) for a in arrs),
                                   0.125) is None
        return
    got, want = _head_major_pair("trunk_attention", arrs, 8, jnp.float32,
                                 torch.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("h,n,d,itemsize", [
    (3, 785, 64, 2), (3, 1601, 64, 2), (3, 3137, 64, 2), (3, 785, 64, 4),
    (4, 17, 8, 4), (12, 785, 64, 2), (6, 1025, 64, 2), (3, 4200, 64, 2)])
def test_trunk_attention_choice_matches_jax(monkeypatch, h, n, d, itemsize):
    """The port's trunk_attention takes the function JAX's takes at ViT-T's
    shapes (res 224, 320, 448; bf16 and f32), at the test configs' and at
    ViT-B's 12 heads, whose head slice the TPU's VMEM budget cuts (the slice
    chooses nothing on the card)."""
    seen = []
    for name in ("resident_attention", "batch_resident_attention",
                 "kv_resident_attention"):
        monkeypatch.setattr(jfa, name,
                            lambda *a, _n=name, **k: seen.append(_n) or 0)
        monkeypatch.setattr(fa, name,
                            lambda *a, _n=name, **k: seen.append(_n) or 0)
    dtype = jnp.bfloat16 if itemsize == 2 else jnp.float32
    q = jnp.zeros((1, h, n, d), dtype)
    want = jfa.trunk_attention(q, q, q, 0.125)
    qt = torch.zeros(1, h, n, d)
    got = fa.trunk_attention(qt, qt, qt, 0.125)
    assert (want is None) == (got is None)
    assert len(seen) == (0 if want is None else 2)
    if seen:
        assert seen[0] == seen[1]


def test_batch_resident_validates_heads_per_step():
    q = torch.zeros(1, 12, 9, 8)
    fa.batch_resident_attention(q, q, q, 0.25, heads_per_step=6)
    with pytest.raises(ValueError, match="does not divide"):
        fa.batch_resident_attention(q, q, q, 0.25, heads_per_step=5)


def test_resident_forms_reject_long_sequences():
    q = torch.zeros(1, 1, 1153, 8)
    for fn in (fa.resident_attention, fa.batch_resident_attention):
        with pytest.raises(ValueError, match="RESIDENT_MAX_N"):
            fn(q, q, q, 0.25)


def test_no_softmax_matches_bench_attncore_form():
    """The matmuls-only form of scripts/bench_attncore.py:_nopad_kernel
    (do_softmax=False): p = s of the bf16-scaled q, rounded to bf16, then
    p v with f32 accumulation; checked against that formula in numpy."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _heads_inputs(9, 1, 3, 40, 64, 1.0))
    got = fa.no_softmax_attention(q, k, v, 0.125).float().numpy()
    qs = (q.float() * 0.125).bfloat16().float().numpy()
    s = qs @ k.float().numpy().transpose(0, 1, 3, 2)
    p = torch.from_numpy(s).bfloat16().float().numpy()
    want = torch.from_numpy(p @ v.float().numpy()).bfloat16().float()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-2, atol=1e-2)


def test_out_view_receives_head_major_output():
    """An ``out`` view of a token-major tensor receives the head-major
    output: the trunk writes its attention where the projection reads it."""
    q, k, v = (torch.from_numpy(a) for a in _heads_inputs(4, 2, 3, 21, 8, 1.0))
    tok = torch.empty(2, 21, 3 * 8)
    ret = fa.trunk_attention(q, k, v, 0.3, out=tok.unflatten(-1, (3, 8))
                             .transpose(1, 2))
    want = fa.batch_resident_attention(q, k, v, 0.3)
    torch.testing.assert_close(tok, want.transpose(1, 2).flatten(2),
                               rtol=0, atol=0)
    assert ret.data_ptr() == tok.data_ptr()


def test_head_major_cpu_takes_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _heads_inputs(5, 1, 3, 9, 64, 1.0))
    before = dict(fa.ENTRY_LAUNCHES), fa.LAUNCHES
    for fn in (fa.resident_attention, fa.batch_resident_attention,
               fa.kv_resident_attention, fa.flash_attention,
               fa.no_softmax_attention):
        fn(q, k, v, 0.125)
    assert (dict(fa.ENTRY_LAUNCHES), fa.LAUNCHES) == before


def test_head_major_non_cuda_device_raises():
    q = torch.empty(1, 3, 9, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q, 0.125)
