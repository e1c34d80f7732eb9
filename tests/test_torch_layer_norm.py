"""stego_torch kernel L (LayerNorm) against the JAX fused_layer_norm, and its
build and dispatch rules."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.ops.layer_norm import add_layer_norm as jax_add_ln
from stego_tpu.ops.layer_norm import fused_layer_norm as jax_fused_ln
from stego_torch.kernels import build
from stego_torch.ops import layer_norm as ln

EPS = 1e-6  # ViTConfig.ln_eps


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    # x3 with an offset so mean and variance are not trivial
    x = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("shape", [(3, 17, 128), (2, 37, 384), (2, 33, 192)])
def test_layer_norm_bf16_matches_jax(shape):
    """bf16: within one bf16 ulp of the Pallas kernel (interpret mode). Both
    take f32 statistics and round once; only the f32 sum order differs."""
    x, g, b = _inputs(0, shape)
    want = np.array(jax_fused_ln(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(g), jnp.asarray(b), EPS)
                    .astype(jnp.float32))
    got = ln.fused_layer_norm(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(g), torch.from_numpy(b), EPS)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    want_t = torch.from_numpy(want)
    assert torch.all((got.float() - want_t).abs()
                     <= ln.bf16_ulp_tolerance(want_t))


@pytest.mark.parametrize("shape", [(5, 128), (2, 9, 256), (3, 7, 192)])
def test_layer_norm_f32_matches_jax(shape):
    """f32: atol 1e-6, f32 rounding of the same two-pass formula."""
    x, g, b = _inputs(1, shape)
    want = np.asarray(jax_fused_ln(jnp.asarray(x), jnp.asarray(g),
                                   jnp.asarray(b), EPS))
    got = ln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(b), EPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 17, 192), (2, 9, 384)])
def test_add_layer_norm_bf16_matches_jax(shape):
    """bf16: the rounded sum equal to the Pallas kernel's (one bf16
    rounding of an exact f32 sum of two bf16), its LN within one bf16 ulp,
    and an f32 ``out_dtype`` within atol 1e-6 of the f32 statistics."""
    x, g, b = _inputs(3, shape)
    y = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jr, jo = jax_add_ln(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(y, jnp.bfloat16), jnp.asarray(g),
                        jnp.asarray(b), EPS)
    r, o = ln.add_layer_norm(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(y).bfloat16(),
                             torch.from_numpy(g), torch.from_numpy(b), EPS)
    assert r.dtype == o.dtype == torch.bfloat16
    np.testing.assert_array_equal(r.float().numpy(),
                                  np.array(jr.astype(jnp.float32)))
    want = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    assert torch.all((o.float() - want).abs() <= ln.bf16_ulp_tolerance(want))
    _, jo32 = jax_add_ln(jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(y, jnp.bfloat16), jnp.asarray(g),
                         jnp.asarray(b), EPS, out_dtype=jnp.float32)
    _, o32 = ln.add_layer_norm(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(y).bfloat16(),
                               torch.from_numpy(g), torch.from_numpy(b), EPS,
                               out_dtype=torch.float32)
    assert o32.dtype == torch.float32
    np.testing.assert_allclose(o32.numpy(), np.asarray(jo32), rtol=0,
                               atol=1e-6)


def _grads_jax(fn_name, x, y, g, b, w_r, w_o):
    import jax

    def loss(x, y, g, b):
        if fn_name == "ln":
            return jnp.sum(jax_fused_ln(x, g, b, EPS) * w_o)
        r, o = jax_add_ln(x, y, g, b, EPS)
        return jnp.sum(r * w_r) + jnp.sum(o * w_o)

    return [np.asarray(t) for t in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, y, g, b)))]


def _grads_port(fn_name, x, y, g, b, w_r, w_o):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, y, g, b)]
    if fn_name == "ln":
        total = (ln.fused_layer_norm(ts[0], ts[2], ts[3], EPS)
                 * torch.from_numpy(w_o)).sum()
    else:
        r, o = ln.add_layer_norm(ts[0], ts[1], ts[2], ts[3], EPS)
        total = (r * torch.from_numpy(w_r)).sum() \
            + (o * torch.from_numpy(w_o)).sum()
    total.backward()
    return [np.zeros_like(x) if t.grad is None else t.grad.numpy()
            for t in ts]


@pytest.mark.parametrize("fn_name", ["ln", "add_ln"])
@pytest.mark.parametrize("d", [192, 384])
def test_layer_norm_grads_match_jax(fn_name, d):
    """f32 gradients through both LayerNorms (the JAX custom VJPs' plain
    forms, tests/test_layer_norm.py:44-94) for x, y, weight and bias: rtol
    1e-5, atol 1e-6."""
    x, g, b = _inputs(5, (2, 11, d))
    rng = np.random.default_rng(6)
    y, w_r, w_o = (rng.standard_normal((2, 11, d)).astype(np.float32)
                   for _ in range(3))
    want = _grads_jax(fn_name, x, y, g, b, w_r, w_o)
    got = _grads_port(fn_name, x, y, g, b, w_r, w_o)
    for name, gw, gp in zip(("x", "y", "weight", "bias"), want, got):
        np.testing.assert_allclose(gp, gw, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_add_layer_norm_rejects_mixed_dtypes():
    x = torch.zeros(2, 192)
    with pytest.raises(ValueError, match="one dtype"):
        ln.add_layer_norm(x, x.bfloat16(), torch.ones(192), torch.zeros(192),
                          EPS)


def test_cpu_tensor_takes_plain_version_without_counting():
    x, g, b = (torch.from_numpy(a) for a in _inputs(2, (4, 128)))
    before = ln.LAUNCHES, ln.ADD_LAUNCHES
    torch.testing.assert_close(ln.fused_layer_norm(x, g, b, EPS),
                               ln.layer_norm_plain(x, g, b, EPS), rtol=0,
                               atol=0)
    for got, want in zip(ln.add_layer_norm(x, x, g, b, EPS),
                         ln.add_layer_norm_plain(x, x, g, b, EPS)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (ln.LAUNCHES, ln.ADD_LAUNCHES) == before


def test_non_cuda_device_raises():
    x = torch.empty(4, 128, device="meta")
    g = torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ln.fused_layer_norm(x, g, g, EPS)
    with pytest.raises(ValueError, match="CUDA"):
        ln.add_layer_norm(x, x, g, g, EPS)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No compiler, no library: the build raises instead of falling back."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()

