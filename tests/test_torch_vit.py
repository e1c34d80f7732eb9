"""stego_torch ViT trunk, interpolation and l2-normalize against the JAX
package, same seeded inputs and weights on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.models.vit import ViTConfig as JaxViTConfig
from stego_tpu.models.vit import init_vit_params, vit_get_intermediate_feat
from stego_tpu.ops.interp import interpolate as jax_interpolate
from stego_tpu.ops.math import l2_normalize as jax_l2_normalize
from stego_torch.models.convert import vit_state_dict
from stego_torch.models.vit import ViTConfig, VisionTransformer
from stego_torch.ops.interp import interpolate
from stego_torch.ops.math import l2_normalize

# depth 2, embed 128 = 2 heads of 64, patch 8, trained at res 32 (4x4 grid)
SMALL = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2, img_size=32)
JAX_CFG = JaxViTConfig(**SMALL)
CFG = ViTConfig(**SMALL)


def jax_backbone(seed=0):
    """Random JAX ViT weights (init_vit_params) with non-trivial LayerNorm
    scales and biases, which the init sets to ones and zeros."""
    params = init_vit_params(jax.random.PRNGKey(seed), JAX_CFG)
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        x = np.asarray(x)
        if "bias" in jax.tree_util.keystr(path) or \
                "scale" in jax.tree_util.keystr(path):
            x = x + 0.05 * rng.standard_normal(x.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(jitter, params)


def port_vit(backbone):
    vit = VisionTransformer(CFG)
    vit.load_state_dict(vit_state_dict(backbone))
    return vit


def image(seed, res, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("res", [32, 48])
def test_vit_f32_matches_jax(res):
    """f32 trunk, n=2 with attention and qkv: atol 1e-4 (f32 sums in
    another order). res 48 interpolates the pos embed bicubically."""
    bb = jax_backbone()
    img = image(1, res)
    jf, ja, jq = vit_get_intermediate_feat(bb, jnp.asarray(img), JAX_CFG, n=2)
    with torch.no_grad():
        f, a, q = port_vit(bb).get_intermediate_feat(torch.from_numpy(img),
                                                     n=2)
    for i in range(2):
        np.testing.assert_allclose(f[i].numpy(), np.asarray(jf[i]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(a[i].numpy(), np.asarray(ja[i]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(q[i].numpy(), np.asarray(jq[i]),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("res", [32, 48])
def test_vit_bf16_flash_matches_jax(res):
    """bf16 trunk through the kernels' paths (JAX Pallas in interpret mode,
    the port's plain versions on the CPU): max abs 6e-2, mean abs 4e-3 —
    bf16 rounds at different points in the matmuls and GELU."""
    bb = jax_backbone(2)
    img = image(3, res)
    jf, _, _ = vit_get_intermediate_feat(bb, jnp.asarray(img), JAX_CFG, n=1,
                                         dtype=jnp.bfloat16,
                                         want_attn_qkv=False, use_flash=True)
    with torch.no_grad():
        f, _, _ = port_vit(bb).get_intermediate_feat(
            torch.from_numpy(img), n=1, want_attn_qkv=False,
            dtype=torch.bfloat16, use_flash=True)
    diff = np.abs(f[0].numpy() - np.asarray(jf[0]))
    assert diff.max() <= 6e-2 and diff.mean() <= 4e-3, (diff.max(),
                                                         diff.mean())


def test_vit_bf16_blocks_cast_changes_nothing():
    """cast_blocks stores the block weights in bf16; a bf16 trunk casts
    them at use anyway, so the features are identical."""
    vit = port_vit(jax_backbone(4))
    img = torch.from_numpy(image(5, 32))
    with torch.no_grad():
        kw = dict(n=1, want_attn_qkv=False, dtype=torch.bfloat16,
                  use_flash=True)
        before = vit.get_intermediate_feat(img, **kw)[0][0]
        after = vit.cast_blocks(torch.bfloat16).get_intermediate_feat(
            img, **kw)[0][0]
    torch.testing.assert_close(before, after, rtol=0, atol=0)


def test_trunc_normal_pins_its_draws_and_matches_jax_moments():
    """The port's own truncated normal (models/vit.py:trunc_normal) gives
    these values for seed 0 under any torch release (torch's
    ``nn.init.trunc_normal_`` changed its algorithm in 2.13, and with it
    every seeded trunk), and JAX's ``trunc_normal`` distribution: within
    [-2 std, 2 std], the truncated normal's std (0.8796 std) within 1%."""
    from stego_tpu.models.vit import trunc_normal as jax_trunc_normal
    from stego_torch.models.vit import trunc_normal

    got = trunc_normal(torch.empty(6), 0.02, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), np.array(
        [0.03081992268562317, -0.00586857832968235, -0.01438515167683363,
         0.011368625797331333, -0.021690446883440018, -0.027971908450126648],
        np.float32))
    big = trunc_normal(torch.empty(200000), 0.02,
                       torch.Generator().manual_seed(1)).numpy()
    want = np.asarray(jax_trunc_normal(jax.random.PRNGKey(1), (200000,)))
    for x in (big, want):
        assert np.abs(x).max() <= 0.04
        assert abs(x.mean()) < 2e-4
        np.testing.assert_allclose(x.std(), 0.02 * 0.87962566, rtol=1e-2)


def test_vit_seeded_init_is_deterministic():
    a = VisionTransformer(CFG, torch.Generator().manual_seed(7))
    b = VisionTransformer(CFG, torch.Generator().manual_seed(7))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    w = a.blocks[0].attn.qkv.weight.detach()
    assert float(w.abs().max()) <= 0.04 and 0.01 < float(w.std()) < 0.02


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("out_hw", [(7, 5), (12, 12), (3, 3)])
def test_interpolate_matches_jax(method, out_hw):
    """torch F.interpolate vs the JAX weight matrices, up and down: 1e-5."""
    x = np.random.default_rng(6).standard_normal((2, 6, 6, 3)) \
        .astype(np.float32)
    want = np.asarray(jax_interpolate(jnp.asarray(x), out_hw, method))
    got = interpolate(torch.from_numpy(x), out_hw, method).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(7).standard_normal((3, 4, 5)).astype(np.float32)
    x[0, 0] = 0.0  # the eps branch
    np.testing.assert_allclose(
        l2_normalize(torch.from_numpy(x), dim=-1).numpy(),
        np.asarray(jax_l2_normalize(jnp.asarray(x), axis=-1)), atol=2e-7,
        rtol=0)  # one f32 ulp of values up to 1


# ViT-T's geometry (192 wide, 3 heads of 64) at depth 2: the odd head count
# takes the head-major path (trunk_attention) in both packages
TINY = dict(patch_size=8, embed_dim=192, depth=2, num_heads=3, img_size=32)


def tiny_backbone(seed):
    params = init_vit_params(jax.random.PRNGKey(seed), JaxViTConfig(**TINY))
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)


@pytest.mark.parametrize("res", [32, 280])
def test_vit_tiny_flash_f32_matches_jax(res):
    """f32, use_flash: JAX's Pallas head-major kernels (interpret mode)
    against the port's plain versions, batch-resident at res 32 (N=17) and
    kv-resident at res 280 (N=1226, N_pad 1280 > 1152): rtol 1e-4, atol 1e-5,
    the JAX package's own tolerance for its flash trunk."""
    bb = tiny_backbone(8)
    img = image(9, res, b=1)
    jf, _, _ = vit_get_intermediate_feat(bb, jnp.asarray(img),
                                         JaxViTConfig(**TINY), n=1,
                                         want_attn_qkv=False, use_flash=True)
    vit = VisionTransformer(ViTConfig(**TINY))
    vit.load_state_dict(vit_state_dict(bb))
    with torch.no_grad():
        f, _, _ = vit.get_intermediate_feat(torch.from_numpy(img), n=1,
                                            want_attn_qkv=False,
                                            use_flash=True)
    np.testing.assert_allclose(f[0].numpy(), np.asarray(jf[0]), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("res", [32, 280])
def test_vit_tiny_flash_bf16_matches_jax(res):
    """bf16, use_flash, both head-major branches: max abs 6e-2, mean abs
    4e-3, the bf16 trunk gates of the ViT-S tests above."""
    bb = tiny_backbone(10)
    img = image(11, res, b=1)
    jf, _, _ = vit_get_intermediate_feat(bb, jnp.asarray(img),
                                         JaxViTConfig(**TINY), n=1,
                                         dtype=jnp.bfloat16,
                                         want_attn_qkv=False, use_flash=True)
    vit = VisionTransformer(ViTConfig(**TINY))
    vit.load_state_dict(vit_state_dict(bb))
    with torch.no_grad():
        f, _, _ = vit.get_intermediate_feat(
            torch.from_numpy(img), n=1, want_attn_qkv=False,
            dtype=torch.bfloat16, use_flash=True)
    diff = np.abs(f[0].numpy() - np.asarray(jf[0]))
    assert diff.max() <= 6e-2 and diff.mean() <= 4e-3, (diff.max(),
                                                         diff.mean())


def test_vit_tiny_head_major_path_equals_einsum_path():
    """The head-major path (plain versions on the CPU) against the trunk's
    einsum form on the same f32 weights: rtol 1e-4, atol 1e-5."""
    vit = VisionTransformer(ViTConfig(**TINY),
                            torch.Generator().manual_seed(3))
    img = torch.from_numpy(image(12, 48, b=2))
    with torch.no_grad():
        kw = dict(n=1, want_attn_qkv=False)
        flash = vit.get_intermediate_feat(img, use_flash=True, **kw)[0][0]
        einsum = vit.get_intermediate_feat(img, use_flash=False, **kw)[0][0]
    torch.testing.assert_close(flash, einsum, rtol=1e-4, atol=1e-5)
