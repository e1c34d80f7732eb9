"""DINO Vision Transformer; counterpart of ``stego_tpu/models/vit.py``.

Parameter names follow the DINO state dict (``patch_embed.proj.weight``,
``blocks.{i}.attn.qkv.weight``, ...), the layout that
``stego_tpu/models/export.py:vit_state_dict`` writes, so a DINO or STEGO
checkpoint loads with ``load_state_dict``. Images are NHWC.

Numerics follow the JAX trunk:

* bf16 trunk (``dtype=torch.bfloat16``): block matmuls in bf16, tanh GELU
  (``vit.py:272-280``), LayerNorm statistics in f32. With ``use_flash`` the
  block LayerNorms go through kernel L (:func:`fused_layer_norm`) and every
  attention sublayer through kernel A: on token-major q/k/v for an even
  head count (:func:`token_major_attention`, ``vit.py:186-210``), else on
  head-major views of the same packed qkv through :func:`trunk_attention`
  (``vit.py:225-239``; ViT-T's 3 heads), which writes its output
  token-major for the projection. Past N_pad 4096 both take the einsum
  form.
* f32 trunk: erf GELU, einsum-form attention and the plain LayerNorm. With
  ``use_flash`` (which the JAX package runs through its Pallas kernels) the
  attention goes to kernel A's f32 instantiations (A-f32 at heads of 64,
  the narrow-head kernel's at 8, 16 and 32) by the same dispatch as the
  bf16 trunk's, and LayerNorm stays plain, as in JAX (``vit.py:166``); on
  the CPU the plain versions run.
* Weights are cast to the compute dtype where they are used, as the JAX
  trunk's ``.astype(x.dtype)`` does, so storing the block weights in bf16
  (:meth:`VisionTransformer.cast_blocks`) changes no result. Patch embed, cls
  token and pos embed stay f32; the pos embed is interpolated bicubically in
  f32 whenever the patch grid differs from the trained one.
* A block that returns its qkv (``feat_type="KK"``) runs the einsum form
  with logits in the compute dtype (``vit.py:211-248``).

The seeded init draws its truncated normals itself (:func:`trunc_normal`):
torch's ``nn.init.trunc_normal_`` changed its algorithm between releases,
so one seed gave other trunks under other torch versions.

The 12 blocks run as a Python loop. ``use_kernels = False`` makes the trunk
call each kernel's plain version even on a CUDA tensor, which is how the
kernels are held against their plain versions on the card. While
``torch.export`` traces the trunk (``serve.py``), the kernels are reached
through their registered ops, ``stego_torch::attention`` and
``stego_torch::layer_norm``, which end in the same launches; the eager paths
call the kernels' wrappers directly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stego_torch.ops.flash_attention import (
    attention_entry,
    attention_op,
    attention_plain,
    token_major_attention,
    trunk_attention,
    use_pair_attention,
)
from stego_torch.ops.interp import interpolate
from stego_torch.ops.layer_norm import (
    fused_layer_norm,
    layer_norm_op,
    layer_norm_plain,
)


@torch.no_grad()
def trunc_normal(t: torch.Tensor, std: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with N(0, std) truncated to [-2 std, 2 std] (the
    reference's init, vision_transformer.py:163-174; JAX's
    ``trunc_normal``) by rejection: normal draws, and every draw outside
    the bounds drawn again, the whole tensor at a time, until none is.

    ``nn.init.trunc_normal_`` took its values by the inverse CDF of
    uniform draws up to torch 2.12 and by this rejection from 2.13: the
    same seed gave another trunk under each, and the sensitive accuracy
    instrument's cluster mIoU moved from 20.9 to 15.9 with the draw alone
    (PERF.md). This is the 2.13 algorithm on the generator's normal
    stream, which both releases draw alike, so a seed's trunk is one trunk
    wherever the port runs (``tests/test_torch_vit.py`` pins its first
    values)."""
    lo = t.new_tensor(-2 * std, device="cpu").item()
    hi = t.new_tensor(2 * std, device="cpu").item()
    out = t.normal_(0.0, std, generator=generator)
    while True:
        outside = (out < lo) | (out > hi)
        if not outside.any():
            return t
        out.copy_(torch.where(outside, torch.empty_like(out).normal_(
            0.0, std, generator=generator), out))


@dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    img_size: int = 224  # resolution the positional embedding was trained at
    in_chans: int = 3    # 4 for Potsdam-with-IR (config potsdam_ir=true)

    @property
    def n_patches_side(self) -> int:
        return self.img_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


def _mk(patch_size: int, embed_dim: int, num_heads: int) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=embed_dim,
                     num_heads=num_heads)


# Reference vit_tiny / vit_small / vit_base (vision_transformer.py:259-277).
VIT_CONFIGS: Dict[str, Dict[int, ViTConfig]] = {
    "vit_tiny": {p: _mk(p, 192, 3) for p in (8, 16)},
    "vit_small": {p: _mk(p, 384, 6) for p in (8, 16)},
    "vit_base": {p: _mk(p, 768, 12) for p in (8, 16)},
}


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """Parameters of a LayerNorm (``weight``/``bias``, f32); the trunk
    applies it through :func:`_block_ln`."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def _block_ln(ln: LayerNorm, x: torch.Tensor, use_flash: bool,
              use_kernels: bool) -> torch.Tensor:
    """Kernel L on the bf16 flash trunk (``vit.py:160-170``), the plain
    version everywhere else."""
    if use_flash and use_kernels and x.dtype == torch.bfloat16:
        if torch.compiler.is_exporting():
            return layer_norm_op(x, ln.weight, ln.bias, ln.eps)
        return fused_layer_norm(x, ln.weight, ln.bias, ln.eps)
    return layer_norm_plain(x, ln.weight, ln.bias, ln.eps)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, want_qkv: bool, use_flash: bool,
                use_kernels: bool):
        """Returns (out, attn, qkv); attn and qkv only with ``want_qkv``
        (attn (B, H, N, N), qkv (3, B, H, N, d))."""
        b, n, d = x.shape
        heads = self.num_heads
        hd = d // heads
        scale = hd ** -0.5
        qkv = _linear(x, self.qkv)  # (B, N, 3D)
        if use_flash and not want_qkv and use_kernels \
                and torch.compiler.is_exporting():
            # export: both layouts through the one functional op
            if attention_entry(heads, hd, n) is not None:
                out = attention_op(*qkv.split(d, dim=-1), heads, scale)
                return _linear(out, self.proj), None, None
        elif use_flash and not want_qkv:
            if use_pair_attention(heads, hd, n):
                # token-major: q, k, v are the column blocks of qkv, read in
                # place through their strides
                q, k, v = qkv.split(d, dim=-1)
                fn = token_major_attention if use_kernels else attention_plain
                out = fn(q, k, v, heads, scale)
                return _linear(out, self.proj), None, None
            # head-major: (B, H, N, d) views of the packed qkv, and the
            # output written token-major through a view of the same kind
            q, k, v = qkv.unflatten(-1, (3, heads, hd)).unbind(2)
            out = torch.empty_like(x)
            if trunk_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), scale,
                               out=out.unflatten(-1, (heads, hd))
                               .transpose(1, 2),
                               use_kernel=use_kernels) is not None:
                return _linear(out, self.proj), None, None
        qkv = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, d)
        logits = (q.float() @ k.float().transpose(-1, -2)) * scale
        # bf16 trunks take the softmax over bf16 logits (vit.py:244-247)
        attn = torch.softmax(logits.to(x.dtype), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, d)
        out = _linear(out, self.proj)
        if want_qkv:
            return out, attn, qkv
        return out, None, None


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        # tanh GELU on bf16 trunks, exact erf GELU on f32 (vit.py:272-280)
        h = F.gelu(_linear(h, self.fc1),
                   approximate="tanh" if h.dtype == torch.bfloat16 else "none")
        return _linear(h, self.fc2)


class Block(nn.Module):
    """Pre-LN transformer block (reference Block.forward)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.ln_eps)
        self.attn = Attention(cfg.embed_dim, cfg.num_heads)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.ln_eps)
        self.mlp = Mlp(cfg.embed_dim, cfg.mlp_dim)

    def forward(self, x: torch.Tensor, want_qkv: bool, use_flash: bool,
                use_kernels: bool):
        y, attn, qkv = self.attn(
            _block_ln(self.norm1, x, use_flash, use_kernels), want_qkv,
            use_flash, use_kernels)
        x = x + y
        h = _block_ln(self.norm2, x, use_flash, use_kernels)
        return x + self.mlp(h), attn, qkv


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size)


class VisionTransformer(nn.Module):
    """DINO ViT trunk. ``generator`` seeds the random init (trunc-normal
    0.02 weights and embeddings, zero biases, unit LayerNorms, as
    ``init_vit_params``)."""

    # False: the kernels' plain versions, on any device; set on a trunk, or
    # on the class for every trunk that sets none (chip_smoke.py runs an app
    # that builds its own trunk so, against the same app with the kernels)
    use_kernels = True

    def __init__(self, cfg: ViTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.n_patches_side ** 2 + 1, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, cfg.ln_eps)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def trunc(t):
            trunc_normal(t, 0.02, generator)

        trunc(self.patch_embed.proj.weight)
        nn.init.zeros_(self.patch_embed.proj.bias)
        trunc(self.cls_token)
        trunc(self.pos_embed)
        for blk in self.blocks:
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                trunc(lin.weight)
                nn.init.zeros_(lin.bias)
            for ln in (blk.norm1, blk.norm2):
                nn.init.ones_(ln.weight)
                nn.init.zeros_(ln.bias)
        nn.init.ones_(self.norm.weight)
        nn.init.zeros_(self.norm.bias)

    def cast_blocks(self, dtype: torch.dtype) -> "VisionTransformer":
        """Store the blocks' matmul weights in ``dtype`` (the JAX
        ``cast_params_for_compute``): the same values enter the products, so
        results do not change; LayerNorms, patch embed and the embeddings
        stay f32."""
        for blk in self.blocks:
            blk.attn.to(dtype)
            blk.mlp.to(dtype)
        return self

    def interpolate_pos_encoding(self, h_patches: int,
                                 w_patches: int) -> torch.Tensor:
        """Bicubic resize of the patch pos embed to an (h, w) patch grid; the
        cls embedding passes through (``vit.py:283-302``)."""
        pe = self.pos_embed
        n = pe.shape[1] - 1
        if h_patches * w_patches == n and h_patches == w_patches:
            return pe
        side = int(math.sqrt(n))
        patch_pe = interpolate(pe[:, 1:].reshape(1, side, side, -1),
                               (h_patches, w_patches), method="bicubic")
        return torch.cat([pe[:, :1],
                          patch_pe.reshape(1, h_patches * w_patches, -1)], 1)

    def prepare_tokens(self, img: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
        """Patchify (NHWC in) + cls token + positional embedding."""
        b, h, w, _ = img.shape
        p = self.cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch {p}")
        proj = self.patch_embed.proj
        x = F.conv2d(img.permute(0, 3, 1, 2).to(dtype), proj.weight.to(dtype),
                     proj.bias.to(dtype), stride=p)
        x = x.flatten(2).transpose(1, 2)  # (B, hp*wp, D), row-major patches
        cls = self.cls_token.to(dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.interpolate_pos_encoding(h // p, w // p).to(dtype)

    def get_intermediate_feat(
        self, img: torch.Tensor, n: int = 1, want_attn_qkv: bool = True,
        dtype: torch.dtype = torch.float32, use_flash: bool = False,
    ) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]],
               List[Optional[torch.Tensor]]]:
        """LayerNormed tokens (f32, (B, 1+HW, D)), attention and qkv of the
        last ``n`` blocks (reference get_intermediate_feat)."""
        if not 1 <= n <= self.cfg.depth:
            raise ValueError(f"n={n} outside 1..{self.cfg.depth}")
        x = self.prepare_tokens(img, dtype)
        first = self.cfg.depth - n
        for blk in self.blocks[:first]:
            x, _, _ = blk(x, False, use_flash, self.use_kernels)
        feats, attns, qkvs = [], [], []
        for blk in self.blocks[first:]:
            x, attn, qkv = blk(x, want_attn_qkv, use_flash, self.use_kernels)
            feats.append(_block_ln(self.norm, x, use_flash,
                                   self.use_kernels).float())
            attns.append(attn)
            qkvs.append(qkv)
        return feats, attns, qkvs


# The reference's trunk methods (vision_transformer.py:211-256) as functions
# of a trunk, on get_intermediate_feat (``stego_tpu/models/vit.py:392-423``).
# As there, the trunk computes in f32 unless ``dtype`` says otherwise, and
# takes no kernel unless the caller passes ``use_flash=True``.


def vit_forward_feats(model: VisionTransformer, img: torch.Tensor,
                      dtype: torch.dtype = torch.float32,
                      use_flash: bool = False) -> torch.Tensor:
    """All-token output after the final norm, (B, 1+HW, D) f32 (reference
    forward_feats)."""
    feats, _, _ = model.get_intermediate_feat(
        img, n=1, want_attn_qkv=False, dtype=dtype, use_flash=use_flash)
    return feats[0]


def vit_cls_forward(model: VisionTransformer, img: torch.Tensor,
                    dtype: torch.dtype = torch.float32,
                    use_flash: bool = False) -> torch.Tensor:
    """The cls token's output, (B, D) f32 (reference forward)."""
    return vit_forward_feats(model, img, dtype, use_flash)[:, 0]


def vit_get_last_selfattention(model: VisionTransformer, img: torch.Tensor,
                               dtype: torch.dtype = torch.float32,
                               use_flash: bool = False) -> torch.Tensor:
    """Attention probabilities of the last block, (B, heads, N, N) in the
    trunk's dtype (reference get_last_selfattention). That block takes the
    einsum form, which returns them; ``use_flash`` reaches the blocks
    before it."""
    _, attns, _ = model.get_intermediate_feat(img, n=1, dtype=dtype,
                                              use_flash=use_flash)
    return attns[0]


def vit_get_intermediate_layers(model: VisionTransformer, img: torch.Tensor,
                                n: int = 1,
                                dtype: torch.dtype = torch.float32,
                                use_flash: bool = False
                                ) -> List[torch.Tensor]:
    """Normed token outputs of the last ``n`` blocks, each (B, 1+HW, D) f32
    (reference get_intermediate_layers)."""
    feats, _, _ = model.get_intermediate_feat(
        img, n=n, want_attn_qkv=False, dtype=dtype, use_flash=use_flash)
    return feats
