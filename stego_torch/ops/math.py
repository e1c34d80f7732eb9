"""Small math helpers (NHWC layout); counterpart of
``stego_tpu/ops/math.py``."""

from __future__ import annotations

import torch


def l2_normalize(t: torch.Tensor, dim: int = -1,
                 eps: float = 1e-10) -> torch.Tensor:
    """x / max(||x||, eps) along ``dim``. eps is 1e-10, the reference's
    (src/modules.py:275-276), not F.normalize's default 1e-12."""
    n = torch.sqrt(torch.sum(t * t, dim=dim, keepdim=True))
    return t / torch.clamp_min(n, eps)


def tensor_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs channel inner products of two NHWC maps, (B, H, W, I, J)
    (reference ``einsum("nchw,ncij->nhwij")``, src/modules.py:283-284)."""
    return torch.einsum("nhwc,nijc->nhwij", a, b)


def one_hot_feats(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(B, H, W) int labels -> (B, H, W, n_classes) f32 one-hot; a label
    outside [0, n_classes) gives a row of zeros, as ``jax.nn.one_hot``."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels[..., None] == classes).float()


def super_perm(size: int, generator: torch.Generator) -> torch.Tensor:
    """Random near-derangement of ``range(size)`` (reference super_perm,
    src/modules.py:291-295): a permutation with its fixed points bumped by
    one, wrapping around. int64 on the generator's device."""
    dev = generator.device
    perm = torch.randperm(size, generator=generator, device=dev)
    fixed = perm == torch.arange(size, device=dev)
    return torch.where(fixed, perm + 1, perm) % size


def block_local_super_perm(size: int, generator: torch.Generator,
                           n_blocks: int = 1) -> torch.Tensor:
    """One independent :func:`super_perm` per contiguous block of
    ``size // n_blocks`` rows (``negatives_scope=local``); ``n_blocks == 1``
    is :func:`super_perm`. A block of one image has no negative to draw
    (its only derangement is itself) and raises."""
    if n_blocks <= 1:
        return super_perm(size, generator)
    if size % n_blocks:
        raise ValueError(
            f"batch {size} not divisible by negatives blocks {n_blocks}")
    bl = size // n_blocks
    if bl < 2:
        raise ValueError(
            f"negatives_scope=local needs >=2 images per shard to draw a "
            f"negative from; got batch {size} over {n_blocks} shards "
            f"({bl}/shard). Raise batch_size or use negatives_scope=global.")
    return torch.cat([super_perm(bl, generator) + i * bl
                      for i in range(n_blocks)])
