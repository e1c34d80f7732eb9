"""In-training CRF-style contrastive loss; counterpart of
``stego_tpu/ops/crf_loss.py``.

Behavioral reference: ContrastiveCRFLoss (src/modules.py:437-469): a sampled
Gaussian appearance+position kernel times cluster similarity. Off by default
(train_config.yml crf_weight: 0.0). NHWC layout. The sample coordinates are
an input (the train step draws them, ``train/segmenter.py:
draw_step_randomness``), so a test can hand in the JAX step's draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class CRFLossCfg:
    n_samples: int = 1000
    alpha: float = 0.5
    beta: float = 0.15
    gamma: float = 0.05
    w1: float = 10.0
    w2: float = 3.0
    shift: float = 0.0

    @classmethod
    def from_config(cls, cfg) -> "CRFLossCfg":
        return cls(n_samples=cfg.crf_samples, alpha=cfg.alpha, beta=cfg.beta,
                   gamma=cfg.gamma, w1=cfg.w1, w2=cfg.w2, shift=cfg.shift)


def contrastive_crf_loss(cfg: CRFLossCfg, guidance: torch.Tensor,
                         clusters: torch.Tensor,
                         coords: Tuple[torch.Tensor, torch.Tensor]
                         ) -> torch.Tensor:
    """Args:
      guidance: (B, H, W, Cg) image (e.g. RGB resized to 56).
      clusters: (B, H, W, K) normalized code.
      coords: (ys, xs), (S,) int64 sample rows and columns, shared by the
        batch.
    Returns: (B, S, S) negative kernel-weighted cluster similarities.
    """
    if tuple(clusters.shape[:3]) != tuple(guidance.shape[:3]):
        raise ValueError(f"guidance {tuple(guidance.shape)} and clusters "
                         f"{tuple(clusters.shape)} differ in (B, H, W)")
    ys, xs = coords
    sel_guidance = guidance[:, ys, xs, :]  # (B, S, Cg)
    sel_clusters = clusters[:, ys, xs, :]  # (B, S, K)

    pos = torch.stack([ys, xs], dim=0).float()  # (2, S)
    coord_diff = torch.sum(
        torch.square(pos[:, :, None] - pos[:, None, :]), dim=0)  # (S, S)
    guidance_diff = torch.sum(
        torch.square(sel_guidance[:, :, None, :]
                     - sel_guidance[:, None, :, :]), dim=-1)  # (B, S, S)

    sim_kernel = (
        cfg.w1 * torch.exp(-coord_diff[None] / (2 * cfg.alpha)
                           - guidance_diff / (2 * cfg.beta))
        + cfg.w2 * torch.exp(-coord_diff[None] / (2 * cfg.gamma))
        - cfg.shift
    )

    cluster_sims = torch.einsum("bik,bjk->bij", sel_clusters, sel_clusters)
    return -(cluster_sims * sim_kernel)
