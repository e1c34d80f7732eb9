"""Contrastive feature-correspondence loss, reference form (the einsum
oracle); counterpart of ``stego_tpu/ops/correlation.py``.

Straight-line PyTorch of ContrastiveCorrelationLoss (src/modules.py:314-398):
sample feats and code at the given coordinates, l2-normalize, all-pairs
correlations, clamp and shift. It serves ``use_pallas_loss=False`` and is
the reference the sampled kernel C1 (``ops/corr_fused_sampling.py``) is
held to. The coordinates and the negative permutations are inputs: the
train step draws them (``train/segmenter.py:draw_step_randomness``), and
tests hand in the JAX package's draws.

With ``use_salience`` the step biases the coordinates towards a mask's
nonzero pixels (:func:`salience_coords`, the reference's 90/10 mix,
src/modules.py:355-364) before any of the loss's forms sees them: this
oracle, kernel C1 and kernel C2 grid-sampled all take the same points.

NHWC. Feature inputs carry no gradient (the trunk is frozen); the code
path does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from stego_torch.ops.math import l2_normalize, tensor_correlation
from stego_torch.ops.sampling import sample_from_coords

NEG_INF_MIN = -9999.0  # the reference's "no clamp" lower bound (:340)


@dataclass(frozen=True)
class CorrLossCfg:
    """Static knobs (reference train_config.yml:40-64)."""

    pointwise: bool = True
    zero_clamp: bool = True
    stabalize: bool = False
    feature_samples: int = 11
    neg_samples: int = 5
    pos_intra_shift: float = 0.18
    pos_inter_shift: float = 0.12
    neg_inter_shift: float = 0.46
    use_salience: bool = False
    # negatives_scope=local over D processes: one derangement and one
    # pointwise mean per contiguous block of batch // D images. 1 = global.
    neg_blocks: int = 1

    @classmethod
    def from_config(cls, cfg, neg_blocks: int = 1) -> "CorrLossCfg":
        return cls(
            pointwise=cfg.pointwise,
            zero_clamp=cfg.zero_clamp,
            stabalize=cfg.stabalize,
            feature_samples=cfg.feature_samples,
            neg_samples=cfg.neg_samples,
            pos_intra_shift=cfg.pos_intra_shift,
            pos_inter_shift=cfg.pos_inter_shift,
            neg_inter_shift=cfg.neg_inter_shift,
            use_salience=cfg.use_salience,
            neg_blocks=neg_blocks,
        )

    @property
    def shifts(self) -> Tuple[float, ...]:
        """One shift per group: self, knn-pos, then each negative."""
        return ((self.pos_intra_shift, self.pos_inter_shift)
                + (self.neg_inter_shift,) * self.neg_samples)


def salience_indices(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Flat pixel indices (B, n) drawn uniformly over each (B, H, W)
    mask's nonzero entries, uniformly over all pixels where a mask is
    empty, from uniforms ``u`` (B, n) in [0, 1): the inverse of each
    mask's cumulative count, so the draws are made without the data and
    the mask only maps them (``sample_nonzero_locations``'s categorical
    draw, ``correlation.py:115-140``)."""
    b = mask.shape[0]
    counts = (mask.reshape(b, -1) > 0).cumsum(1)
    total = counts[:, -1:]
    nonempty = total > 0
    span = torch.where(nonempty, total, torch.full_like(total,
                                                        counts.shape[1]))
    k = torch.minimum(torch.floor(u * span).long(), span - 1)
    # the first pixel whose count exceeds k is the (k + 1)-th nonzero one
    nz = torch.searchsorted(counts, k, right=True)
    return torch.where(nonempty, nz, k)


def index_coords(idx: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Normalised (x, y) coordinates (..., 2) of flat pixel indices of an
    (h, w) map, with the reference's quirks (src/modules.py:298-311): both
    axes divided by h, and (y, x) flipped to (x, y)."""
    ys = torch.div(idx, w, rounding_mode="floor").float()
    xs = (idx % w).float()
    coords_yx = torch.stack([ys, xs], dim=-1) / float(h)
    return torch.flip(coords_yx * 2.0 - 1.0, dims=(-1,))


def sample_nonzero_locations(mask: torch.Tensor,
                             u: torch.Tensor) -> torch.Tensor:
    """(B, n, 2) coordinates of :func:`salience_indices`' pixels."""
    return index_coords(salience_indices(mask, u), mask.shape[1],
                        mask.shape[2])


def salience_coords(mask: torch.Tensor, u: torch.Tensor,
                    uniform: torch.Tensor, mix: torch.Tensor
                    ) -> torch.Tensor:
    """(B, S, S, 2) coordinates biased towards the mask (``_draw_coords``,
    ``correlation.py:143-157``): a point of the mask's nonzero pixels where
    ``mix`` (B, S, S) exceeds 0.1, else the uniform point ``uniform``
    (B, S, S, 2); ``u`` (B, S*S) draws the mask's points."""
    b, s = uniform.shape[:2]
    nz = sample_nonzero_locations(mask, u).reshape(b, s, s, 2)
    keep = (mix > 0.1).float()[..., None]
    return nz * keep + uniform * (1.0 - keep)


def corr_loss_helper(f1: torch.Tensor, f2: torch.Tensor, c1: torch.Tensor,
                     c2: torch.Tensor, shift: float, cfg: CorrLossCfg
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pair's loss surface (reference helper, src/modules.py:325-347).
    Returns (loss (B, H, W, I, J), cd)."""
    fd = tensor_correlation(l2_normalize(f1), l2_normalize(f2)).detach()
    if cfg.pointwise:
        # fd - rowmean + mean: the reference's recentering (:330-333), its
        # mean taken per block of batch // neg_blocks images
        b, d = fd.shape[0], cfg.neg_blocks
        if b % d:
            raise ValueError(f"batch {b} not divisible by negatives blocks "
                             f"{d}")
        old_mean = fd.reshape(d, -1).mean(1).repeat_interleave(b // d) \
            .reshape((b,) + (1,) * (fd.ndim - 1))
        fd = fd - fd.mean(dim=(3, 4), keepdim=True) + old_mean
    cd = tensor_correlation(l2_normalize(c1), l2_normalize(c2))
    min_val = 0.0 if cfg.zero_clamp else NEG_INF_MIN
    if cfg.stabalize:
        cd_clamped = torch.clamp(cd, min_val, 0.8)
    else:
        cd_clamped = torch.clamp_min(cd, min_val)
    return -cd_clamped * (fd - shift), cd


def contrastive_correlation_loss(
    cfg: CorrLossCfg,
    orig_feats: torch.Tensor,
    orig_feats_pos: torch.Tensor,
    orig_code: torch.Tensor,
    orig_code_pos: torch.Tensor,
    coords1: torch.Tensor,
    coords2: torch.Tensor,
    perms: Sequence[torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """Three-pair loss (reference forward, src/modules.py:349-398) at the
    given (B, S, S, 2) coordinates, with one negative pair per entry of
    ``perms``. Returns scalar 'pos_intra_loss'/'pos_inter_loss', the
    unreduced 'neg_inter_loss' (the caller takes its mean) and the cd
    tensors, as the JAX function."""
    feats = sample_from_coords(orig_feats, coords1)
    code = sample_from_coords(orig_code, coords1)
    feats_pos = sample_from_coords(orig_feats_pos, coords2)
    code_pos = sample_from_coords(orig_code_pos, coords2)

    pos_intra_loss, pos_intra_cd = corr_loss_helper(
        feats, feats, code, code, cfg.pos_intra_shift, cfg)
    pos_inter_loss, pos_inter_cd = corr_loss_helper(
        feats, feats_pos, code, code_pos, cfg.pos_inter_shift, cfg)
    neg_losses, neg_cds = [], []
    for perm in perms:
        feats_neg = sample_from_coords(orig_feats[perm], coords2)
        code_neg = sample_from_coords(orig_code[perm], coords2)
        loss, cd = corr_loss_helper(feats, feats_neg, code, code_neg,
                                    cfg.neg_inter_shift, cfg)
        neg_losses.append(loss)
        neg_cds.append(cd)
    if not neg_losses:  # neg_samples == 0
        zero = torch.zeros((1, 1, 1, 1, 1), device=orig_code.device)
        neg_losses, neg_cds = [zero], [zero]
    return {
        "pos_intra_loss": pos_intra_loss.mean(),
        "pos_intra_cd": pos_intra_cd,
        "pos_inter_loss": pos_inter_loss.mean(),
        "pos_inter_cd": pos_inter_cd,
        "neg_inter_loss": torch.cat(neg_losses, dim=0),
        "neg_inter_cd": torch.cat(neg_cds, dim=0),
    }
