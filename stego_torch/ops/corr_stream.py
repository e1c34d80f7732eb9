"""The fused contrastive-correlation loss's closed form and front end;
counterpart of ``stego_tpu/ops/pallas_corr.py``.

The loss of a group of pairs is a closed form in per-row sums over the
(S, S) correspondence of each pair (``pallas_corr.py:12-20``):

    s1 = sum_j clamp(cd) * fd,  s2 = sum_j clamp(cd),  s3 = sum_j fd

so a kernel only has to produce those sums; :func:`finalize` turns them into
the per-group losses. There is one group per pair type and one per negative
sample: the reference recenters fd with the mean of each helper() call
(src/modules.py:331-333).

:func:`contrastive_correlation_loss_fused` runs the sampled loss through
kernel C1 (``ops/corr_fused_sampling.py``). The streamed kernel C2
(``fused_correlation_loss_multi``: full-field mode, ``pallas_loss_bf16``,
``fused_sampling="off"``) is not ported yet, and those branches raise.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from stego_torch.ops.correlation import (NEG_INF_MIN, CorrLossCfg,
                                         salience_not_ported)
from stego_torch.ops.math import l2_normalize, tensor_correlation
from stego_torch.ops.sampling import sample_from_coords


def clamp_bounds(zero_clamp: bool, stabalize: bool) -> Tuple[float, float]:
    """(lo, hi) of the cd clamp (``pallas_corr.py:79-82``)."""
    return (0.0 if zero_clamp else NEG_INF_MIN,
            0.8 if stabalize else math.inf)


def device_vector(values: Sequence[float],
                  device: torch.device) -> torch.Tensor:
    """A small f32 vector of Python floats on ``device``, copied without a
    stream synchronisation (``torch.tensor(..., device=cuda)`` waits for the
    stream, which would stall the host mid-step). Pageable memory is staged
    before the copy call returns, so the temporary may go at once."""
    return torch.tensor(values, dtype=torch.float32).to(device,
                                                        non_blocking=True)


def finalize(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor,
             cds: torch.Tensor, shifts: Sequence[float], pointwise: bool
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-group losses from the row sums (``pallas_corr.py:167-193``).

    s1, s2, s3, cds: (G, Bg, n) row sums of each group's Bg pairs of n
    samples. Returns (losses (G,), cd_means (G,), fd means gm (G,)); the
    loss of group g is the mean over its Bg * n * n elements of
    -clamp(cd) * (fd' - shift), fd' = fd - rowmean + gm when pointwise."""
    n = s1.shape[-1]
    m = s1.shape[1] * n * n
    shift = device_vector(shifts, s1.device)
    big_s1 = s1.sum(dim=(1, 2))
    big_s2 = s2.sum(dim=(1, 2))
    gm = s3.sum(dim=(1, 2)) / m
    if pointwise:
        rowterm = (s3 * s2).sum(dim=(1, 2)) / n
        loss_sum = -(big_s1 - rowterm + (gm - shift) * big_s2)
    else:
        loss_sum = -(big_s1 - shift * big_s2)
    return loss_sum / m, cds.sum(dim=(1, 2)) / m, gm


def c2_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} runs the streamed correlation kernel C2 "
        f"(stego_tpu/ops/pallas_corr.py:fused_correlation_loss_multi), "
        f"which is not ported yet (ROADMAP.md queue 2, C2)")


def contrastive_correlation_loss_fused(
    cfg: CorrLossCfg,
    orig_feats: torch.Tensor,
    orig_feats_pos: torch.Tensor,
    orig_code: torch.Tensor,
    orig_code_pos: torch.Tensor,
    coords1: torch.Tensor,
    coords2: torch.Tensor,
    perms: Sequence[torch.Tensor],
    full_field: bool = False,
    return_cd_tensors: bool = False,
    feat_dtype: torch.dtype = torch.float32,
    code_bf16: bool = False,
    sampling_impl: str = "fused",
    use_kernel: bool = True,
) -> Dict[str, torch.Tensor]:
    """Three-pair sampled loss through kernel C1
    (``pallas_corr.py:contrastive_correlation_loss_fused``, :485-704, its
    ``sampling_impl="fused"`` branch). Scalar losses and cd means; with
    ``return_cd_tensors`` the cd entries are instead the cd tensors of the
    plainly sampled code, for the histograms (the loss still comes from
    C1). ``use_kernel=False`` calls C1's plain version even on a CUDA
    tensor, which is how the train step is held against it on the card."""
    if full_field:
        raise c2_not_ported("full_field_loss=True")
    if code_bf16:
        raise c2_not_ported("pallas_loss_bf16=True")
    if sampling_impl != "fused":
        raise c2_not_ported(f"sampling_impl={sampling_impl!r} "
                            f"(fused_sampling='off')")
    if cfg.use_salience:
        raise salience_not_ported()
    if cfg.neg_blocks > 1:
        raise ValueError(
            "neg_blocks>1 (negatives_scope=local) needs one process per "
            "block: the single-device fused kernel takes one pointwise mean "
            "per pair type")
    # imported here: kernel C1's module imports this one's finalize
    from stego_torch.ops.corr_fused_sampling import (sampled_corr_fused,
                                                     sampled_corr_plain)

    if len(perms) != cfg.neg_samples:
        raise ValueError(f"{len(perms)} permutations for neg_samples="
                         f"{cfg.neg_samples}")
    losses, cd_means = (sampled_corr_fused if use_kernel
                        else sampled_corr_plain)(
        orig_feats, orig_feats_pos, orig_code, orig_code_pos, coords1,
        coords2, perms, cfg.shifts, pointwise=cfg.pointwise,
        zero_clamp=cfg.zero_clamp, stabalize=cfg.stabalize,
        feat_dtype=feat_dtype)
    has_neg = cfg.neg_samples > 0
    zero = torch.zeros((), device=losses.device)
    out = {
        "pos_intra_loss": losses[0],
        "pos_intra_cd": cd_means[0],
        "pos_inter_loss": losses[1],
        "pos_inter_cd": cd_means[1],
        "neg_inter_loss": losses[2:].mean() if has_neg else zero,
        "neg_inter_cd": cd_means[2:].mean() if has_neg else zero,
    }
    if return_cd_tensors:
        with torch.no_grad():
            code = sample_from_coords(orig_code, coords1)
            code_pos = sample_from_coords(orig_code_pos, coords2)

            def cd_of(c1, c2):
                return tensor_correlation(l2_normalize(c1), l2_normalize(c2))

            out["pos_intra_cd"] = cd_of(code, code)
            out["pos_inter_cd"] = cd_of(code, code_pos)
            if has_neg:
                code_neg = torch.cat([sample_from_coords(orig_code[p],
                                                         coords2)
                                      for p in perms])
                out["neg_inter_cd"] = cd_of(code.repeat(len(perms), 1, 1, 1),
                                            code_neg)
    return out
