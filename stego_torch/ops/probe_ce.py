"""The linear probe's loss and the probes' predictions at label
resolution; counterpart of ``stego_tpu/ops/probe_ce.py``.

Both upsample code-resolution logits bilinearly (``align_corners=False``)
to the label size. The loss upsamples with the separable torch-parity weight
matrices, as two matmuls over NCHW, as the JAX package does: on the card
the backward of ``F.interpolate`` adds into its bf16 gradient with atomics,
which is slow (the train step's largest kernel) and makes the linear probe's
gradient depend on the order of the adds. The predictions use
``F.interpolate`` (forward only).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from stego_torch.ops.interp import _linear_weight_matrix
from stego_torch.parallel import dist


@functools.lru_cache(maxsize=64)
def bilinear_matrix(out_size: int, in_size: int,
                    device: torch.device = torch.device("cpu"),
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(out_size, in_size) weights of torch's bilinear resize along one
    axis, ``align_corners=False`` (``ops/interp.py``'s f64 matrix), on
    ``device`` in ``dtype``. Cached: a copy to the card in every step would
    wait for the stream."""
    return torch.from_numpy(_linear_weight_matrix(
        out_size, in_size, False)).to(device=device, dtype=dtype)


def upsampled_masked_cross_entropy(logits: torch.Tensor,
                                   labels: torch.Tensor, n_classes: int,
                                   compute_dtype: Optional[torch.dtype] = None
                                   ) -> torch.Tensor:
    """Mean cross-entropy of the upsampled logits over the pixels whose
    label lies in [0, n_classes) (reference train_segmentation.py:210-218,
    ``probe_ce.py:36-91``); the denominator is at least 1.

    logits: (B, h, w, C) at code resolution; labels: (B, H, W) int.
    ``compute_dtype`` (default the logits') is the dtype of the upsampled
    (B, C, H, W) field: the train step passes bf16 for a bf16 trunk and f32
    otherwise (``segmenter.py:386-389``). The softmax sums are f32.
    Returns a scalar f32 loss. Over several processes it is this rank's
    share of the global batch's loss, whose denominator is the global count
    of valid pixels (``parallel/dist.py:masked_mean``)."""
    dt = compute_dtype or logits.dtype
    out_hw = (int(labels.shape[1]), int(labels.shape[2]))
    up = logits.to(dt).permute(0, 3, 1, 2)                  # (B, C, h, w)
    if tuple(up.shape[2:]) != out_hw:
        wh, ww = (bilinear_matrix(o, i, up.device, dt)
                  for o, i in zip(out_hw, up.shape[2:]))
        # up[b, c] = WH x[b, c] WW^T, each product rounded to dt
        up = torch.matmul(up.transpose(2, 3), wh.T)            # (B, C, w, H)
        up = torch.matmul(up.transpose(2, 3), ww.T)            # (B, C, H, W)
    m = up.amax(dim=1)                                        # (B, H, W)
    lse = m.float() + torch.log(torch.exp((up - m[:, None]).float()).sum(1))
    classes = torch.arange(up.shape[1], device=labels.device)
    onehot = (labels[:, None] == classes[None, :, None, None]).to(dt)
    picked = (up * onehot).float().sum(1)
    mask = (labels >= 0) & (labels < n_classes)
    nll = torch.where(mask, lse - picked, torch.zeros((), device=lse.device))
    return dist.masked_mean(nll.sum(), mask.sum())


def upsampled_argmax(logits: torch.Tensor,
                     out_hw: Sequence[int]) -> torch.Tensor:
    """argmax over classes of the bilinearly upsampled logits.

    logits: (B, h, w, C) at code resolution. Upsampled in f32, channel-major.
    Equals ``argmax(interpolate(logits, out_hw), -1)``; the eval step relies
    on bilinear resize commuting with the affine probes (weight rows sum to
    1) and on cluster argmax ignoring the per-pixel code norm.
    Returns (B, H, W) int32.
    """
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    x = logits.float().permute(0, 3, 1, 2)
    if tuple(x.shape[2:]) != out_hw:
        x = F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)
    return torch.argmax(x, dim=1).to(torch.int32)
