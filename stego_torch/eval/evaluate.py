"""Flip-TTA inference of a trained segmenter; counterpart of
``stego_tpu/eval/evaluate.py`` (``load_model_for_eval``, ``make_eval_step``).

The grid CRF (``run_crf=True``) and the dataset loop with its metrics are
not ported yet (ROADMAP.md queue 1, Dataset eval and the CRF).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from stego_torch.data.transforms import channel_stats
from stego_torch.models.convert import load_stego_checkpoint
from stego_torch.models.probes import cluster_lookup, linear_probe_logits
from stego_torch.models.vit import ViTConfig
from stego_torch.ops.interp import interpolate
from stego_torch.ops.math import l2_normalize
from stego_torch.ops.probe_ce import upsampled_argmax
from stego_torch.train.segmenter import UnsupervisedSegmenter


def load_model_for_eval(model_path: str,
                        device: Union[str, torch.device],
                        vit_cfg: Optional[ViTConfig] = None
                        ) -> UnsupervisedSegmenter:
    """Load a STEGO Lightning ``.ckpt`` onto ``device`` in eval mode; a bf16
    backbone stores its block weights in bf16 (same results, no cast per
    call, as ``evaluate.py:203-208``)."""
    if not model_path.endswith(".ckpt"):
        raise ValueError(
            f"{model_path}: stego_torch reads Lightning .ckpt files; export "
            f"a JAX orbax checkpoint with "
            f"stego_tpu.models.export.export_stego_checkpoint")
    seg = load_stego_checkpoint(model_path, vit_cfg=vit_cfg)
    seg.to(device).eval()
    if seg.net.backbone_dtype == torch.bfloat16:
        seg.net.model.cast_blocks(torch.bfloat16)
    return seg


def flip_tta_code(seg: UnsupervisedSegmenter,
                  img: torch.Tensor) -> torch.Tensor:
    """f32 code averaged over the image and its horizontal flip: two trunk
    calls (reference eval_segmentation.py:124-126, ``evaluate.py:116-119``).
    img: (B, H, W, C) NHWC."""
    _, code1 = seg.net(img)
    _, code2 = seg.net(torch.flip(img, dims=[2]))
    return (code1 + torch.flip(code2, dims=[2])) / 2.0


def make_eval_step(seg: UnsupervisedSegmenter, run_crf: bool = False,
                   return_probs: bool = False):
    """Eval step ``step(img, label)`` for NHWC images; ``label`` gives the
    output size by its (B, H, W) shape.

    return_probs=False: (linear_preds, cluster_preds), (B, H, W) int32,
    argmax of the probes' upsampled logits (``evaluate.py:121-139``).
    return_probs=True: (linear log-probs, cluster log-probs, RGB in [0, 1])
    at label resolution (``evaluate.py:141-155``).
    """
    if run_crf:
        raise NotImplementedError(
            "run_crf=True: the grid CRF is not ported yet (ROADMAP.md queue "
            "1, Dataset eval and the CRF); pass run_crf=false")

    @torch.inference_mode()
    def eval_step(img: torch.Tensor, label: Union[torch.Tensor,
                                                  Sequence[int]]):
        hw = tuple(label.shape[1:3])
        code = flip_tta_code(seg, img)
        if not return_probs:
            # argmax on code-res logits, upsampled channel-major: the same
            # predictions as interpolate-then-probe (see upsampled_argmax)
            clusters = l2_normalize(seg.cluster_probe.clusters, dim=1)
            return (upsampled_argmax(
                        linear_probe_logits(seg.linear_probe, code), hw),
                    upsampled_argmax(code @ clusters.T, hw))
        code = interpolate(code, hw, "bilinear", align_corners=False)
        linear_probs = torch.log_softmax(
            linear_probe_logits(seg.linear_probe, code), dim=-1)
        cluster_probs = cluster_lookup(seg.cluster_probe.clusters, code,
                                       alpha=2.0, log_probs=True)
        mean, std = (torch.as_tensor(s, device=img.device)
                     for s in channel_stats(img.shape[-1]))
        img01 = torch.clamp(img * std + mean, 0.0, 1.0)[..., :3]
        return linear_probs, cluster_probs, img01

    return eval_step
