"""DinoFeaturizer: frozen DINO ViT trunk + projection head; counterpart of
``stego_tpu/models/featurizer.py``.

Submodule names are the reference's (``model``, ``cluster1.0``,
``cluster2.{0,2}``), so a STEGO checkpoint's ``net.*`` keys load as they
are. Feature maps are NHWC, ``(B, H/p, W/p, C)``. Training applies channel
dropout through keep-masks that the caller draws
(``train/segmenter.py:draw_step_randomness``), so a test can hand in the
JAX package's draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from stego_torch.models.probes import conv1x1, init_conv1x1
from stego_torch.models.vit import ViTConfig, VisionTransformer


def dropout2d(x: torch.Tensor, p: float,
              keep: torch.Tensor) -> torch.Tensor:
    """Channel dropout of an NHWC map (nn.Dropout2d semantics): ``keep`` is
    a (B, 1, 1, C) bool mask; kept channels are scaled by 1/(1-p), the rest
    zeroed (``featurizer.py:52-59``)."""
    if p <= 0.0:
        return x
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class DinoFeaturizer(nn.Module):

    def __init__(
        self,
        vit_cfg: ViTConfig,
        dim: int,
        feat_type: str = "feat",
        projection_type: Optional[str] = "nonlinear",
        use_dropout: bool = True,
        dropout_p: float = 0.1,
        backbone_dtype: torch.dtype = torch.float32,
        use_flash_attention: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if feat_type not in ("feat", "KK"):
            raise ValueError(f"Unknown feat type: {feat_type}")
        self.vit_cfg = vit_cfg
        self.dim = dim
        self.feat_type = feat_type
        self.projection_type = projection_type
        self.use_dropout = use_dropout
        self.dropout_p = dropout_p
        self.backbone_dtype = backbone_dtype
        # bf16 trunks take the kernels, f32 keeps the einsum path
        # (featurizer.py:94-98)
        if use_flash_attention is None:
            use_flash_attention = backbone_dtype == torch.bfloat16
        self.use_flash_attention = use_flash_attention
        self.n_feats = vit_cfg.embed_dim
        self.model = VisionTransformer(vit_cfg, generator)
        n = self.n_feats
        if projection_type is not None:
            self.cluster1 = nn.Sequential(nn.Conv2d(n, dim, 1))
            init_conv1x1(self.cluster1[0], generator)
        if projection_type == "nonlinear":
            self.cluster2 = nn.Sequential(nn.Conv2d(n, n, 1), nn.ReLU(),
                                          nn.Conv2d(n, dim, 1))
            init_conv1x1(self.cluster2[0], generator)
            init_conv1x1(self.cluster2[2], generator)

    @torch.no_grad()
    def backbone_features(self, img: torch.Tensor) -> torch.Tensor:
        """Frozen-trunk spatial features (B, H/p, W/p, n_feats) f32: the last
        block's normed patch tokens ('feat') or keys ('KK')."""
        cfg = self.vit_cfg
        b, h, w, _ = img.shape
        hp, wp = h // cfg.patch_size, w // cfg.patch_size
        want_qkv = self.feat_type == "KK"
        feats, _, qkvs = self.model.get_intermediate_feat(
            img, n=1, want_attn_qkv=want_qkv, dtype=self.backbone_dtype,
            use_flash=self.use_flash_attention)
        if self.feat_type == "feat":
            return feats[0][:, 1:, :].reshape(b, hp, wp, cfg.embed_dim)
        k = qkvs[0][1][:, :, 1:, :]  # (B, heads, HW, d), cls dropped
        return k.transpose(1, 2).reshape(b, hp, wp, cfg.embed_dim).float()

    def signal(self, image_feat: torch.Tensor) -> torch.Tensor:
        """The correlation loss's signal and the reconstruction target: the
        trunk features themselves (the FPN arch picks a tap instead)."""
        return image_feat

    def head_parameters(self):
        """The projection head's parameters (the net optimizer's group)."""
        for name in ("cluster1", "cluster2"):
            if hasattr(self, name):
                yield from getattr(self, name).parameters()

    def head_code(self, image_feat: torch.Tensor,
                  keep1: Optional[torch.Tensor] = None,
                  keep2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cluster1 (+ cluster2 for 'nonlinear') in f32 (reference
        src/modules.py:108-117). Training passes two independent (B, 1, 1,
        C) keep-masks: dropout of cluster1's input and of cluster2's
        (``featurizer.py:141-166``)."""
        if self.projection_type is None:
            return image_feat
        x1 = image_feat if keep1 is None else dropout2d(
            image_feat, self.dropout_p, keep1)
        code = conv1x1(self.cluster1[0], x1)
        if self.projection_type == "nonlinear":
            x2 = image_feat if keep2 is None else dropout2d(
                image_feat, self.dropout_p, keep2)
            h = torch.relu(conv1x1(self.cluster2[0], x2))
            code = code + conv1x1(self.cluster2[2], h)
        return code

    def forward(self, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC image -> (feats, code), both NHWC."""
        image_feat = self.backbone_features(img)
        return image_feat, self.head_code(image_feat)
