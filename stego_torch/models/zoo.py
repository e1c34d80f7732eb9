"""The backbone zoo beyond ResNet-50: VGG-11 and DenseNet-121 feature
trunks, and the cut-backbone embedder of the KNN precompute; counterpart of
``stego_tpu/models/zoo.py``.

Behavioral reference: ``utils.load_model`` (src/utils.py:69-125) offers the
resnet50 variants (``models/resnet.py``), densenet121 and vgg11, each cut
to its feature trunk and globally average-pooled. They are embedders only:
the feature-pyramid head's channel table is ResNet-50's. Frozen; DenseNet's
BatchNorms fold to per-channel affines as ResNet-50's do. NHWC in, (B, D)
f32 out.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stego_torch.models.resnet import (RESNET_TYPES, FoldedBN, ResNet50,
                                       _conv, _np, conv, fold_bn, he_normal_,
                                       load_resnet_backbone,
                                       torchvision_file_state_dict)

# VGG-11 (configuration A), zoo.py:24
VGG11_CFG = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]
# the index of each convolution in torchvision's vgg11 ``features``
VGG11_CONV_INDEX = (0, 3, 6, 8, 11, 13, 16, 18)
# DenseNet-121: blocks, growth and initial width (zoo.py:91-92)
DENSENET121_BLOCKS = (6, 12, 24, 16)
GROWTH = 32
INIT_FEATURES = 64
EMBED_DIMS = {"vgg11": 512, "densenet121": 1024, **dict.fromkeys(
    RESNET_TYPES, 2048)}


class VGG11(nn.Module):
    """The VGG-11 feature trunk; state-dict keys ``features.{i}.weight`` /
    ``.bias`` as torchvision's (i the index in ``features``)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers, cin = [], 3
        for v in VGG11_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                c = nn.Conv2d(cin, v, 3, padding=1)
                c.requires_grad_(False)
                he_normal_(c, generator)
                with torch.no_grad():
                    c.bias.zero_()
                layers += [c, nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, img: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(B, H, W, 3) -> (B, 512) f32, the trunk's spatial mean
        (``zoo.py:vgg11_features``)."""
        x = img.to(dtype).permute(0, 3, 1, 2).contiguous()
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                x = torch.relu(conv(x, layer))
            elif isinstance(layer, nn.MaxPool2d):
                x = F.max_pool2d(x, 2, 2)
        return x.float().mean(dim=(2, 3))


class DenseLayer(nn.Module):

    def __init__(self, c: int):
        super().__init__()
        self.norm1, self.conv1 = FoldedBN(c), _conv(c, 4 * GROWTH, 1)
        self.norm2 = FoldedBN(4 * GROWTH)
        self.conv2 = _conv(4 * GROWTH, GROWTH, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv(torch.relu(self.norm1(x)), self.conv1)
        return conv(torch.relu(self.norm2(h)), self.conv2)


class Transition(nn.Module):

    def __init__(self, c: int):
        super().__init__()
        self.norm, self.conv = FoldedBN(c), _conv(c, c // 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(conv(torch.relu(self.norm(x)), self.conv), 2, 2)


class DenseNet121(nn.Module):
    """The DenseNet-121 feature trunk, BatchNorms folded; state-dict keys
    torchvision's under ``features.`` (``.w``/``.b`` for a folded norm)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        f = nn.Module()
        f.conv0, f.norm0 = _conv(3, INIT_FEATURES, 7, 2), \
            FoldedBN(INIT_FEATURES)
        c = INIT_FEATURES
        for bi, n_layers in enumerate(DENSENET121_BLOCKS, start=1):
            block = nn.Module()
            for li in range(1, n_layers + 1):
                setattr(block, f"denselayer{li}", DenseLayer(c))
                c += GROWTH
            setattr(f, f"denseblock{bi}", block)
            if bi < len(DENSENET121_BLOCKS):
                setattr(f, f"transition{bi}", Transition(c))
                c //= 2
        f.norm5 = FoldedBN(c)
        self.features = f
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m, generator)

    def forward(self, img: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(B, H, W, 3) -> (B, 1024) f32: the trunk, a ReLU and the spatial
        mean (``zoo.py:densenet121_features``)."""
        f = self.features
        x = img.to(dtype).permute(0, 3, 1, 2).contiguous()
        x = torch.relu(f.norm0(conv(x, f.conv0)))
        x = F.max_pool2d(x, 3, 2, 1)
        for bi in range(1, len(DENSENET121_BLOCKS) + 1):
            for layer in getattr(f, f"denseblock{bi}").children():
                x = torch.cat([x, layer(x)], dim=1)
            if bi < len(DENSENET121_BLOCKS):
                x = getattr(f, f"transition{bi}")(x)
        x = torch.relu(f.norm5(x))
        return x.float().mean(dim=(2, 3))


def vgg11_state_dict_from_torchvision(sd: Mapping[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """torchvision vgg11's convolutions (``features.{i}``, the classifier
    left out), in the order of their indices (``zoo.py:
    vgg11_params_from_torch``)."""
    idxs = sorted(int(k.split(".")[1]) for k in sd
                  if k.startswith("features.") and k.endswith(".weight"))
    return {f"features.{mine}.{leaf}": torch.from_numpy(
        _np(sd[f"features.{theirs}.{leaf}"]).astype(np.float32))
        for mine, theirs in zip(VGG11_CONV_INDEX, idxs)
        for leaf in ("weight", "bias")}


def densenet121_state_dict_from_torchvision(sd: Mapping[str, Any]
                                            ) -> Dict[str, torch.Tensor]:
    """torchvision densenet121's ``features.*``, the BatchNorms folded
    (``zoo.py:densenet121_params_from_torch``)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("features.") and "conv" in k.rsplit(".", 2)[-2]:
            out[k] = torch.from_numpy(_np(v).astype(np.float32))
        elif k.startswith("features.") and k.endswith(".running_mean"):
            prefix = k[:-len(".running_mean")]
            for name, t in fold_bn(sd, prefix).items():
                out[f"{prefix}.{name}"] = t
    return out


class CutBackboneEmbedder(nn.Module):
    """The KNN embedder of a non-dino arch (reference precompute_knns.py:
    56-58, ``zoo.py:CutBackboneEmbedder``): the cut trunk of
    ``model_type`` (resnet50 and its variants, vgg11, densenet121),
    mean-pooled. ``backbone_features`` gives (B, 1, 1, D), so the KNN's
    spatial mean (``train/knn.py:make_embed_fn``) is the pooled vector."""

    def __init__(self, model_type: str,
                 backbone_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if model_type in RESNET_TYPES:
            self.model = ResNet50(generator)
        elif model_type == "vgg11":
            self.model = VGG11(generator)
        elif model_type == "densenet121":
            self.model = DenseNet121(generator)
        else:
            raise ValueError(f"No model: {model_type} found")
        self.model_type = model_type
        self.backbone_dtype = backbone_dtype
        self.n_feats = EMBED_DIMS[model_type]

    def load_pretrained(self, path: str) -> None:
        """Read a torchvision-layout checkpoint (the reference's surgery for
        the ResNet variants) into the trunk."""
        if self.model_type in RESNET_TYPES:
            sd = load_resnet_backbone(self.model_type, path)
        else:
            raw = torchvision_file_state_dict(path)
            sd = (vgg11_state_dict_from_torchvision(raw)
                  if self.model_type == "vgg11"
                  else densenet121_state_dict_from_torchvision(raw))
        self.model.load_state_dict(sd)

    @torch.no_grad()
    def backbone_features(self, img: torch.Tensor) -> torch.Tensor:
        if self.model_type in RESNET_TYPES:
            pooled = self.model(img, self.backbone_dtype,
                                taps=("pooled",))["pooled"]
        else:
            pooled = self.model(img, self.backbone_dtype)
        return pooled[:, None, None, :]
