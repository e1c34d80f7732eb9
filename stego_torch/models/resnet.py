"""ResNet-50, the frozen trunk of the feature-pyramid arch; counterpart of
``stego_tpu/models/resnet.py``.

Behavioral reference: the reference's ResNet zoo (``utils.load_model``,
src/utils.py:69-125) serves frozen eval-mode feature extractors for the
feature-pyramid arch (modules.py:164-252), the KNN precompute and the PiCIE
rows. The trunk never trains, so each BatchNorm is folded into a
per-channel affine ``(w, b)`` when a torchvision state dict is read, with
the JAX package's arithmetic (``resnet.py:_fold_bn``: f64, then f32).

An ``nn.Module`` on contiguous NCHW tensors; :meth:`ResNet50.forward` takes
and gives NHWC. (On the CPU, oneDNN's channels-last convolutions round
further from an f64 evaluation than its NCHW ones: VGG-11's pooled features
1e-4 against 2e-5.) The convolutions are ``F.conv2d``: the JAX package
computes them in XLA, outside any Pallas kernel. Taps follow the
reference's ``NetWithActivations`` over layer2/3/4 (modules.py:187,192):
strides 8/16/32 with 512/1024/2048 channels.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BOTTLENECK_COUNTS = {"resnet50": (3, 4, 6, 3)}
STAGE_PLANES = (64, 128, 256, 512)
EXPANSION = 4
BN_EPS = 1e-5
# the model types whose checkpoints load_resnet_backbone reads
RESNET_TYPES = ("resnet50", "mocov2", "robust_resnet50", "densecl")


def he_normal_(conv: nn.Conv2d, generator: Optional[torch.Generator]) -> None:
    """N(0, 2 / fan_in) weights drawn from ``generator``
    (``resnet.py:_conv_init``)."""
    fan_in = conv.weight[0].numel()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator)
                          * (2.0 / fan_in) ** 0.5)


class FoldedBN(nn.Module):
    """A BatchNorm folded to ``x * w + b`` per channel (NCHW)."""

    def __init__(self, c: int):
        super().__init__()
        self.w = nn.Parameter(torch.ones(c), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(c), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.w.to(x.dtype)[:, None, None] \
            + self.b.to(x.dtype)[:, None, None]


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """``layer`` in x's dtype, torch's symmetric padding (k - 1) // 2."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride,
                    layer.padding)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    c = nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                  bias=False)
    c.weight.requires_grad_(False)
    return c


class Bottleneck(nn.Module):

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        cout = planes * EXPANSION
        self.conv1, self.bn1 = _conv(cin, planes, 1), FoldedBN(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FoldedBN(planes)
        self.conv3, self.bn3 = _conv(planes, cout, 1), FoldedBN(cout)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                            FoldedBN(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(conv(x, self.conv1)))
        out = torch.relu(self.bn2(conv(out, self.conv2)))
        out = self.bn3(conv(out, self.conv3))
        if hasattr(self, "downsample"):
            x = self.downsample[1](conv(x, self.downsample[0]))
        return torch.relu(out + x)


class ResNet50(nn.Module):
    """The bottleneck ResNet-50 without its classifier, BatchNorms folded.
    State-dict keys are torchvision's for the convolutions (``conv1``,
    ``layer{s}.{i}.conv{j}``, ``layer{s}.0.downsample.0``) and ``.w``/``.b``
    for each folded BatchNorm. ``generator`` seeds the He-normal init of
    the convolutions (the folded BatchNorms start as the identity)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 7, 2), FoldedBN(64)
        cin = 64
        for stage, (planes, count) in enumerate(
                zip(STAGE_PLANES, BOTTLENECK_COUNTS["resnet50"]), start=1):
            blocks = []
            for i in range(count):
                blocks.append(Bottleneck(cin, planes,
                                         2 if i == 0 and stage > 1 else 1))
                cin = planes * EXPANSION
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m, generator)

    def cast_blocks(self, dtype: torch.dtype) -> "ResNet50":
        """Store the weights in ``dtype``: :meth:`forward` casts them to the
        compute dtype anyway, so results do not change and no cast runs a
        call."""
        return self.to(dtype)

    def forward(self, img: torch.Tensor, dtype: torch.dtype = torch.float32,
                taps=("stem", "layer1", "layer2", "layer3", "layer4",
                      "pooled")) -> Dict[str, torch.Tensor]:
        """NHWC image -> the taps asked for, NHWC f32 (``resnet.py:
        resnet50_features``): ``stem`` (after the max pool), ``layer1`` to
        ``layer4`` and ``pooled``, layer4's spatial mean (B, 2048).
        Computes in ``dtype``."""
        x = img.to(dtype).permute(0, 3, 1, 2).contiguous()
        x = torch.relu(self.bn1(conv(x, self.conv1)))
        x = F.max_pool2d(x, 3, 2, 1)
        out = {"stem": x}
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            out[f"layer{stage}"] = x
        out = {k: v.permute(0, 2, 3, 1).float() for k, v in out.items()
               if k in taps or (k == "layer4" and "pooled" in taps)}
        if "pooled" in taps:
            out["pooled"] = out["layer4"].mean(dim=(1, 2))
        return out


# ----------------------------------------------------------------------
# torchvision state dicts


def _np(t) -> np.ndarray:
    return t if isinstance(t, np.ndarray) else t.detach().cpu().numpy()


def fold_bn(sd: Mapping[str, Any], prefix: str, eps: float = BN_EPS
            ) -> Dict[str, torch.Tensor]:
    """A torchvision BatchNorm's (weight, bias, running_mean, running_var)
    folded to (w, b) in f64, stored f32 (``resnet.py:_fold_bn``)."""
    w = _np(sd[prefix + ".weight"]).astype(np.float64)
    b = _np(sd[prefix + ".bias"]).astype(np.float64)
    mean = _np(sd[prefix + ".running_mean"]).astype(np.float64)
    var = _np(sd[prefix + ".running_var"]).astype(np.float64)
    scale = w / np.sqrt(var + eps)
    return {"w": torch.from_numpy(scale.astype(np.float32)),
            "b": torch.from_numpy((b - mean * scale).astype(np.float32))}


def resnet50_state_dict_from_torchvision(sd: Mapping[str, Any]
                                         ) -> Dict[str, torch.Tensor]:
    """A torchvision-layout resnet50 state dict -> :class:`ResNet50`'s (the
    BatchNorms folded, ``resnet.py:resnet50_params_from_torch``); the
    classifier (``fc.*``) is left out."""
    out: Dict[str, torch.Tensor] = {}

    def take(conv_name: str, bn_name: str, conv_to: str, bn_to: str):
        out[conv_to + ".weight"] = torch.from_numpy(
            _np(sd[conv_name + ".weight"]).astype(np.float32))
        for k, v in fold_bn(sd, bn_name).items():
            out[f"{bn_to}.{k}"] = v

    take("conv1", "bn1", "conv1", "bn1")
    for stage, count in zip(range(1, 5), BOTTLENECK_COUNTS["resnet50"]):
        for i in range(count):
            pre = f"layer{stage}.{i}"
            for j in (1, 2, 3):
                take(f"{pre}.conv{j}", f"{pre}.bn{j}", f"{pre}.conv{j}",
                     f"{pre}.bn{j}")
            if pre + ".downsample.0.weight" in sd:
                take(pre + ".downsample.0", pre + ".downsample.1",
                     pre + ".downsample.0", pre + ".downsample.1")
    return out


def torchvision_file_state_dict(path: str) -> Dict[str, Any]:
    """The state dict of a torchvision-layout ``.pth`` (under
    ``state_dict`` where the file nests it), read as the JAX package's
    loaders read it (``torch.load`` with ``weights_only=False``: the
    released self-supervised checkpoints pickle more than tensors)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def load_resnet_backbone(model_type: str, path: str
                         ) -> Dict[str, torch.Tensor]:
    """:class:`ResNet50`'s state dict from a checkpoint of ``model_type``:
    the key surgery of the reference's ``utils.load_model``
    (src/utils.py:69-125, ``resnet.py:load_resnet_backbone``) for MoCo-v2
    (``module.encoder_q.*`` without ``fc``), the robust ResNet-50
    (``model.*`` under ``model``), DenseCL and torchvision's resnet50."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if model_type == "mocov2":
        pre = "module.encoder_q."
        sd = {k[len(pre):]: v for k, v in ckpt["state_dict"].items()
              if k.startswith(pre) and not k.startswith(pre + "fc")}
    elif model_type == "robust_resnet50":
        sd = {name.split("model.")[1]: value
              for name, value in ckpt["model"].items() if "model" in name}
    elif model_type == "densecl":
        sd = ckpt["state_dict"]
    elif model_type == "resnet50":
        sd = ckpt["state_dict"] if isinstance(ckpt, dict) \
            and "state_dict" in ckpt else ckpt
    else:
        raise ValueError(f"No model: {model_type} found")
    return resnet50_state_dict_from_torchvision(sd)
