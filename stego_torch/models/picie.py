"""The PiCIE baseline (PanopticFPN) of the eval's comparison rows;
counterpart of ``stego_tpu/models/picie.py``.

Behavioral reference: src/picie/{backbone,fpn}.py, a torchvision-style
ResNet-50 with res2..res5 taps and an FPN decoder of four 1x1 convolutions
with upsample-and-add, used only to draw the "PiCIE (Baseline)" rows of the
eval (eval_segmentation.py:70-75,143-145,195-198). It reuses the port's
ResNet-50 (``models/resnet.py``) and ``ops/interp.py``.

The released ``picie_and_probes.pth`` pickles whole torch modules, not
state dicts: :func:`load_picie_checkpoint` unpickles them with permissive
class stubs and takes the tensors out (the JAX package's reader,
``picie.py:82-131``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from stego_torch.models.probes import cluster_lookup, conv1x1
from stego_torch.models.resnet import (ResNet50, _np,
                                       resnet50_state_dict_from_torchvision)
from stego_torch.ops.interp import interpolate

OUT_DIM = 256  # the resnet50 FPNDecoder's out_dim (picie/fpn.py:27)
# the decoder's laterals and their input widths, res5 first (picie.py:28)
DECODER_IN = {"layer1": 2048, "layer2": 1024, "layer3": 512, "layer4": 256}


class PiCIE(nn.Module):
    """``backbone`` (:class:`ResNet50`), ``decoder.layer{1..4}`` (1x1
    convs, keys as the reference's ``decoder.*``) and, when loaded from a
    checkpoint, the cluster probe's centres ``clusters`` (K, 256)."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 n_clusters: int = 27):
        super().__init__()
        self.backbone = ResNet50(generator)
        self.decoder = nn.Module()
        for name, cin in DECODER_IN.items():
            c = nn.Conv2d(cin, OUT_DIM, 1)
            bound = 1.0 / cin ** 0.5
            with torch.no_grad():
                for p in (c.weight, c.bias):
                    p.copy_(torch.rand(p.shape, generator=generator)
                            * 2 * bound - bound)
            setattr(self.decoder, name, c)
        self.clusters = nn.Parameter(
            torch.randn(n_clusters, OUT_DIM, generator=generator),
            requires_grad=False)
        self.requires_grad_(False)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """NHWC image -> the decoder's (B, H/4, W/4, 256) f32 features
        (``picie.py:picie_features``): laterals from res5 down to res2, each
        added to the one above upsampled bilinearly to its size."""
        taps = self.backbone(img, taps=("layer1", "layer2", "layer3",
                                        "layer4"))

        def lateral(name, x):
            return conv1x1(getattr(self.decoder, name), x)

        def up_add(x, y):
            return interpolate(x, y.shape[1:3], "bilinear",
                               align_corners=False) + y

        o = lateral("layer1", taps["layer4"])
        o = up_add(o, lateral("layer2", taps["layer3"]))
        o = up_add(o, lateral("layer3", taps["layer2"]))
        return up_add(o, lateral("layer4", taps["layer1"]))

    @torch.no_grad()
    def predict(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H/4, W/4) int64: the cluster probe's hard assignment of the
        features (``evaluate.py:251-255``)."""
        _, probs = cluster_lookup(self.clusters, self.features(img),
                                  alpha=None)
        return probs.argmax(-1)


def picie_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A PiCIE model state dict (``backbone.*`` torchvision-style,
    ``decoder.layer{1..4}.*``) -> :class:`PiCIE`'s, without ``clusters``
    (``picie.py:picie_params_from_state_dict``)."""
    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}
    out = {f"backbone.{k}": v for k, v in
           resnet50_state_dict_from_torchvision(backbone).items()}
    for name in DECODER_IN:
        for leaf in ("weight", "bias"):
            key = f"decoder.{name}.{leaf}"
            out[key] = torch.from_numpy(_np(sd[key]).astype(np.float32))
    return out


def load_picie_checkpoint(path: str) -> Dict[str, Any]:
    """The released ``picie_and_probes.pth``: {"state_dict": the model's
    (:func:`picie_state_dict`, with ``clusters`` when the file holds the
    cluster probe), "cluster_stats": the saved confusion matrix (the
    Hungarian assignment's input) when it holds it}. The file pickles whole
    modules; classes that do not import are stubbed."""
    import pickle

    class _Permissive(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (nn.Module,),
                            {"__init__": lambda self: None})

    with open(path, "rb") as f:
        try:
            state = torch.load(
                f, map_location="cpu", weights_only=False,
                pickle_module=type("pm", (), {
                    "Unpickler": _Permissive, "load": pickle.load}))
        except Exception as e:  # the file's contents decide
            raise RuntimeError(
                f"could not unpickle {path}: {e}. Extract a state_dict with "
                f"the reference environment and pass it to picie_state_dict "
                f"instead.") from e
    model = state["model"]
    model_sd = model.state_dict() if hasattr(model, "state_dict") else model
    out: Dict[str, Any] = {"state_dict": picie_state_dict(model_sd)}
    probe = state.get("cluster_probe")
    if probe is not None:
        probe = getattr(probe, "module", probe)
        psd = probe.state_dict() if hasattr(probe, "state_dict") else probe
        key = "clusters" if "clusters" in psd else list(psd)[0]
        out["state_dict"]["clusters"] = torch.as_tensor(
            _np(psd[key]).astype(np.float32))
    metrics = state.get("cluster_metrics")
    if metrics is not None and hasattr(metrics, "stats"):
        out["cluster_stats"] = _np(metrics.stats)
    return out


def picie_from_checkpoint(path: str) -> "tuple[PiCIE, Optional[np.ndarray]]":
    """(:class:`PiCIE` with the file's weights, its cluster stats or
    None), on the CPU."""
    loaded = load_picie_checkpoint(path)
    sd = loaded["state_dict"]
    net = PiCIE(n_clusters=sd["clusters"].shape[0] if "clusters" in sd
                else 27)
    missing, unexpected = net.load_state_dict(sd, strict=False)
    if unexpected or [k for k in missing if k != "clusters"]:
        raise ValueError(f"{path} does not fit PiCIE: missing {missing}, "
                         f"unexpected {unexpected}")
    return net, loaded.get("cluster_stats")
