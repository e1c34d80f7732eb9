"""Cluster probe, linear probe and the reconstruction decoder; counterpart
of ``stego_tpu/models/probes.py``. NHWC maps; the probes are the reference's
modules (``ClusterLookup.clusters``, 1x1 ``nn.Conv2d``s) applied as channel
matmuls."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from stego_torch.ops.math import l2_normalize


class ClusterLookup(nn.Module):
    """Cluster centres ~ N(0, 1) (reference src/modules.py:134-144)."""

    def __init__(self, dim: int, n_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.clusters = nn.Parameter(
            torch.randn(n_classes, dim, generator=generator))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fresh N(0, 1) centres (reference src/modules.py:142-144)."""
        with torch.no_grad():
            self.clusters.copy_(torch.randn(self.clusters.shape,
                                            generator=generator))


def cluster_lookup(
    clusters: torch.Tensor, x: torch.Tensor, alpha: Optional[float],
    log_probs: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Cosine cluster assignment of (B, H, W, C) code x.

    log_probs=True: log_softmax(alpha * ips), (B, H, W, n_clusters).
    Otherwise (loss, probs): hard one-hot argmax when alpha is None,
    softmax(alpha * ips) else; loss = -mean(sum(probs * ips)).
    """
    ips = torch.einsum("bhwc,nc->bhwn", l2_normalize(x.float(), dim=-1),
                       l2_normalize(clusters.float(), dim=1))
    if log_probs:
        if alpha is None:
            raise ValueError("log_probs needs alpha")
        return torch.log_softmax(ips * alpha, dim=-1)
    if alpha is None:
        probs = F.one_hot(ips.argmax(-1), clusters.shape[0]).float()
    else:
        probs = torch.softmax(ips * alpha, dim=-1)
    loss = -torch.mean(torch.sum(probs * ips, dim=-1))
    return loss, probs


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``nn.Conv2d`` applied to an NHWC map as a channel matmul."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


def linear_probe_logits(probe: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) code -> (B, H, W, n_classes) logits."""
    return conv1x1(probe, x)


def decoder_apply(decoder: nn.Conv2d, code: torch.Tensor) -> torch.Tensor:
    """The reconstruction decoder, a 1x1 conv dim -> n_feats (reference
    src/train_segmentation.py:78), on (B, H, W, dim) code."""
    return conv1x1(decoder, code)


def init_conv1x1(conv: nn.Conv2d, generator: Optional[torch.Generator]):
    """torch's Conv2d default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias, drawn from ``generator``."""
    bound = 1.0 / conv.weight.shape[1] ** 0.5
    with torch.no_grad():
        for p in (conv.weight, conv.bias):
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)
