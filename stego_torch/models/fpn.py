"""FeaturePyramidNet, the reference's ``arch: "feature-pyramid"``;
counterpart of ``stego_tpu/models/fpn.py``.

Behavioral reference: src/modules.py:164-252. The frozen ResNet-50
(``models/resnet.py``) gives taps at strides 32/16/8 (layer4/3/2);
granularity 1..4 builds a U-Net-like decoder of DoubleConv blocks, averages
per-scale 1x1-conv cluster maps resized bilinearly to 56 x 56, and
log-softmaxes them when the code is discrete. The correlation loss's signal
is layer4 (2048 channels at stride 32), so the code (56 x 56) and the
signal lie on two grids.

BatchNorm (reference DoubleConv, modules.py:255-272): training uses the
batch's statistics, evaluation the running ones. The running statistics are
buffers of the head (``conv{k}.double_conv.{1,4}.running_mean`` /
``running_var``, in the checkpoints); the training forward does not update
them, as ``nn.BatchNorm2d`` would (twice a step, for img and img_pos). The
train step refreshes them once, after the three Adam updates, by
:meth:`FeaturePyramidNet.bn_state_update` on the image's taps with the
updated head (``fpn.py:199-217``, ``segmenter.py:436-441``): momentum 0.1,
the unbiased batch variance. Over several processes (``parallel/dist.py``)
the batch statistics are the global batch's, as the JAX data mesh computes
them, so every rank's running statistics stay equal bit for bit.

Module names follow the reference: ``model`` (the trunk; the reference's
``cut_model``), ``cluster{k}.0`` and ``conv{k}.double_conv.{0,1,3,4}``.
Maps are NHWC at the interfaces.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stego_torch.models.probes import conv1x1
from stego_torch.models.resnet import ResNet50
from stego_torch.ops.interp import interpolate
from stego_torch.parallel import dist

FEAT_CHANNELS = [2048, 1024, 512, 3]  # modules.py:189
EXTRA_CHANNELS = [128, 64, 32, 32]  # modules.py:190
SPATIAL_RESOLUTIONS = [7, 14, 28, 56]  # modules.py:188
OUT_RES = 56  # the fixed interpolation target (modules.py:167-169)
BN_MOMENTUM = 0.1  # torch nn.BatchNorm2d's default
BN_EPS = 1e-5
TAPS = ("layer2", "layer3", "layer4")


def init_conv(c: nn.Conv2d, generator: Optional[torch.Generator]) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weight and bias from
    ``generator`` (``fpn.py:_init_conv``)."""
    bound = 1.0 / c.weight[0].numel() ** 0.5
    with torch.no_grad():
        for p in (c.weight, c.bias):
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)


class DoubleConv(nn.Module):
    """(3x3 conv, BatchNorm, ReLU) twice; the reference's
    ``double_conv`` Sequential."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout),
            nn.ReLU(), nn.Conv2d(cout, cout, 3, padding=1),
            nn.BatchNorm2d(cout), nn.ReLU())
        init_conv(self.double_conv[0], generator)
        init_conv(self.double_conv[3], generator)

    def forward(self, x: torch.Tensor, train: bool,
                stats: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]
                = None, path: str = "") -> torch.Tensor:
        """NCHW ``x``; ``stats`` records each norm's batch mean and unbiased
        variance under ``path``.``i``."""
        for i in (0, 3):
            c, bn = self.double_conv[i], self.double_conv[i + 1]
            x = F.conv2d(x, c.weight, c.bias, padding=1)
            x = torch.relu(batch_norm(x, bn, train, stats, f"{path}.{i + 1}"))
        return x


def local_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The per-channel mean and biased variance of NCHW ``x`` over (N, H,
    W), and their count, on this process's batch alone."""
    n = x.shape[0] * x.shape[2] * x.shape[3]
    return x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False), n


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The batch statistics of :func:`local_stats` over the global batch.
    Over W processes each rank holds its rows of it (all of one size): the
    mean is the all-reduced per-channel sum over the global count, and the
    variance the all-reduced sum of (x - mean)^2 over it, two passes as
    ``jnp.var`` takes them on the JAX mesh (a sum of squares less the
    squared mean cancels in f32 at a ResNet's activations). Both are
    differentiable (``parallel/dist.py:all_reduce_sum``), so every rank's
    loss reaches every rank's rows through them. One process computes
    :func:`local_stats`."""
    if not dist.initialized():
        return local_stats(x)
    n = x.shape[0] * x.shape[2] * x.shape[3] * dist.world()
    mean = dist.all_reduce_sum(x.sum(dim=(0, 2, 3))) / n
    var = dist.all_reduce_sum(
        ((x - mean[:, None, None]) ** 2).sum(dim=(0, 2, 3))) / n
    return mean, var, n


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool,
               stats: Optional[Dict] = None, path: str = "") -> torch.Tensor:
    """torch BatchNorm2d's arithmetic, written out as ``fpn.py:_batch_norm``
    writes it: the batch's mean and (biased) variance in training
    (:func:`batch_stats`, the global batch's over several processes), the
    running ones else; (x - mean) * rsqrt(var + eps) * weight + bias."""
    if train:
        mean, var, n = batch_stats(x)
        if stats is not None:
            stats[path] = (mean.detach(),
                           (var * (n / max(n - 1, 1))).detach())
    else:
        mean, var = bn.running_mean, bn.running_var
    scale = torch.rsqrt(var + BN_EPS)
    return ((x - mean[:, None, None]) * scale[:, None, None]
            * bn.weight[:, None, None] + bn.bias[:, None, None])


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class FeaturePyramidNet(nn.Module):
    """The interface of ``models/featurizer.py:DinoFeaturizer``:
    ``backbone_features`` (the frozen taps), ``signal`` (the loss's
    features), ``head_code`` and ``forward``. No dropout, no projection."""

    projection_type = None  # no head keep-masks to draw
    use_dropout = False
    dropout_p = 0.0

    def __init__(self, granularity: int, dim: int, continuous: bool,
                 backbone_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if granularity not in (1, 2, 3, 4):
            raise ValueError(f"granularity must be 1..4, got {granularity}")
        self.granularity = granularity
        self.dim = dim
        self.continuous = continuous
        self.n_feats = dim  # modules.py:195
        self.backbone_dtype = backbone_dtype
        self.model = ResNet50(generator)
        widths = {1: FEAT_CHANNELS[0]}
        ins = {2: FEAT_CHANNELS[0] + FEAT_CHANNELS[1],
               3: EXTRA_CHANNELS[1] + FEAT_CHANNELS[2],
               4: EXTRA_CHANNELS[2] + FEAT_CHANNELS[3]}
        for k in range(1, granularity + 1):
            if k > 1:
                setattr(self, f"conv{k}", DoubleConv(
                    ins[k], EXTRA_CHANNELS[k - 1], generator))
                widths[k] = EXTRA_CHANNELS[k - 1]
            c = nn.Conv2d(widths[k], dim, 1)
            init_conv(c, generator)
            setattr(self, f"cluster{k}", nn.Sequential(c))

    @torch.no_grad()
    def backbone_features(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The frozen ResNet's layer2/3/4 taps (NHWC f32) and the image
        (granularity 4 concatenates it resized, modules.py:241-242)."""
        taps = self.model(img, self.backbone_dtype, taps=TAPS)
        return {**{k: taps[k] for k in TAPS}, "img": img}

    def signal(self, taps: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The correlation loss's signal: layer4 (reference low_res_feats,
        modules.py:221,252)."""
        return taps["layer4"]

    def head_parameters(self):
        """The decoder's parameters (the net optimizer's group)."""
        for k in range(1, self.granularity + 1):
            if k > 1:
                yield from getattr(self, f"conv{k}").parameters()
            yield from getattr(self, f"cluster{k}").parameters()

    def _cluster_to_56(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """1x1 conv, then bilinear to 56 (reference make_clusterer and
        _helper); NHWC."""
        code = conv1x1(getattr(self, f"cluster{k}")[0], x)
        return interpolate(code, OUT_RES, "bilinear", align_corners=False)

    def head_code(self, taps: Dict[str, torch.Tensor],
                  keep1: Optional[torch.Tensor] = None,
                  keep2: Optional[torch.Tensor] = None, train: bool = False,
                  stats: Optional[Dict] = None) -> torch.Tensor:
        """(B, 56, 56, dim) code (``fpn.py:head_code``): BatchNorm on the
        batch's statistics when ``train``, else on the running ones; the
        keep-masks are unused (no dropout)."""
        low = taps["layer4"]
        clusters = [self._cluster_to_56(low, 1)]

        def up(x):
            return interpolate(x, tuple(2 * s for s in x.shape[1:3]),
                               "bilinear", align_corners=False)

        f = low
        for k, skip in ((2, "layer3"), (3, "layer2"), (4, "img")):
            if self.granularity < k:
                break
            other = taps[skip] if k < 4 else interpolate(
                taps["img"], OUT_RES, "bilinear", align_corners=False)
            x = torch.cat([up(f), other.float()], dim=-1)
            f = _nhwc(getattr(self, f"conv{k}")(_nchw(x), train, stats,
                                                f"conv{k}.double_conv"))
            clusters.append(self._cluster_to_56(f, k))
        code = torch.stack(clusters).mean(dim=0)
        return code if self.continuous else torch.log_softmax(code, dim=-1)

    @torch.no_grad()
    def bn_state_update(self, taps: Dict[str, torch.Tensor],
                        momentum: float = BN_MOMENTUM) -> None:
        """Refresh every norm's running statistics in place from the batch
        statistics of ``taps`` under the current head (torch: running =
        (1 - m) running + m batch, the unbiased batch variance;
        ``fpn.py:bn_state_update``)."""
        stats: Dict = {}
        self.head_code(taps, train=True, stats=stats)
        for path, (mean, var) in stats.items():
            bn = self.get_submodule(path)
            bn.running_mean.copy_((1 - momentum) * bn.running_mean
                                  + momentum * mean)
            bn.running_var.copy_((1 - momentum) * bn.running_var
                                 + momentum * var)
            bn.num_batches_tracked += 1

    def forward(self, img: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC image -> (layer4 features, code), eval-mode BatchNorm."""
        taps = self.backbone_features(img)
        return taps["layer4"], self.head_code(taps)
