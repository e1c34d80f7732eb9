"""UnsupervisedSegmenter and its train and val steps; counterpart of
``stego_tpu/train/segmenter.py``.

Submodule names are the Lightning module's (``net``, ``linear_probe``,
``cluster_probe``, ``train_cluster_probe``, ``decoder``), so ``state_dict()``
keys equal those of a STEGO ``.ckpt`` (``models/convert.py``).

The train step (:func:`make_train_step`) runs the frozen trunk once over
img ‖ img_pos (‖ img_aug with the aug-alignment loss), the head, the
contrastive correlation loss, the probe losses on the detached code and
three Adam updates. The cached steps
(:func:`make_cached_train_step`, :func:`make_cached_val_step`,
:func:`make_cached_val_epoch`) take the trunk's features from a feature
cache (``train/feat_cache.py``) by index instead, and share the rest. The
loss runs through kernel C1 when the fused conditions hold
(:func:`resolve_corr_sampling`), and through the streamed kernel C2
otherwise: full-field (``full_field_loss``), or bilinearly sampled first
(``fused_sampling="off"``, ``pallas_loss_bf16``). Every random input of the
step (dropout keep-masks, sample coordinates, negative permutations, the
salience draw's uniforms, the augmentation's parameters) is an argument:
:func:`draw_step_randomness` draws them from a ``torch.Generator``; the
tests hand in the JAX package's draws instead, since ``jax.random``
streams cannot be reproduced in torch.

With ``use_salience`` the sample coordinates lean towards each image's
mask (``ops/correlation.py:salience_coords``): the step maps the draws
through the batch's ``mask``/``mask_pos`` (the cached step takes them
from the cache by index), and every form of the loss takes the mapped
points. The aug-alignment loss (``aug_alignment_weight > 0``) holds the
l2-normalised code, resampled at the augmented view's coordinates, to the
augmented view's code (``segmenter.py:346-363``); the augmented view comes
from the batch (``img_aug``/``coord_aug``, the host route,
``device_augs=False``) or is made in the step (``ops/augment.py``).

The CRF loss (``crf_weight > 0``, ``ops/crf_loss.py``) runs in the image
step on the image and the l2-normalised code, both resized to 56; the
cached step has no images and raises for it, as the JAX package's feature
cache does.

Over W processes (``parallel/dist.py``) every rank builds the segmenter
from one seed and takes rank 0's weights; each step's batch is the rank's
``batch // W`` images of the global batch and its draws are the global
batch's, of which the step takes the rank's part (:func:`local_draws`).
Global negatives (``negatives_scope="global"``) gather every rank's
feature and code maps and run the streamed kernel C2 on the rank's pair
rows, with each group's pointwise fd mean over the global batch; local
ones run each rank's own loss (kernel C1) with its own derangements. The
masked means take the global count of valid pixels, the gradients are
averaged over the ranks before the Adams, and the metrics and histograms
that a step returns are the global batch's: the ranks' weights stay equal
bit for bit, and a W-rank step computes the one-process step of the
global batch.

The feature-pyramid arch (``arch="feature-pyramid"``, ``models/fpn.py``)
takes the ResNet-50's taps as its features (a dict), layer4 as the loss's
signal on its own 7 x 7 grid beside the 56 x 56 code, and refreshes its
BatchNorm running statistics after the three Adam updates
(``segmenter.py:436-441``). Over several processes its train-mode
BatchNorms normalise by the global batch's statistics, all-reduced
(``models/fpn.py:batch_stats``), as the JAX mesh computes them, and the
refresh takes the same statistics, so the ranks' running statistics stay
equal bit for bit as their parameters do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from stego_torch.config import Config
from stego_torch.models.featurizer import DinoFeaturizer, dropout2d
from stego_torch.models.fpn import FeaturePyramidNet
from stego_torch.models.probes import (ClusterLookup, cluster_lookup,
                                       decoder_apply, init_conv1x1,
                                       linear_probe_logits)
from stego_torch.models.vit import VIT_CONFIGS, ViTConfig
from stego_torch.ops import augment
from stego_torch.ops.corr_stream import contrastive_correlation_loss_fused
from stego_torch.ops.correlation import (CorrLossCfg,
                                         contrastive_correlation_loss,
                                         salience_coords)
from stego_torch.ops.crf_loss import CRFLossCfg, contrastive_crf_loss
from stego_torch.ops.interp import interpolate
from stego_torch.ops.math import (block_local_super_perm, l2_normalize,
                                  one_hot_feats)
from stego_torch.ops.probe_ce import (upsampled_argmax,
                                      upsampled_masked_cross_entropy)
from stego_torch.ops.sampling import sample_from_coords
from stego_torch.parallel import dist
from stego_torch.utils.metrics import update_conf_matrix
from stego_torch.utils.precision import deterministic_convolutions_for

PROBE_LR = 5e-3  # linear and cluster probes (train_segmentation.py:379-381)
HIST_BINS = 64
CRF_RES = 56  # the CRF loss's image and code size (segmenter.py:365-373)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         n_classes: int) -> torch.Tensor:
    """Pixel CE of (..., C) logits over ``0 <= label < n_classes``
    (reference train_segmentation.py:210-218); over several processes,
    this rank's share of the global batch's mean
    (``parallel/dist.py:masked_mean``)."""
    mask = (labels >= 0) & (labels < n_classes)
    safe = torch.clamp(labels, 0, n_classes - 1).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, nll, torch.zeros((), device=nll.device))
    return dist.masked_mean(nll.sum(), mask.sum())


class UnsupervisedSegmenter(nn.Module):
    """Featurizer ``net`` + ``linear_probe`` (1x1 conv) + ``cluster_probe``,
    and the training-only ``train_cluster_probe`` and ``decoder``.
    ``generator`` seeds every random init. ``step`` counts train steps.
    ``use_corr_kernel = False`` makes the loss call the plain version of its
    kernel (C1 or C2) even on a CUDA tensor (as ``net.model.use_kernels``
    does for the trunk's kernels), to hold the step against it on the
    card. ``world`` and ``rank`` are the process group's (1 and 0 for one
    process); every rank takes rank 0's weights at construction."""

    def __init__(self, n_classes: int, cfg: Config,
                 vit_cfg: Optional[ViTConfig] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        self.cfg = cfg
        self.n_classes = n_classes
        self.dim = cfg.dim if cfg.continuous else n_classes
        backbone_dtype = (torch.bfloat16 if cfg.backbone_dtype == "bfloat16"
                          else torch.float32)
        if cfg.arch == "feature-pyramid":
            self.vit_cfg = None
            self.net = FeaturePyramidNet(cfg.granularity, self.dim,
                                         cfg.continuous, backbone_dtype,
                                         generator=generator)
        elif cfg.arch == "dino":
            if vit_cfg is None:
                vit_cfg = VIT_CONFIGS[cfg.model_type][cfg.dino_patch_size]
            if cfg.potsdam_ir:
                vit_cfg = dataclasses.replace(vit_cfg, in_chans=4)
            self.vit_cfg = vit_cfg
            self.net = DinoFeaturizer(
                vit_cfg, dim=self.dim, feat_type=cfg.dino_feat_type,
                projection_type=cfg.projection_type, use_dropout=cfg.dropout,
                backbone_dtype=backbone_dtype,
                use_flash_attention=cfg.use_flash_attention,
                generator=generator)
        else:
            raise ValueError(f"Unknown arch {cfg.arch}")
        self.linear_probe = nn.Conv2d(self.dim, n_classes, 1)
        init_conv1x1(self.linear_probe, generator)
        self.cluster_probe = ClusterLookup(
            self.dim, n_classes + cfg.extra_clusters, generator)
        self.train_cluster_probe = ClusterLookup(self.dim, n_classes,
                                                 generator)
        self.decoder = nn.Conv2d(self.dim, self.net.n_feats, 1)
        init_conv1x1(self.decoder, generator)
        self.world, self.rank = dist.world(), dist.rank()
        # local negatives: one derangement per rank's block of the global
        # batch (segmenter.py:105-113)
        self.corr_cfg = CorrLossCfg.from_config(
            cfg, neg_blocks=self.world if cfg.negatives_scope == "local"
            else 1)
        self.crf_cfg = CRFLossCfg.from_config(cfg)
        self.step = 0
        self.use_corr_kernel = True
        self._opts: Optional[Dict[str, torch.optim.Adam]] = None
        dist.broadcast_module(self)

    def make_optimizers(self) -> Dict[str, torch.optim.Adam]:
        """Fresh Adams (reference configure_optimizers,
        train_segmentation.py:373-383): ``net`` over the head, plus the
        decoder when the reconstruction loss is on, at ``cfg.lr``; the
        probes at 5e-3."""
        net = list(self.net.head_parameters())
        if self.cfg.rec_weight > 0:
            net += list(self.decoder.parameters())
        return {
            "net": torch.optim.Adam(net, lr=self.cfg.lr),
            "linear": torch.optim.Adam(self.linear_probe.parameters(),
                                       lr=PROBE_LR),
            "cluster": torch.optim.Adam(self.cluster_probe.parameters(),
                                        lr=PROBE_LR),
        }

    def optimizers(self) -> Dict[str, torch.optim.Adam]:
        """The segmenter's optimizers, made on first use (after the modules
        have moved to their device)."""
        if self._opts is None:
            self._opts = self.make_optimizers()
        return self._opts

    def reset_probes(self, generator: torch.Generator) -> None:
        """reset_probe_steps (train_segmentation.py:232-237): fresh probe
        weights from ``generator`` and fresh probe optimizers."""
        init_conv1x1(self.linear_probe, generator)
        self.cluster_probe.reset_parameters(generator)
        fresh = self.make_optimizers()
        opts = self.optimizers()
        opts["linear"], opts["cluster"] = fresh["linear"], fresh["cluster"]


def resolve_corr_sampling(seg: UnsupervisedSegmenter) -> str:
    """The correlation loss's sampler (``segmenter.py:240-272``): "fused"
    (kernel C1) needs the fused loss, sampled (not full-field) mode, a
    correspondence loss and no ``pallas_loss_bf16``; "auto" takes it
    whenever those hold, on any device of the port, and, over several
    processes, with local negatives (C1 reads its negatives inside a rank's
    batch). Otherwise "gather": bilinear sampling, then the streamed kernel
    C2. Full-field mode samples nothing."""
    cfg = seg.cfg
    fused_ok = (cfg.use_pallas_loss and not cfg.full_field_loss
                and cfg.correspondence_weight > 0
                and not cfg.pallas_loss_bf16
                and (seg.world == 1 or cfg.negatives_scope == "local"))
    if cfg.fused_sampling == "on":
        if not fused_ok:
            raise ValueError(
                "fused_sampling='on' needs use_pallas_loss, sampled (not "
                "full_field) correspondence loss, no pallas_loss_bf16, and "
                "negatives_scope='local' over several processes")
        return "fused"
    if cfg.fused_sampling == "auto" and fused_ok:
        return "fused"
    return "gather"


def draw_step_randomness(seg: UnsupervisedSegmenter, batch_size: int,
                         generator: torch.Generator
                         ) -> Dict[str, Any]:
    """Every random input of one train step, on the generator's device:

    * ``head1_keep1``/``head1_keep2`` (and ``head2_*`` for the positive
      image): the (B, 1, 1, n_feats) bool dropout keep-masks of the head's
      two branches; training always drops out the head's input
      (``featurizer.py:152-162``);
    * ``feat1_keep``/``feat2_keep``: the masks of the loss signal, when
      ``cfg.dropout`` (``net.use_dropout``);
    * ``coords1``/``coords2``: (B, S, S, 2) sample points, U(-1, 1);
    * ``salience_u1``/``salience_u2`` (B, S*S) and ``salience_mix1``/
      ``salience_mix2`` (B, S, S), U(0, 1), with ``use_salience``: the
      mask's points and the 90/10 choice between them and ``coords*``
      (``ops/correlation.py:salience_coords``);
    * ``perms``: ``neg_samples`` batch near-derangements (int64);
    * ``head3_keep1``/``head3_keep2``: the augmented view's head masks,
      with ``aug_alignment_weight > 0``; and, with ``device_augs``,
      ``aug_geom``/``aug_photo``, the augmentation's parameters at
      ``cfg.res`` (``ops/augment.py``);
    * ``crf_ys``/``crf_xs``: the CRF loss's ``crf_samples`` rows and
      columns of its 56 x 56 maps (int64), when ``crf_weight > 0``.

    The positive image's entries exist when the correspondence loss is on.
    ``batch_size`` is the global batch's: over several processes every rank
    draws the same values from the same seed, and the step takes its part
    (:func:`local_draws`).
    """
    cfg = seg.cfg
    dev = generator.device
    net = seg.net
    b = batch_size

    def keep():
        return torch.rand((b, 1, 1, net.n_feats), generator=generator,
                          device=dev) < 1.0 - net.dropout_p

    use_pos = cfg.correspondence_weight > 0
    images = ("1", "2") if use_pos else ("1",)
    out: Dict[str, Any] = {}
    for i in images:
        if net.projection_type is not None:
            out[f"head{i}_keep1"] = keep()
            out[f"head{i}_keep2"] = keep()
        if net.use_dropout:
            out[f"feat{i}_keep"] = keep()
    if use_pos:
        s = cfg.feature_samples
        for i in images:
            out[f"coords{i}"] = torch.rand(
                (b, s, s, 2), generator=generator, device=dev) * 2.0 - 1.0
            if cfg.use_salience:
                out[f"salience_u{i}"] = torch.rand(
                    (b, s * s), generator=generator, device=dev)
                out[f"salience_mix{i}"] = torch.rand(
                    (b, s, s), generator=generator, device=dev)
        out["perms"] = [block_local_super_perm(b, generator,
                                               seg.corr_cfg.neg_blocks)
                        for _ in range(cfg.neg_samples)]
    if cfg.aug_alignment_weight > 0:
        if net.projection_type is not None:
            out["head3_keep1"] = keep()
            out["head3_keep2"] = keep()
        if cfg.device_augs:
            out["aug_geom"] = augment.sample_geometric(generator, b, cfg.res,
                                                       cfg.res)
            out["aug_photo"] = augment.sample_photometric(generator, b)
    if cfg.crf_weight > 0:
        for axis in ("ys", "xs"):
            out[f"crf_{axis}"] = torch.randint(
                0, CRF_RES, (cfg.crf_samples,), generator=generator,
                device=dev)
    return out


PER_IMAGE_DRAWS = ("head1_keep1", "head1_keep2", "head2_keep1", "head2_keep2",
                   "feat1_keep", "feat2_keep", "coords1", "coords2",
                   "salience_u1", "salience_u2", "salience_mix1",
                   "salience_mix2", "head3_keep1", "head3_keep2", "aug_geom",
                   "aug_photo")


def local_draws(seg: UnsupervisedSegmenter, rand: Dict[str, Any],
                rows: slice) -> Dict[str, Any]:
    """This rank's part of a step's draws (the global batch's): its
    ``rows`` of the keep-masks and coordinates; under local negatives its
    block of each permutation, as indices into its own images. Global
    negatives keep the whole permutations, which index the gathered batch,
    and the CRF loss's rows and columns are every image's."""
    if seg.world == 1:
        return rand

    def part(v):
        return augment.take_rows(v, rows) if isinstance(v, tuple) \
            else v[rows]

    out = {k: (part(v) if k in PER_IMAGE_DRAWS else v)
           for k, v in rand.items()}
    if "perms" in rand and seg.cfg.negatives_scope == "local":
        out["perms"] = [p[rows] - rows.start for p in rand["perms"]]
    return out


def _cd_histogram(cd: torch.Tensor) -> torch.Tensor:
    """64 counts of cd over [-1, 1] (``segmenter.py:226-236``): values are
    clipped, so exact +-1 cosines land in the edge bins."""
    idx = torch.floor((torch.clamp(cd.reshape(-1), -1.0, 1.0) + 1.0) * 32.0)
    idx = torch.clamp(idx.long(), 0, HIST_BINS - 1)
    return torch.bincount(idx, minlength=HIST_BINS)


def _loss_coords(seg, batch, rand):
    """The loss's (coords1, coords2): the uniform draws, or, with
    ``use_salience`` and the batch's masks, the draws leaning towards the
    masks (``correlation.py:143-157``). Full-field mode samples nothing to
    bias and refuses masks (``pallas_corr.py:539-543``)."""
    coords = [rand["coords1"], rand["coords2"]]
    if not seg.cfg.use_salience:
        return coords
    for i, key in enumerate(("mask", "mask_pos")):
        mask = batch.get(key)
        if mask is None:
            continue
        if seg.cfg.full_field_loss:
            raise ValueError(
                "use_salience is incompatible with full_field_loss: the "
                "dense loss has no coordinate draw to bias (reference "
                "modules.py:355-364 applies salience to coordinate "
                "sampling).")
        coords[i] = salience_coords(mask, rand[f"salience_u{i + 1}"],
                                    coords[i], rand[f"salience_mix{i + 1}"])
    return coords


def _corr_pair_losses(seg, signal, signal_pos, code, code_pos, coords, rand,
                      with_hist: bool, sampling_impl: str):
    """The weighted correlation loss and its metrics
    (``segmenter.py:180-237``) at the sample points ``coords``; this
    rank's share of them over several processes."""
    cfg = seg.cfg
    corr_cfg, rows = seg.corr_cfg, None
    if seg.world > 1:
        if cfg.negatives_scope == "local":
            # each rank's own loss, one derangement block inside it
            corr_cfg = dataclasses.replace(corr_cfg, neg_blocks=1)
        elif cfg.use_pallas_loss or cfg.full_field_loss:
            # the global batch's maps, for the negatives; the code's
            # gradient from every rank's loss returns to its rank
            rows = dist.local_rows(code.shape[0] * seg.world)
            signal = dist.gather_rows(signal.detach())
            code = dist.gather_rows(code)
        else:
            raise ValueError(
                "use_pallas_loss=false (the einsum reference loss) takes "
                "global negatives on one process only; over several "
                "processes use the streamed loss (use_pallas_loss=true) or "
                "negatives_scope=local")
    args = (corr_cfg, signal, signal_pos, code, code_pos, *coords,
            rand["perms"])
    if cfg.use_pallas_loss or cfg.full_field_loss:
        out = contrastive_correlation_loss_fused(
            *args, full_field=cfg.full_field_loss,
            return_cd_tensors=with_hist and not cfg.full_field_loss,
            feat_dtype=(torch.bfloat16 if cfg.backbone_dtype == "bfloat16"
                        else torch.float32),
            code_bf16=cfg.pallas_loss_bf16, sampling_impl=sampling_impl,
            use_kernel=seg.use_corr_kernel, rows=rows)
    else:
        out = contrastive_correlation_loss(*args)
    corr_loss = (cfg.pos_inter_weight * out["pos_inter_loss"]
                 + cfg.pos_intra_weight * out["pos_intra_loss"]
                 + cfg.neg_inter_weight * out["neg_inter_loss"].mean()
                 ) * cfg.correspondence_weight
    metrics = {
        "loss/pos_intra": out["pos_intra_loss"],
        "loss/pos_inter": out["pos_inter_loss"],
        "loss/neg_inter": out["neg_inter_loss"].mean(),
        "cd/pos_intra": out["pos_intra_cd"].mean(),
        "cd/pos_inter": out["pos_inter_cd"].mean(),
        "cd/neg_inter": out["neg_inter_cd"].mean(),
    }
    if with_hist:
        for name in ("pos_intra", "pos_inter", "neg_inter"):
            cd = out[f"{name}_cd"]
            if cd.ndim > 0:
                metrics[f"hist/{name}"] = _cd_histogram(cd.detach())
    return corr_loss, metrics


def _update_from_feats(seg: UnsupervisedSegmenter, with_hist: bool,
                       image_feat: torch.Tensor,
                       image_feat_pos: Optional[torch.Tensor],
                       batch: Dict[str, torch.Tensor], rand: Dict[str, Any],
                       sampling_impl: str,
                       image_feat_aug: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """Everything after the frozen trunk (``segmenter.py:283-448``): head
    code, losses, gradients and the three Adam updates, in place on
    ``seg``. ``batch`` holds ``label`` and, as the losses need them,
    ``label_pos``, ``mask``/``mask_pos`` (``use_salience``), ``coord_aug``
    (with ``image_feat_aug``) and ``img`` (the CRF loss). Returns the
    step's metrics (detached tensors)."""
    cfg = seg.cfg
    net = seg.net
    label = batch["label"]
    use_pos = cfg.correspondence_weight > 0
    drop_signal = net.use_dropout
    metrics: Dict[str, torch.Tensor] = {}
    b = label.shape[0]
    rand = local_draws(seg, rand, slice(seg.rank * b, (seg.rank + 1) * b))

    code = net.head_code(image_feat, rand.get("head1_keep1"),
                         rand.get("head1_keep2"), train=True)
    feats = net.signal(image_feat)
    if drop_signal:
        feats = dropout2d(feats, net.dropout_p, rand["feat1_keep"])
    loss = torch.zeros((), device=code.device)

    if use_pos:
        code_pos = net.head_code(image_feat_pos, rand.get("head2_keep1"),
                                 rand.get("head2_keep2"), train=True)
        feats_pos = net.signal(image_feat_pos)
        if drop_signal:
            feats_pos = dropout2d(feats_pos, net.dropout_p,
                                  rand["feat2_keep"])
        if cfg.use_true_labels:
            signal = one_hot_feats(label + 1, seg.n_classes + 1)
            signal_pos = one_hot_feats(batch["label_pos"] + 1,
                                       seg.n_classes + 1)
        else:
            signal, signal_pos = feats, feats_pos
        corr_loss, corr_metrics = _corr_pair_losses(
            seg, signal, signal_pos, code, code_pos,
            _loss_coords(seg, batch, rand), rand, with_hist, sampling_impl)
        loss = loss + corr_loss
        metrics.update(corr_metrics)

    if cfg.rec_weight > 0:
        rec_feats = decoder_apply(seg.decoder, code)
        rec_loss = -torch.mean(torch.sum(
            l2_normalize(rec_feats) * l2_normalize(feats), dim=-1))
        loss = loss + cfg.rec_weight * rec_loss
        metrics["loss/rec"] = rec_loss

    if image_feat_aug is not None:
        code_aug = net.head_code(image_feat_aug, rand.get("head3_keep1"),
                                 rand.get("head3_keep2"), train=True)
        coord_small = interpolate(batch["coord_aug"], code_aug.shape[1:3],
                                  "bilinear", align_corners=False)
        # the reference's sample() transposes the grid, and the dataset's
        # grid is (y, x): the two swaps cancel on square inputs
        # (train_segmentation.py:189-198, data.py:530-532)
        resampled = sample_from_coords(code, coord_small)
        aug_alignment = -torch.mean(torch.sum(
            l2_normalize(resampled) * l2_normalize(code_aug), dim=-1))
        loss = loss + cfg.aug_alignment_weight * aug_alignment
        metrics["loss/aug_alignment"] = aug_alignment

    if cfg.crf_weight > 0:
        crf = torch.mean(contrastive_crf_loss(
            seg.crf_cfg,
            interpolate(batch["img"], CRF_RES, "bilinear",
                        align_corners=False),
            l2_normalize(interpolate(code, CRF_RES, "bilinear",
                                     align_corners=False)),
            (rand["crf_ys"], rand["crf_xs"])))
        loss = loss + cfg.crf_weight * crf
        metrics["loss/crf"] = crf

    detached_code = code.detach()
    linear_logits = linear_probe_logits(seg.linear_probe, detached_code)
    ce_dtype = (torch.bfloat16 if cfg.backbone_dtype == "bfloat16"
                else torch.float32)
    linear_loss = upsampled_masked_cross_entropy(
        linear_logits, label, seg.n_classes, compute_dtype=ce_dtype)
    loss = loss + linear_loss
    metrics["loss/linear"] = linear_loss
    cluster_loss, _ = cluster_lookup(seg.cluster_probe.clusters,
                                     detached_code, alpha=None)
    loss = loss + cluster_loss
    metrics["loss/cluster"] = cluster_loss
    metrics["loss/total"] = loss

    opts = seg.optimizers()
    for opt in opts.values():
        opt.zero_grad(set_to_none=True)
    loss.backward()
    params = [p for opt in opts.values() for group in opt.param_groups
              for p in group["params"]]
    for p in params:
        # a parameter the loss does not reach steps with a zero gradient,
        # as under optax (its moments decay and its step count advances);
        # on every rank, before the ranks' gradients are averaged
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    scalars = dist.average_grads(params, {
        k: v.detach() for k, v in metrics.items()
        if not k.startswith("hist/")})
    for opt in opts.values():
        opt.step()
    if cfg.arch == "feature-pyramid":
        # the FPN's BatchNorm running statistics, from the image's batch
        # statistics under the updated head (segmenter.py:436-441)
        net.bn_state_update(image_feat)
    seg.step += 1
    return {**scalars, **{k: dist.all_reduce_(v) for k, v in metrics.items()
                          if k.startswith("hist/")}}


def make_train_step(seg: UnsupervisedSegmenter, with_hist: bool = True):
    """The train step ``step(batch, rand) -> metrics``, updating ``seg`` and
    its optimizers in place (``segmenter.py:451-523``).

    ``batch``: NHWC ``img`` and ``img_pos`` (the KNN positive; needed when
    the correspondence loss is on), (B, H, W) int ``label`` (and
    ``label_pos`` with ``use_true_labels``), (B, H, W) ``mask`` and
    ``mask_pos`` with ``use_salience``, and with the aug-alignment loss
    either ``img_aug`` and ``coord_aug`` (the host route) or, under
    ``device_augs``, neither (the step augments ``img`` by ``rand``'s
    parameters, as ``segmenter.py:477-485``). ``rand``: the step's draws,
    :func:`draw_step_randomness`. The trunk runs once over img ‖ img_pos
    ‖ img_aug.

    ``with_hist=False`` skips the cd histograms and the plainly sampled cd
    tensors they need; the state it leaves is the hist variant's.
    """
    cfg = seg.cfg
    sampling_impl = resolve_corr_sampling(seg)
    use_pos = cfg.correspondence_weight > 0
    use_aug = cfg.aug_alignment_weight > 0
    deterministic_convolutions_for(cfg.arch)

    def train_step(batch: Dict[str, torch.Tensor],
                   rand: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        img = batch["img"]
        bsz = img.shape[0]
        parts = [img]
        if use_pos:
            parts.append(batch["img_pos"])
        if use_aug:
            if cfg.device_augs and "img_aug" not in batch:
                if tuple(img.shape[1:3]) != (cfg.res, cfg.res):
                    raise ValueError(
                        f"device_augs: the augmentation's parameters are "
                        f"drawn for res {cfg.res} images; the batch's are "
                        f"{tuple(img.shape[1:3])}")
                b0 = seg.rank * bsz
                mine = local_draws(seg, rand, slice(b0, b0 + bsz))
                img_aug, coord_aug = augment.device_augment(
                    img, mine["aug_geom"], mine["aug_photo"])
                batch = dict(batch, coord_aug=coord_aug)
            else:
                img_aug = batch["img_aug"]
            parts.append(img_aug.to(img.dtype))
        chunks = split_rows(seg.net.backbone_features(
            torch.cat(parts) if len(parts) > 1 else img), bsz)
        return _update_from_feats(
            seg, with_hist, chunks[0], chunks[1] if use_pos else None,
            batch, rand, sampling_impl,
            image_feat_aug=chunks[-1] if use_aug else None)

    return train_step


def split_rows(feats: Any, size: int) -> list:
    """The trunk's features (a tensor, or the FPN's dict of taps) in
    chunks of ``size`` images."""
    if isinstance(feats, dict):
        parts = {k: v.split(size) for k, v in feats.items()}
        return [dict(zip(parts, vs)) for vs in zip(*parts.values())]
    return list(feats.split(size))


def _index(ind: Any, device: torch.device) -> torch.Tensor:
    """An index batch (tensor, array or list) as int64 on ``device``."""
    return torch.as_tensor(ind).to(device=device, dtype=torch.long)


def cache_rows(seg: UnsupervisedSegmenter, t: torch.Tensor,
               ind: torch.Tensor) -> torch.Tensor:
    """Rows ``ind`` of a feature-cache tensor: ``index_select`` of the
    whole table on every rank (negative indices read row 0), or, with
    ``feat_cache_sharded``, ``parallel/dist.py:row_take`` of the rank's
    block (negative indices read zeros)."""
    if seg.cfg.feat_cache_sharded:
        return dist.row_take(t, ind)
    return t.index_select(0, torch.clamp_min(ind, 0))


def make_cached_train_step(seg: UnsupervisedSegmenter,
                           with_hist: bool = True):
    """The train step over a feature cache (``segmenter.py:526-588``):
    ``step(cache, batch, rand) -> metrics``, updating ``seg`` and its
    optimizers in place.

    ``cache``: :func:`~stego_torch.train.feat_cache.build_feat_cache`'s
    dict. ``batch``: int ``ind`` (B,) (and ``ind_pos`` (B,), the KNN
    positives, when the correspondence loss is on; both as
    :class:`~stego_torch.train.feat_cache.FeatCacheSampler` draws them).
    ``rand``: :func:`draw_step_randomness`'s draws. The step gathers the
    features (as f32), labels and, with ``use_salience``, the masks (as
    f32) by index (:func:`cache_rows`) and goes through the image step's
    ``_update_from_feats``, so on the same images and draws it is the
    image step. The aug-alignment loss needs each step's augmented view
    through the trunk, which the cache cannot give, and raises as the
    cache's build does. ``steps_per_dispatch > 1``
    (``make_cached_multi_step``) is the TPU's workaround for its dispatch
    latency (ROADMAP.md queue 1, Do not port these TPU workarounds) and
    raises."""
    cfg = seg.cfg
    if cfg.aug_alignment_weight > 0:
        raise ValueError(
            "cache_backbone_feats is incompatible with aug_alignment_weight>0:"
            " the augmented view must pass through the backbone every step")
    if cfg.crf_weight > 0:
        raise ValueError(
            "crf_weight > 0 needs each step's images, which the feature "
            "cache does not hold (the JAX package's cache refuses it too, "
            "feat_cache.py:53-56); train from images, or set crf_weight=0")
    if cfg.steps_per_dispatch > 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 (make_cached_multi_step) is not ported: "
            "it is the TPU's workaround for its dispatch latency (ROADMAP.md "
            "queue 1, Do not port these TPU workarounds); a CUDA graph of the "
            "step is the GPU's lever")
    sampling_impl = resolve_corr_sampling(seg)
    use_pos = cfg.correspondence_weight > 0

    def train_step(cache: Dict[str, torch.Tensor],
                   batch: Dict[str, Any],
                   rand: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        dev = cache["feats"].device
        ind = _index(batch["ind"], dev)
        image_feat = cache_rows(seg, cache["feats"], ind).float()
        sub = {"label": cache_rows(seg, cache["label"], ind).to(torch.int32)}
        image_feat_pos = None
        if use_pos:
            ind_pos = _index(batch["ind_pos"], dev)
            image_feat_pos = cache_rows(seg, cache["feats"], ind_pos).float()
            sub["label_pos"] = cache_rows(seg, cache["label"],
                                          ind_pos).to(torch.int32)
            if cfg.use_salience:
                sub["mask"] = cache_rows(seg, cache["mask"], ind).float()
                sub["mask_pos"] = cache_rows(seg, cache["mask"],
                                             ind_pos).float()
        return _update_from_feats(seg, with_hist, image_feat, image_feat_pos,
                                  sub, rand, sampling_impl)

    return train_step


def _val_outputs(seg: UnsupervisedSegmenter, code: torch.Tensor,
                 label: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Probe predictions at label resolution and the two confusion
    matrices of a val step (``segmenter.py:741-769``)."""
    nc = seg.n_classes
    extra = seg.cfg.extra_clusters
    hw = tuple(label.shape[1:3])
    linear_preds = upsampled_argmax(
        linear_probe_logits(seg.linear_probe, code), hw)
    clusters = l2_normalize(seg.cluster_probe.clusters, dim=1)
    cluster_preds = upsampled_argmax(code @ clusters.T, hw)
    dev = label.device
    return {
        "conf_linear": update_conf_matrix(
            torch.zeros((nc, nc), dtype=torch.long, device=dev),
            linear_preds, label, nc, 0),
        "conf_cluster": update_conf_matrix(
            torch.zeros((nc + extra, nc), dtype=torch.long, device=dev),
            cluster_preds, label, nc, extra),
        "linear_preds": linear_preds,
        "cluster_preds": cluster_preds,
    }


def make_cached_val_step(seg: UnsupervisedSegmenter):
    """The val step over a feature cache built at ``val_res``
    (``segmenter.py:637-694``): ``step(cache, batch)`` with int ``ind``
    (B,) gives :func:`make_val_step`'s outputs. Entries ``ind = -1`` pad a
    short final batch: their labels are the ignore label, so the confusion
    matrices never count them."""

    @torch.no_grad()
    def val_step(cache: Dict[str, torch.Tensor],
                 batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        ind = _index(batch["ind"], cache["feats"].device)
        label = cache_rows(seg, cache["label"], ind).to(torch.int32)
        label = torch.where((ind >= 0)[:, None, None], label,
                            torch.full((), -1, dtype=label.dtype,
                                       device=label.device))
        code = seg.net.head_code(cache_rows(seg, cache["feats"], ind).float())
        return _val_outputs(seg, code, label)

    return val_step


def make_cached_val_epoch(seg: UnsupervisedSegmenter):
    """A whole cached val epoch (``segmenter.py:697-722``):
    ``epoch(cache, inds)`` over the (n_batches, B) index batches ``inds``
    (``-1`` pads the last) gives the summed ``conf_linear`` and
    ``conf_cluster``, added up on the device."""
    single = make_cached_val_step(seg)
    nc = seg.n_classes
    extra = seg.cfg.extra_clusters

    def val_epoch(cache: Dict[str, torch.Tensor],
                  inds: Any) -> Dict[str, torch.Tensor]:
        dev = cache["feats"].device
        conf = {"conf_linear": torch.zeros((nc, nc), dtype=torch.long,
                                           device=dev),
                "conf_cluster": torch.zeros((nc + extra, nc),
                                            dtype=torch.long, device=dev)}
        for ind in inds:
            out = single(cache, {"ind": ind})
            for k in conf:
                conf[k] += out[k]
        return conf

    return val_epoch


def make_val_step(seg: UnsupervisedSegmenter):
    """Validation step ``step(batch) -> dict`` (``segmenter.py:725-769``):
    probe argmax predictions at label resolution and the two confusion
    matrices, (n, n) linear and (n + extra, n) cluster, int64, indexed
    [prediction, label]."""

    @torch.no_grad()
    def val_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        _, code = seg.net(batch["img"])
        return _val_outputs(seg, code, batch["label"])

    return val_step
