"""UnsupervisedSegmenter and its train and val steps; counterpart of
``stego_tpu/train/segmenter.py``.

Submodule names are the Lightning module's (``net``, ``linear_probe``,
``cluster_probe``, ``train_cluster_probe``, ``decoder``), so ``state_dict()``
keys equal those of a STEGO ``.ckpt`` (``models/convert.py``).

The train step (:func:`make_train_step`) runs the frozen trunk once over
img ‖ img_pos, the head, the contrastive correlation loss, the probe losses
on the detached code and three Adam updates. The loss runs through kernel
C1 when the fused conditions hold (:func:`resolve_corr_sampling`), and
through the streamed kernel C2 otherwise: full-field (``full_field_loss``),
or bilinearly sampled first (``fused_sampling="off"``,
``pallas_loss_bf16``). Every random input of the step
(dropout keep-masks, sample coordinates, negative permutations) is an
argument: :func:`draw_step_randomness` draws them from a
``torch.Generator``; the tests hand in the JAX package's draws instead,
since ``jax.random`` streams cannot be reproduced in torch.

Not ported yet (ROADMAP.md queue 1, item 4): the aug-alignment loss
(``aug_alignment_weight > 0``, needs ``ops/augment.py``), the CRF loss
(``crf_weight > 0``), the salience-biased draw (``use_salience``) and the
feature-pyramid arch. Each raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from stego_torch.config import Config
from stego_torch.models.featurizer import DinoFeaturizer, dropout2d
from stego_torch.models.probes import (ClusterLookup, cluster_lookup,
                                       decoder_apply, init_conv1x1,
                                       linear_probe_logits)
from stego_torch.models.vit import VIT_CONFIGS, ViTConfig
from stego_torch.ops.corr_stream import contrastive_correlation_loss_fused
from stego_torch.ops.correlation import (CorrLossCfg,
                                         contrastive_correlation_loss,
                                         salience_not_ported)
from stego_torch.ops.math import (block_local_super_perm, l2_normalize,
                                  one_hot_feats)
from stego_torch.ops.probe_ce import (upsampled_argmax,
                                      upsampled_masked_cross_entropy)
from stego_torch.utils.metrics import update_conf_matrix

PROBE_LR = 5e-3  # linear and cluster probes (train_segmentation.py:379-381)
HIST_BINS = 64


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         n_classes: int) -> torch.Tensor:
    """Pixel CE of (..., C) logits over ``0 <= label < n_classes``
    (reference train_segmentation.py:210-218)."""
    mask = (labels >= 0) & (labels < n_classes)
    safe = torch.clamp(labels, 0, n_classes - 1).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, nll, torch.zeros((), device=nll.device))
    return nll.sum() / torch.clamp_min(mask.sum(), 1)


class UnsupervisedSegmenter(nn.Module):
    """Featurizer ``net`` + ``linear_probe`` (1x1 conv) + ``cluster_probe``,
    and the training-only ``train_cluster_probe`` and ``decoder``.
    ``generator`` seeds every random init. ``step`` counts train steps.
    ``use_corr_kernel = False`` makes the loss call the plain version of its
    kernel (C1 or C2) even on a CUDA tensor (as ``net.model.use_kernels``
    does for the trunk's kernels), to hold the step against it on the
    card."""

    def __init__(self, n_classes: int, cfg: Config,
                 vit_cfg: Optional[ViTConfig] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.arch != "dino":
            raise NotImplementedError(
                f"arch {cfg.arch!r} is not ported yet (ROADMAP.md queue 1, "
                f"item 12)")
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        self.cfg = cfg
        self.n_classes = n_classes
        self.dim = cfg.dim if cfg.continuous else n_classes
        if vit_cfg is None:
            vit_cfg = VIT_CONFIGS[cfg.model_type][cfg.dino_patch_size]
        if cfg.potsdam_ir:
            vit_cfg = dataclasses.replace(vit_cfg, in_chans=4)
        self.vit_cfg = vit_cfg
        self.net = DinoFeaturizer(
            vit_cfg, dim=self.dim, feat_type=cfg.dino_feat_type,
            projection_type=cfg.projection_type, use_dropout=cfg.dropout,
            backbone_dtype=(torch.bfloat16 if cfg.backbone_dtype == "bfloat16"
                            else torch.float32),
            use_flash_attention=cfg.use_flash_attention, generator=generator)
        self.linear_probe = nn.Conv2d(self.dim, n_classes, 1)
        init_conv1x1(self.linear_probe, generator)
        self.cluster_probe = ClusterLookup(
            self.dim, n_classes + cfg.extra_clusters, generator)
        self.train_cluster_probe = ClusterLookup(self.dim, n_classes,
                                                 generator)
        self.decoder = nn.Conv2d(self.dim, self.net.n_feats, 1)
        init_conv1x1(self.decoder, generator)
        self.corr_cfg = CorrLossCfg.from_config(cfg)
        self.step = 0
        self.use_corr_kernel = True
        self._opts: Optional[Dict[str, torch.optim.Adam]] = None

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
    whenever those hold, on any device of the port (one device, so the
    mesh condition always holds). Otherwise "gather": bilinear sampling,
    then the streamed kernel C2. Full-field mode samples nothing."""
    cfg = seg.cfg
    fused_ok = (cfg.use_pallas_loss and not cfg.full_field_loss
                and cfg.correspondence_weight > 0
                and not cfg.pallas_loss_bf16)
    if cfg.fused_sampling == "on":
        if not fused_ok:
            raise ValueError(
                "fused_sampling='on' needs use_pallas_loss, sampled (not "
                "full_field) correspondence loss and no pallas_loss_bf16")
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
    * ``perms``: ``neg_samples`` batch near-derangements (int64).

    The positive image's entries exist when the correspondence loss is on.
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
        out["perms"] = [block_local_super_perm(b, generator,
                                               seg.corr_cfg.neg_blocks)
                        for _ in range(cfg.neg_samples)]
    return out


def _cd_histogram(cd: torch.Tensor) -> torch.Tensor:
    """64 counts of cd over [-1, 1] (``segmenter.py:226-236``): values are
    clipped, so exact +-1 cosines land in the edge bins."""
    idx = torch.floor((torch.clamp(cd.reshape(-1), -1.0, 1.0) + 1.0) * 32.0)
    idx = torch.clamp(idx.long(), 0, HIST_BINS - 1)
    return torch.bincount(idx, minlength=HIST_BINS)


def _corr_pair_losses(seg, signal, signal_pos, code, code_pos, rand,
                      with_hist: bool, sampling_impl: str):
    """The weighted correlation loss and its metrics
    (``segmenter.py:180-237``)."""
    cfg = seg.cfg
    args = (seg.corr_cfg, signal, signal_pos, code, code_pos,
            rand["coords1"], rand["coords2"], rand["perms"])
    if cfg.use_pallas_loss or cfg.full_field_loss:
        out = contrastive_correlation_loss_fused(
            *args, full_field=cfg.full_field_loss,
            return_cd_tensors=with_hist and not cfg.full_field_loss,
            feat_dtype=(torch.bfloat16 if cfg.backbone_dtype == "bfloat16"
                        else torch.float32),
            code_bf16=cfg.pallas_loss_bf16, sampling_impl=sampling_impl,
            use_kernel=seg.use_corr_kernel)
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


def _check_ported(cfg: Config) -> None:
    if cfg.use_salience:
        raise salience_not_ported()
    if cfg.aug_alignment_weight > 0:
        raise NotImplementedError(
            "aug_alignment_weight > 0: the augmented view (ops/augment.py) "
            "and the aug-alignment loss are not ported yet (ROADMAP.md "
            "queue 1, item 4)")
    if cfg.crf_weight > 0:
        raise NotImplementedError(
            "crf_weight > 0: the CRF loss (ops/crf_loss.py) is not ported "
            "yet (ROADMAP.md queue 1, item 4)")


def _update_from_feats(seg: UnsupervisedSegmenter, with_hist: bool,
                       image_feat: torch.Tensor,
                       image_feat_pos: Optional[torch.Tensor],
                       batch: Dict[str, torch.Tensor], rand: Dict[str, Any],
                       sampling_impl: str) -> Dict[str, torch.Tensor]:
    """Everything after the frozen trunk (``segmenter.py:283-448``): head
    code, losses, gradients and the three Adam updates, in place on
    ``seg``. Returns the step's metrics (detached tensors)."""
    cfg = seg.cfg
    net = seg.net
    label = batch["label"]
    use_pos = cfg.correspondence_weight > 0
    drop_signal = net.use_dropout
    metrics: Dict[str, torch.Tensor] = {}

    code = net.head_code(image_feat, rand.get("head1_keep1"),
                         rand.get("head1_keep2"))
    feats = net.signal(image_feat)
    if drop_signal:
        feats = dropout2d(feats, net.dropout_p, rand["feat1_keep"])
    loss = torch.zeros((), device=code.device)

    if use_pos:
        code_pos = net.head_code(image_feat_pos, rand.get("head2_keep1"),
                                 rand.get("head2_keep2"))
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
            seg, signal, signal_pos, code, code_pos, rand, with_hist,
            sampling_impl)
        loss = loss + corr_loss
        metrics.update(corr_metrics)

    if cfg.rec_weight > 0:
        rec_feats = decoder_apply(seg.decoder, code)
        rec_loss = -torch.mean(torch.sum(
            l2_normalize(rec_feats) * l2_normalize(feats), dim=-1))
        loss = loss + cfg.rec_weight * rec_loss
        metrics["loss/rec"] = rec_loss

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
    for opt in opts.values():
        # a parameter the loss does not reach steps with a zero gradient,
        # as under optax (its moments decay and its step count advances)
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
    seg.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(seg: UnsupervisedSegmenter, with_hist: bool = True):
    """The train step ``step(batch, rand) -> metrics``, updating ``seg`` and
    its optimizers in place (``segmenter.py:451-523``).

    ``batch``: NHWC ``img`` and ``img_pos`` (the KNN positive; needed when
    the correspondence loss is on), (B, H, W) int ``label`` (and
    ``label_pos`` with ``use_true_labels``). ``rand``: the step's draws,
    :func:`draw_step_randomness`. The trunk runs once over img ‖ img_pos.

    ``with_hist=False`` skips the cd histograms and the plainly sampled cd
    tensors they need; the state it leaves is the hist variant's.
    """
    cfg = seg.cfg
    _check_ported(cfg)
    sampling_impl = resolve_corr_sampling(seg)
    use_pos = cfg.correspondence_weight > 0

    def train_step(batch: Dict[str, torch.Tensor],
                   rand: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        img = batch["img"]
        bsz = img.shape[0]
        if use_pos:
            feat_all = seg.net.backbone_features(
                torch.cat([img, batch["img_pos"]]))
            image_feat, image_feat_pos = feat_all[:bsz], feat_all[bsz:]
        else:
            image_feat, image_feat_pos = seg.net.backbone_features(img), None
        return _update_from_feats(seg, with_hist, image_feat, image_feat_pos,
                                  batch, rand, sampling_impl)

    return train_step


def make_val_step(seg: UnsupervisedSegmenter):
    """Validation step ``step(batch) -> dict`` (``segmenter.py:725-769``):
    probe argmax predictions at label resolution and the two confusion
    matrices, (n, n) linear and (n + extra, n) cluster, int64, indexed
    [prediction, label]."""
    nc = seg.n_classes
    extra = seg.cfg.extra_clusters

    @torch.no_grad()
    def val_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        img, label = batch["img"], batch["label"]
        _, code = seg.net(img)
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

    return val_step
