"""Checkpoint evaluation: flip-TTA, probes, the CRF and Hungarian metrics;
counterpart of ``stego_tpu/eval/evaluate.py``.

    python -m stego_torch.eval model_path=<.ckpt> [run_crf=true]
        [crf_backend=grid|exact] [res=320] [batch_size=8]

Behavioral reference: src/eval_segmentation.py. The grid CRF
(``ops/crf.py``) runs batched on the card; the exact CRF
(``ops/crf_exact.py``, ``crf_backend=exact``) runs on the host's threads
from the step's log-probs. Without the exact CRF the confusion matrices are
added up on the device and fetched once. ``main`` runs on the card and
exits with an error when there is none; a caller of :func:`evaluate` or
:class:`Evaluator` asks for the CPU by passing a CPU device.

Over several processes (``num_devices``, or ``python -m
torch.distributed.run``; ``parallel/dist.py``) each rank evaluates its
stripe of the set, in batches of its share of ``2 * batch_size``, and the
confusion matrices are summed over the ranks (``evaluate.py:196-230``):
a tail of fewer than W images is dropped, so W ranks evaluate the first
W * floor(n / W) images. Rank 0 writes the kept images of its stripe. The
exact CRF runs on the host of one process and raises there.

Not ported: the PiCIE baseline rows (``run_picie``, ROADMAP.md queue 1,
Other backbones, plots and apps), which raise.
The JAX package's wire compaction is a TPU workaround and has no
counterpart (ROADMAP.md queue 1, Do not port these TPU workarounds).
"""

from __future__ import annotations

import os
import time
from os.path import join
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from stego_torch.config import Config
from stego_torch.data.loader import DataLoader, effective_threads, pad_batch
from stego_torch.data.transforms import channel_stats, get_transform
from stego_torch.models.convert import load_stego_checkpoint
from stego_torch.models.probes import cluster_lookup, linear_probe_logits
from stego_torch.models.vit import ViTConfig
from stego_torch.ops.crf import bilateral_kernel, dense_crf
from stego_torch.ops.interp import interpolate
from stego_torch.parallel import dist
from stego_torch.ops.math import l2_normalize
from stego_torch.ops.probe_ce import upsampled_argmax
from stego_torch.train.segmenter import UnsupervisedSegmenter
from stego_torch.utils.metrics import UnsupervisedMetrics, update_conf_matrix
from stego_torch.utils.precision import full_f32_for


def load_model_for_eval(model_path: str,
                        device: Union[str, torch.device],
                        vit_cfg: Optional[ViTConfig] = None
                        ) -> UnsupervisedSegmenter:
    """Load a STEGO Lightning ``.ckpt`` onto ``device`` in eval mode; a bf16
    backbone stores its block weights in bf16 (same results, no cast per
    call, as ``evaluate.py:203-208``), an f32 one turns TF32 off for the
    process (``utils/precision.py``)."""
    if not model_path.endswith(".ckpt"):
        raise ValueError(
            f"{model_path}: stego_torch reads Lightning .ckpt files; export "
            f"a JAX orbax checkpoint with "
            f"stego_tpu.models.export.export_stego_checkpoint")
    seg = load_stego_checkpoint(model_path, vit_cfg=vit_cfg)
    full_f32_for(seg.cfg.backbone_dtype)
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
                   return_probs: bool = False, with_conf: bool = False):
    """Eval step ``step(img, label)`` for NHWC images
    (``evaluate.py:84-169``); ``label`` gives the output size by its
    (B, H, W) shape.

    * default: (linear_preds, cluster_preds), (B, H, W) int32, argmax of
      the probes' upsampled logits;
    * ``run_crf``: the same argmax after the grid CRF (``ops/crf.py``) of
      each probe's log-probs over the image, which share one bilateral
      kernel;
    * ``return_probs``: (linear log-probs, cluster log-probs, RGB in
      [0, 1]) at label resolution, for the host's exact CRF; no CRF;
    * ``with_conf``: the predictions followed by the linear (n, n) and
      cluster (n + extra, n) int64 confusion matrices of the batch against
      ``label`` (-1 is ignored), counted on the predictions' device.
    """
    nc = seg.n_classes
    extra = seg.cfg.extra_clusters

    def _confs(linear_preds, cluster_preds, label):
        dev = linear_preds.device
        label = label.to(dev)
        return (
            update_conf_matrix(torch.zeros((nc, nc), dtype=torch.long,
                                           device=dev),
                               linear_preds, label, nc, 0),
            update_conf_matrix(torch.zeros((nc + extra, nc),
                                           dtype=torch.long, device=dev),
                               cluster_preds, label, nc, extra),
        )

    @torch.inference_mode()
    def eval_step(img: torch.Tensor, label: torch.Tensor):
        hw = tuple(label.shape[1:3])
        code = flip_tta_code(seg, img)
        if not run_crf and not return_probs:
            # argmax on code-res logits, upsampled channel-major: the same
            # predictions as interpolate-then-probe (see upsampled_argmax)
            clusters = l2_normalize(seg.cluster_probe.clusters, dim=1)
            linear_preds = upsampled_argmax(
                linear_probe_logits(seg.linear_probe, code), hw)
            cluster_preds = upsampled_argmax(code @ clusters.T, hw)
        else:
            code = interpolate(code, hw, "bilinear", align_corners=False)
            linear_probs = torch.log_softmax(
                linear_probe_logits(seg.linear_probe, code), dim=-1)
            cluster_probs = cluster_lookup(seg.cluster_probe.clusters, code,
                                           alpha=2.0, log_probs=True)
            # unnormalized RGB for the CRF's guidance (4-channel potsdam_ir
            # inputs give their RGB slice; the bilateral kernel is RGB)
            mean, std = (torch.as_tensor(s, device=img.device)
                         for s in channel_stats(img.shape[-1]))
            img01 = torch.clamp(img * std + mean, 0.0, 1.0)[..., :3]
            if return_probs:
                return linear_probs, cluster_probs, img01
            kern = bilateral_kernel(img01)
            linear_preds = torch.argmax(
                dense_crf(img01, linear_probs, kern=kern), dim=-1).int()
            cluster_preds = torch.argmax(
                dense_crf(img01, cluster_probs, kern=kern), dim=-1).int()
        if with_conf:
            return (linear_preds, cluster_preds,
                    *_confs(linear_preds, cluster_preds, label))
        return linear_preds, cluster_preds

    return eval_step


class Evaluator:
    """One evaluation of a checkpoint over a dataset (:func:`evaluate` is
    ``Evaluator(...).run(...)``; reference my_app loop,
    eval_segmentation.py:57-214).

    The constructor loads the ``.ckpt`` onto ``device`` (default
    ``cuda:LOCAL_RANK``), builds the val dataset unless one is given (centre
    crops at ``eval_cfg.res``), the loader (batches of ``2 * batch_size``,
    as the reference's eval loader, split over the ranks) and the step.
    After each :meth:`run`, ``linear_metrics`` and ``cluster_metrics`` hold
    its summed confusion matrices (``.stats``, summed over the ranks) and
    ``crf_seconds`` the host's seconds of the exact CRF for each batch."""

    def __init__(self, eval_cfg: Config, model_path: str,
                 device: Optional[Union[str, torch.device]] = None,
                 vit_cfg: Optional[ViTConfig] = None, val_dataset=None):
        from stego_torch.data.contrastive import ContrastiveSegDataset

        w = dist.world()
        if eval_cfg.num_devices > 0 and eval_cfg.num_devices != w:
            raise ValueError(
                f"num_devices={eval_cfg.num_devices} asks for "
                f"{eval_cfg.num_devices} processes and this is one of {w}: "
                f"start them with python -m stego_torch.eval (or python -m "
                f"torch.distributed.run), or set num_devices=0")
        self.cfg = eval_cfg
        self.model_path = model_path
        self.device = dist.device() if device is None \
            else torch.device(device)
        self.seg = load_model_for_eval(model_path, self.device,
                                       vit_cfg=vit_cfg)
        model_cfg = self.seg.cfg
        if eval_cfg.run_picie and model_cfg.dataset_name == "cocostuff27":
            raise NotImplementedError(
                "run_picie=true: the PiCIE baseline is not ported yet "
                "(ROADMAP.md queue 1, Other backbones, plots and apps)")
        if val_dataset is None:
            val_dataset = ContrastiveSegDataset(
                pytorch_data_dir=eval_cfg.pytorch_data_dir,
                dataset_name=model_cfg.dataset_name,
                crop_type=None,
                image_set="val",
                transform=get_transform(eval_cfg.res, False, "center"),
                target_transform=get_transform(eval_cfg.res, True, "center"),
                cfg=model_cfg,
            )
        # the reference eval loader's batch (:88), a rank's share of it
        self.batch_size = max(1, eval_cfg.batch_size * 2 // w)
        self.loader = DataLoader(
            val_dataset, self.batch_size, shuffle=False, drop_last=False,
            num_shards=w, shard_index=dist.rank(),
            num_threads=effective_threads(eval_cfg.num_workers))
        self.exact_crf = eval_cfg.run_crf and eval_cfg.crf_backend == "exact"
        if self.exact_crf and w > 1:
            raise ValueError(
                "crf_backend=exact runs on the host of one process and cannot "
                "merge metrics across processes; use crf_backend=grid for "
                "an evaluation over several processes")
        if eval_cfg.run_crf and eval_cfg.crf_backend not in ("grid", "exact"):
            raise ValueError(f"crf_backend must be grid or exact, got "
                             f"{eval_cfg.crf_backend!r}")
        self.eval_step = make_eval_step(
            self.seg, eval_cfg.run_crf and not self.exact_crf,
            return_probs=self.exact_crf, with_conf=not self.exact_crf)
        n = self.seg.n_classes
        self.linear_metrics = UnsupervisedMetrics("final/linear/", n, 0,
                                                  False)
        self.cluster_metrics = UnsupervisedMetrics(
            "final/cluster/", n, model_cfg.extra_clusters, True)
        self.crf_seconds: List[float] = []

    def run(self, save_outputs: bool = True,
            max_batches: Optional[int] = None,
            on_batch: Optional[Callable[[Dict[str, Any], Any, Any],
                                        None]] = None
            ) -> Dict[str, float]:
        """Evaluate the dataset (its first ``max_batches`` batches) and
        return the ``final/`` metrics; ``save_outputs`` writes the kept
        images' PNG trees and the figures under
        ``results/predictions/<experiment_name>``. ``on_batch(batch,
        linear_preds, cluster_preds)`` sees each padded host batch and its
        predictions (on the device, or host arrays under the exact CRF)."""
        cfg, dev = self.cfg, self.device
        self.linear_metrics.reset()
        self.cluster_metrics.reset()
        self.crf_seconds = []
        saved: Dict[str, list] = {"img": [], "label": [], "cluster": [],
                                  "linear": []}
        n_keep = cfg.n_images
        conf_sums = None  # the device's epoch sums, fetched once
        for bi, batch in enumerate(self.loader):
            if max_batches is not None and bi >= max_batches:
                break
            batch = pad_batch(batch, self.batch_size)
            img = torch.from_numpy(np.asarray(batch["img"])).to(dev)
            label = torch.from_numpy(np.asarray(batch["label"])).to(dev)
            if self.exact_crf:
                from stego_torch.ops.crf_exact import \
                    dense_crf_exact_batch_multi

                lp, cp, img01 = (t.cpu().numpy()
                                 for t in self.eval_step(img, label))
                # one call: each image's bilateral lattice is built once
                # and shared by both probes' log-probs
                t0 = time.perf_counter()
                lprob, cprob = dense_crf_exact_batch_multi(img01, [lp, cp])
                self.crf_seconds.append(time.perf_counter() - t0)
                linear_preds = lprob.argmax(-1)
                cluster_preds = cprob.argmax(-1)
                self.linear_metrics.update(linear_preds, batch["label"])
                self.cluster_metrics.update(cluster_preds, batch["label"])
            else:
                linear_preds, cluster_preds, conf_l, conf_c = \
                    self.eval_step(img, label)
                conf_sums = ((conf_l, conf_c) if conf_sums is None
                             else (conf_sums[0] + conf_l,
                                   conf_sums[1] + conf_c))
            if on_batch is not None:
                on_batch(batch, linear_preds, cluster_preds)
            if len(saved["img"]) < n_keep:
                take = min(n_keep - len(saved["img"]), len(batch["img"]))
                saved["img"].extend(np.asarray(batch["img"][:take]))
                saved["label"].extend(np.asarray(batch["label"][:take]))
                for key, preds in (("cluster", cluster_preds),
                                   ("linear", linear_preds)):
                    preds = preds[:take]
                    if isinstance(preds, torch.Tensor):
                        preds = preds.cpu().numpy()
                    saved[key].extend(preds)

        if conf_sums is not None:
            self.linear_metrics.merge_stats(conf_sums[0])
            self.cluster_metrics.merge_stats(conf_sums[1])
        metrics = {**self.linear_metrics.compute(),
                   **self.cluster_metrics.compute()}
        if dist.is_primary():
            print(self.model_path)
            print(metrics)
            if save_outputs and saved["img"]:
                self._save_outputs(saved)
        dist.barrier()
        return metrics

    def _save_outputs(self, saved: Dict[str, list]) -> None:
        """The PNG trees of the kept images and the comparison and
        confusion-matrix figures (reference eval_segmentation.py:178-213)."""
        from stego_torch.data.colormaps import colormap_for_dataset
        from stego_torch.data.datasets import get_class_labels
        from stego_torch.utils.viz import (save_comparison_grid,
                                           save_confusion_matrix,
                                           save_prediction_images,
                                           write_figures)

        cfg, model_cfg = self.cfg, self.seg.cfg
        result_dir = join("results", "predictions", cfg.experiment_name)
        os.makedirs(result_dir, exist_ok=True)
        cmap = colormap_for_dataset(model_cfg.dataset_name)
        imgs = np.stack(saved["img"])
        labels = np.stack(saved["label"])
        clusters = self.cluster_metrics.map_clusters(
            np.stack(saved["cluster"]))
        linears = np.stack(saved["linear"])
        save_prediction_images(result_dir, imgs, labels, clusters, linears,
                               cmap)
        rows = {"Image": imgs, "Label": labels, "STEGO\n(Ours)": clusters}
        try:
            names = get_class_labels(model_cfg.dataset_name)
        except ValueError:
            names = [str(i) for i in range(self.seg.n_classes)]
        if model_cfg.extra_clusters:
            names = names + ["Extra"]
        hist = self.cluster_metrics.histogram
        write_figures([
            (join(result_dir, "comparison.png"),
             lambda p: save_comparison_grid(p, rows, cmap,
                                            dark_mode=cfg.dark_mode)),
            (join(result_dir, "conf_matrix.png"),
             lambda p: save_confusion_matrix(p, hist, names,
                                             dark_mode=cfg.dark_mode)),
        ])


def evaluate(eval_cfg: Config, model_path: str,
             device: Optional[Union[str, torch.device]] = None,
             vit_cfg: Optional[ViTConfig] = None, val_dataset=None,
             save_outputs: bool = True,
             max_batches: Optional[int] = None) -> Dict[str, float]:
    """Evaluate one checkpoint; returns the ``final/`` metrics
    (``evaluate.py:172-359``). ``device`` defaults to ``cuda:LOCAL_RANK``.
    Every process of a group calls it."""
    return Evaluator(eval_cfg, model_path, device, vit_cfg,
                     val_dataset).run(save_outputs, max_batches)


def main(argv: Optional[Sequence[str]] = None):
    from stego_torch.config import prep_args

    overrides = prep_args(argv)
    base = overrides.pop("config", None)
    model_paths = overrides.pop("model_paths", None)
    model_path = overrides.pop("model_path", None)
    cfg = (Config.from_yaml(base, **overrides) if base
           else Config.from_dict(overrides, strict=True))
    paths = cfg.model_paths or ([model_path] if model_path else [])
    if model_paths:
        paths = model_paths.split(",") if isinstance(model_paths, str) \
            else model_paths
    if not paths:
        raise SystemExit("pass model_path=<.ckpt file>")
    if not torch.cuda.is_available():
        raise SystemExit("stego_torch.eval runs on a CUDA device and found "
                         "none; nothing was evaluated")
    from stego_torch.kernels import build

    dist.launch(_evaluate_all, cfg.num_devices, cfg, paths,
                prepare=build.build)


def _evaluate_all(cfg: Config, paths: Sequence[str]) -> None:
    """One process's part of ``main``."""
    for p in paths:
        evaluate(cfg, p)


if __name__ == "__main__":
    main()
