"""The training application, ``python -m stego_torch.train``; counterpart of
``stego_tpu/train/app.py``.

Behavioral reference: the Hydra main and the Lightning Trainer of
src/train_segmentation.py:386-497, as one explicit loop: step-based
training from a threaded loader, validation every ``val_freq`` steps (the
confusion matrices summed on the device, fetched once an epoch, Hungarian
metrics on the host), top-k checkpoints by cluster mIoU, ``metrics.jsonl``
(and TensorBoard where it imports) through a writer thread that fetches
the device's scalars, exact mid-epoch resume and a checkpoint-and-exit on
SIGTERM.

Each step's randomness (dropout keep-masks, sample coordinates, negative
permutations) is drawn by ``draw_step_randomness`` from a generator seeded
by ``(cfg.seed, absolute step)``, the counterpart of the JAX package's
``fold_in(k_steps, step)``: a resumed run draws what an uninterrupted one
draws, and the loader's ``fast_forward`` gives it the same batches.

Several processes (``parallel/dist.py``): one a GPU, started by ``python -m
torch.distributed.run`` or, for ``num_devices`` > 1, by :func:`main`
itself. ``batch_size`` and ``val_batch_size`` are global, as in the JAX
package (``stego_tpu/train/app.py:472-497``): each rank's loaders take
``batch_size // W`` items of their stripe of every epoch's permutation (a
tail of fewer than W items is dropped), every rank draws the global
batch's randomness and takes its part, the validation's confusion matrices
are summed over the ranks, rank 0 writes the logs, figures and
checkpoints, every rank restores on resume, and a SIGTERM on any rank
makes every rank checkpoint after the same step.

Not ported: ``steps_per_dispatch > 1`` (a workaround for the TPU's dispatch
latency; ROADMAP.md queue 1, Do not port these TPU workarounds), which
raises. Each validation writes its figures (panel, confusion matrix, class
frequencies) beside ``metrics.jsonl``, or, without matplotlib, prints one
line for each figure it could not write. ``checkify`` and ``debug_nans``
(XLA's sanitizers in the JAX package) check that every step's metrics are
finite and raise with the step's index otherwise.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from os.path import join
from typing import Any, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from stego_torch.config import Config, check_batch_split
from stego_torch.data.contrastive import ContrastiveSegDataset
from stego_torch.data.datasets import get_class_labels
from stego_torch.data.loader import (DataLoader, effective_threads,
                                     infinite_batches, pad_batch)
from stego_torch.data.transforms import get_transform
from stego_torch.models.vit import ViTConfig
from stego_torch.parallel import dist
from stego_torch.train.checkpoint import CheckpointManager
from stego_torch.train.segmenter import (UnsupervisedSegmenter,
                                         draw_step_randomness,
                                         make_train_step, make_val_step)
from stego_torch.utils.logging import (AsyncMetricWriter, MetricLogger,
                                       NullLogger)
from stego_torch.utils.metrics import UnsupervisedMetrics
from stego_torch.utils.precision import full_f32_for

def load_dino_weights(path: str, in_chans: int = 3
                      ) -> Dict[str, torch.Tensor]:
    """A DINO ``.pth`` (a ViT state dict, or one under ``teacher`` or
    ``state_dict``) with the reference's ``module.``/``backbone.`` prefixes
    stripped (src/modules.py:46-52). Tensors and plain containers only
    (``weights_only=True``). ``in_chans=4`` widens the patch embed for
    Potsdam's near-IR channel by a mean-of-RGB slice
    (``stego_tpu/models/convert.py:111-127``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("teacher", "state_dict"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    sd = {k.replace("module.", "").replace("backbone.", ""): v
          for k, v in sd.items()}
    w = sd["patch_embed.proj.weight"]
    if in_chans != w.shape[1]:
        if w.shape[1] != 3 or in_chans < 3:
            raise ValueError(f"cannot expand patch embed {w.shape[1]} -> "
                             f"{in_chans}")
        sd["patch_embed.proj.weight"] = torch.cat(
            [w, w.mean(dim=1, keepdim=True).expand(-1, in_chans - 3, -1, -1)],
            dim=1)
    return sd


def build_backbone(cfg: Config, seg: UnsupervisedSegmenter
                   ) -> Dict[str, torch.Tensor]:
    """Put ``cfg.pretrained_weights`` into the segmenter's ViT, or keep its
    seeded random init (offline; the reference downloads DINO weights,
    modules.py:35-62), and return the ViT's f32 state dict on the CPU: the
    source precision the checkpoints keep when the trunk computes in
    bf16."""
    vit = seg.net.model
    if cfg.pretrained_weights:
        sd = load_dino_weights(cfg.pretrained_weights,
                               in_chans=seg.vit_cfg.in_chans)
        missing, _ = vit.load_state_dict(sd, strict=False)
        if missing:
            raise ValueError(f"{cfg.pretrained_weights} lacks {missing[:4]}")
    else:
        print("WARNING: no pretrained_weights given — using a randomly "
              "initialized backbone (reference behavior is to download DINO "
              "weights; provide pretrained_weights=<path to .pth> for "
              "parity).")
    return {k: v.detach().float().cpu().clone()
            for k, v in vit.state_dict().items()}


def make_datasets(cfg: Config):
    # host-side augmentation only when the device path is disabled
    need_aug = cfg.aug_alignment_weight > 0 and not cfg.device_augs
    train_dataset = ContrastiveSegDataset(
        pytorch_data_dir=cfg.pytorch_data_dir,
        dataset_name=cfg.dataset_name,
        crop_type=cfg.crop_type,
        image_set="train",
        transform=get_transform(cfg.res, False, cfg.loader_crop_type,
                                fast_decode=cfg.fast_decode),
        target_transform=get_transform(cfg.res, True, cfg.loader_crop_type),
        cfg=cfg,
        aug_geometric=need_aug,
        aug_photometric=need_aug,
        num_neighbors=cfg.num_neighbors,
        mask=True,
        pos_images=cfg.correspondence_weight > 0,
        pos_labels=cfg.correspondence_weight > 0,
        seed=cfg.seed,
    )
    if cfg.cache_dataset or cfg.cache_dataset_dir:
        if cfg.loader_crop_type == "random":
            raise ValueError("cache_dataset requires a deterministic "
                             "loader_crop_type (not 'random')")

    def _wrap_cached(inner, image_set, res, crop_type, loader_crop):
        """Apply the configured decode caches (one naming and signature
        scheme for both splits)."""
        if cfg.cache_dataset_dir:
            from stego_torch.data.loader import DiskCachedDataset

            nice = cfg.dir_dataset_name if cfg.dataset_name == "directory" \
                else cfg.dataset_name
            inner = DiskCachedDataset(
                inner,
                join(cfg.cache_dataset_dir,
                     f"{nice}_{image_set}_{crop_type}_{res}"),
                signature={"res": res, "crop_type": str(crop_type),
                           "image_set": image_set,
                           "loader_crop": str(loader_crop),
                           "potsdam_ir": cfg.potsdam_ir},
            )
        if cfg.cache_dataset:
            from stego_torch.data.loader import CachedDataset

            inner = CachedDataset(inner)
        return inner

    train_dataset.dataset = _wrap_cached(
        train_dataset.dataset, "train", cfg.res, cfg.crop_type,
        cfg.loader_crop_type)
    val_loader_crop = "center"
    val_dataset = ContrastiveSegDataset(
        pytorch_data_dir=cfg.pytorch_data_dir,
        dataset_name=cfg.dataset_name,
        crop_type=None,
        image_set="val",
        transform=get_transform(cfg.val_res, False, val_loader_crop),
        target_transform=get_transform(cfg.val_res, True, val_loader_crop),
        mask=True,
        cfg=cfg,
        seed=cfg.seed,
    )
    # validation re-runs every val_freq steps: cache its decode too
    val_dataset.dataset = _wrap_cached(
        val_dataset.dataset, "val", cfg.val_res, None, val_loader_crop)
    return train_dataset, val_dataset


def _to_device(batch: Mapping[str, Any], keys, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in keys if k in batch}


def _panel(seg: UnsupervisedSegmenter, out: Dict[str, torch.Tensor],
           batch: Dict[str, Any], val_base) -> Dict[str, np.ndarray]:
    """The first ``n_images`` images of a validation batch, their labels
    and predictions; an index batch's images come from ``val_base``."""
    if "ind" in batch and "img" not in batch:
        idxs = [int(i) for i in np.asarray(batch["ind"])[:seg.cfg.n_images]
                if int(i) >= 0]
        items = [val_base[i] for i in idxs]
        imgs = np.stack([it[0] for it in items])
        labels = np.stack([it[1] for it in items])
    else:
        imgs = np.asarray(batch["img"])[:seg.cfg.n_images]
        labels = np.asarray(batch["label"])[:seg.cfg.n_images]
    n = len(imgs)
    return {"img": imgs, "label": labels,
            "linear": out["linear_preds"][:n].cpu().numpy(),
            "cluster": out["cluster_preds"][:n].cpu().numpy()}


def save_validation_figures(seg: UnsupervisedSegmenter, figure_prefix: str,
                            panel: Dict[str, np.ndarray],
                            cluster_metrics: UnsupervisedMetrics) -> None:
    """The figures the reference logs to TensorBoard each validation
    (``stego_tpu/train/app.py:305-343``): the image/label/linear/cluster
    panel (train_segmentation.py:290-302), the Hungarian-matched cluster
    confusion matrix (:304-330) and the label and cluster frequencies
    (:332-359), as ``{prefix}panel.png``, ``{prefix}confusion.png`` and
    ``{prefix}freqs.png``; without matplotlib, one line names each."""
    from stego_torch.data.colormaps import colormap_for_dataset
    from stego_torch.utils.viz import (save_comparison_grid,
                                       save_confusion_matrix,
                                       save_frequency_bars, write_figures)

    cmap = colormap_for_dataset(seg.cfg.dataset_name)
    mapped = cluster_metrics.map_clusters(panel["cluster"])
    try:
        names = get_class_labels(seg.cfg.dataset_name)[:seg.n_classes]
    except ValueError:
        names = [f"class {i}" for i in range(seg.n_classes)]
    if seg.cfg.extra_clusters:
        names = names + ["Extra"]
    hist = cluster_metrics.histogram
    write_figures([
        (figure_prefix + "panel.png",
         lambda p: save_comparison_grid(
             p, {"Image": panel["img"], "Label": panel["label"],
                 "Linear Probe": panel["linear"],
                 "Cluster Probe": np.asarray(mapped)}, cmap)),
        (figure_prefix + "confusion.png",
         lambda p: save_confusion_matrix(p, hist, names)),
        (figure_prefix + "freqs.png",
         lambda p: save_frequency_bars(p, hist, names, cmap)),
    ])


def run_validation(seg: UnsupervisedSegmenter, val_step, val_loader,
                   batch_size: int, device: torch.device, val_cache=None,
                   val_epoch=None, figure_prefix: Optional[str] = None,
                   val_base=None) -> Dict[str, float]:
    """A validation epoch (reference validation_step/epoch_end,
    train_segmentation.py:254-283): each batch's confusion matrices are
    added up on the device and fetched once, then Hungarian-matched on the
    host. A short final batch is padded with ignored labels (or indices).
    Over several processes every rank runs its stripe of the split and the
    matrices are summed over the ranks (``merge_stats``); ``batch_size``
    is a rank's. With a feature cache (``val_cache``), the batches are
    index batches;
    ``val_epoch`` then runs the whole epoch in one call. ``figure_prefix``
    also writes the validation figures (:func:`save_validation_figures`)
    of the first batch, on rank 0; an index batch's images come from
    ``val_base``."""
    linear_metrics = UnsupervisedMetrics("test/linear/", seg.n_classes, 0,
                                         False)
    cluster_metrics = UnsupervisedMetrics(
        "test/cluster/", seg.n_classes, seg.cfg.extra_clusters, True)
    conf = None
    panel = None
    if val_epoch is not None and val_cache is not None:
        batches = [pad_batch(b, batch_size) for b in val_loader]
        if batches:
            inds = torch.from_numpy(np.stack(
                [np.asarray(b["ind"]).astype(np.int64) for b in batches]))
            out = val_epoch(val_cache, inds.to(device))
            conf = (out["conf_linear"], out["conf_cluster"])
            if figure_prefix is not None:
                # the panel's predictions: one more step, of the first batch
                first = val_step(val_cache, _to_device(batches[0], ("ind",),
                                                       device))
                panel = _panel(seg, first, batches[0], val_base)
    else:
        for batch in val_loader:
            batch = pad_batch(batch, batch_size)
            if val_cache is not None:
                out = val_step(val_cache, _to_device(batch, ("ind",), device))
            else:
                out = val_step(_to_device(batch, ("img", "label"), device))
            conf = ((out["conf_linear"], out["conf_cluster"]) if conf is None
                    else (conf[0] + out["conf_linear"],
                          conf[1] + out["conf_cluster"]))
            if panel is None and figure_prefix is not None:
                panel = _panel(seg, out, batch, val_base)
    if conf is not None:
        linear_metrics.merge_stats(conf[0])
        cluster_metrics.merge_stats(conf[1])
    metrics = {**linear_metrics.compute(), **cluster_metrics.compute()}
    if panel is not None and dist.is_primary():
        save_validation_figures(seg, figure_prefix, panel, cluster_metrics)
    return metrics


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed for ``(seed, step)`` (numpy's SeedSequence):
    the port's counterpart of ``jax.random.fold_in(key(seed), step)``."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def _check_finite(step: int, metrics: Mapping[str, torch.Tensor]) -> None:
    """``checkify``/``debug_nans``: raise when a scalar metric of train
    step ``step`` is not finite (one device sync a step)."""
    names = [k for k in metrics if not k.startswith("hist/")]
    ok = torch.isfinite(torch.stack([metrics[k].float() for k in names]))
    if not bool(ok.all()):
        bad = [k for k, good in zip(names, ok.tolist()) if not good]
        raise FloatingPointError(
            f"train step {step}: non-finite {bad} (checkify/debug_nans)")


class Trainer:
    """One training run of ``cfg`` (:func:`train` is ``Trainer(...).run()``).

    The constructor builds the datasets (unless given), the segmenter on
    ``device`` (default ``cuda:LOCAL_RANK``; the tests pass the CPU), its
    backbone,
    the feature caches in the cached mode (``cache_backbone_feats``), the
    steps, the loaders and the checkpoint manager. :meth:`run` trains to
    ``cfg.max_steps`` and returns the last validation's metrics; ``seg``
    is the trained segmenter. ``step_starts``, ``loader_wait``,
    ``copy_seconds`` and ``val_seconds`` record the loop's host times: the
    clock at each step's start, the seconds each step waited for its batch
    and took to copy it to the device (a copy from pageable memory returns
    when it is done), and each validation epoch's seconds. It runs on the
    process group this process is in (every rank constructs and runs one);
    ``num_devices`` > 0 must be that group's size."""

    def __init__(self, cfg: Config, vit_cfg: Optional[ViTConfig] = None,
                 train_dataset=None, val_dataset=None,
                 device: Optional[torch.device] = None):
        self.world, self.rank = dist.world(), dist.rank()
        if cfg.num_devices > 0 and cfg.num_devices != self.world:
            raise ValueError(
                f"num_devices={cfg.num_devices} asks for {cfg.num_devices} "
                f"processes and this is one of {self.world}: start them with "
                f"python -m stego_torch.train (or python -m "
                f"torch.distributed.run), or set num_devices=0")
        check_batch_split(cfg, self.world)
        if cfg.steps_per_dispatch > 1:
            raise NotImplementedError(
                "steps_per_dispatch > 1 is not ported: it is the TPU's "
                "workaround for its dispatch latency (ROADMAP.md queue 1, Do "
                "not port these TPU workarounds)")
        self.cfg = cfg
        self.device = dist.device() if device is None \
            else torch.device(device)
        full_f32_for(cfg.backbone_dtype)
        self.log_dir = join(cfg.output_root, "logs",
                            f"{cfg.dataset_name}_{cfg.experiment_name}")
        self.ckpt_dir = join(cfg.output_root, "checkpoints",
                             f"{cfg.dataset_name}_{cfg.experiment_name}")
        if train_dataset is None or val_dataset is None:
            train_dataset, val_dataset = make_datasets(cfg)
        self.train_dataset, self.val_dataset = train_dataset, val_dataset

        seg = UnsupervisedSegmenter(
            train_dataset.n_classes, cfg, vit_cfg=vit_cfg,
            generator=torch.Generator().manual_seed(cfg.seed))
        # the f32 source weights, for the checkpoints; the trunk computes
        # with its blocks' matmul weights stored in bf16 under a bf16 trunk
        self.backbone_store = build_backbone(cfg, seg)
        seg.to(self.device)
        if seg.net.backbone_dtype == torch.bfloat16:
            seg.net.model.cast_blocks(torch.bfloat16)
        self.seg = seg

        # frozen-trunk feature caches: one trunk pass now, index-only
        # batches afterwards (train/feat_cache.py)
        self.feat_cache = self.val_cache = None
        if cfg.cache_backbone_feats:
            from stego_torch.train.feat_cache import build_feat_cache

            t0 = time.time()
            self.feat_cache = build_feat_cache(seg, train_dataset, cfg)
            self.val_cache = build_feat_cache(seg, val_dataset, cfg,
                                              res=cfg.val_res,
                                              with_mask=False)
            gib = sum(t.numel() * t.element_size()
                      for c in (self.feat_cache, self.val_cache)
                      for t in c.values()) / 2**30
            print(f"feature cache: {len(train_dataset)} train + "
                  f"{len(val_dataset)} val items, {gib:.2f} GiB on "
                  f"{self.device}, built in {time.time() - t0:.1f}s")

        self.val_epoch = None
        if self.feat_cache is not None:
            from stego_torch.train.feat_cache import FeatCacheSampler
            from stego_torch.train.segmenter import (make_cached_train_step,
                                                     make_cached_val_epoch,
                                                     make_cached_val_step)

            self.train_step = make_cached_train_step(seg, with_hist=False)
            self.train_step_hist = (make_cached_train_step(seg, True)
                                    if cfg.hist_freq else self.train_step)
            self.val_step = make_cached_val_step(seg)
            self.val_epoch = make_cached_val_epoch(seg)
            train_items = FeatCacheSampler(train_dataset)
            val_items = FeatCacheSampler(val_dataset)  # index-only (no pos)
            self.step_keys = ["ind", "ind_pos"]
        else:
            # two variants: the hot one bins no cd histograms
            self.train_step = make_train_step(seg, with_hist=False)
            self.train_step_hist = (make_train_step(seg, with_hist=True)
                                    if cfg.hist_freq else self.train_step)
            self.val_step = make_val_step(seg)
            train_items, val_items = train_dataset, val_dataset
            self.step_keys = ["img", "label", "img_pos", "label_pos"]
            if cfg.use_salience:
                self.step_keys += ["mask", "mask_pos"]
            if cfg.aug_alignment_weight > 0 and not cfg.device_augs:
                self.step_keys += ["img_aug", "coord_aug"]

        # each rank's loaders: its stripe of every epoch, in batches of its
        # share of the global batch
        self.val_bs = (cfg.val_batch_size or cfg.batch_size) // self.world
        nthreads = effective_threads(cfg.num_workers)
        self.train_loader = DataLoader(
            train_items, cfg.batch_size // self.world, shuffle=True,
            seed=cfg.seed, num_shards=self.world, shard_index=self.rank,
            num_threads=nthreads)
        self.val_loader = DataLoader(
            val_items, self.val_bs, shuffle=False, drop_last=False,
            num_shards=self.world, shard_index=self.rank,
            num_threads=nthreads)
        self.mgr = CheckpointManager(self.ckpt_dir, cfg,
                                     save_top_k=cfg.save_top_k)
        self.start_step = 0
        self.step_starts: List[float] = []
        self.loader_wait: List[float] = []
        self.copy_seconds: List[float] = []
        self.val_seconds: List[float] = []

    def validate(self, step: int) -> Dict[str, float]:
        """A validation epoch after ``step`` steps, with its figures
        (``val_<step>_*.png`` in the log directory, by rank 0)."""
        t0 = time.perf_counter()
        out = run_validation(self.seg, self.val_step, self.val_loader,
                             self.val_bs, self.device,
                             val_cache=self.val_cache,
                             val_epoch=self.val_epoch,
                             figure_prefix=join(self.log_dir,
                                                f"val_{step}_"),
                             val_base=self.val_dataset.dataset)
        self.val_seconds.append(time.perf_counter() - t0)
        return out

    def _step(self, batch: Dict[str, Any], step_idx: int,
              gen: torch.Generator) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        hist = bool(cfg.hist_freq) and (step_idx + 1) % cfg.hist_freq == 0
        step_fn = self.train_step_hist if hist else self.train_step
        gen.manual_seed(step_seed(cfg.seed, step_idx))
        rand = draw_step_randomness(self.seg, cfg.batch_size, gen)
        t0 = time.perf_counter()
        dev_batch = _to_device(batch, self.step_keys, self.device)
        self.copy_seconds.append(time.perf_counter() - t0)
        if self.feat_cache is not None:
            return step_fn(self.feat_cache, dev_batch, rand)
        return step_fn(dev_batch, rand)

    def run(self) -> Dict[str, float]:
        cfg, seg, mgr = self.cfg, self.seg, self.mgr
        if cfg.resume:
            # the loader's cursor is the step count (one batch a step), so
            # fast_forward resumes mid-epoch exactly; no loader state is
            # saved
            try:
                self.start_step = mgr.restore(seg)
                self.train_loader.fast_forward(self.start_step)
                print(f"resumed from checkpoint step {self.start_step}")
            except FileNotFoundError:
                print(f"resume=true but no checkpoints in {self.ckpt_dir}; "
                      "starting fresh")
        mgr.save_backbone(self.backbone_store)

        # SIGTERM asks for a checkpoint and exit after the step in flight;
        # handlers install only on the main thread and are restored on exit
        stop_signal: list = []
        prev_handlers = {}
        if (cfg.graceful_shutdown
                and threading.current_thread() is threading.main_thread()):
            def _request_stop(signum, frame):
                print(f"signal {signum} received: will checkpoint and exit "
                      "after the current step")
                stop_signal.append(signum)

            prev_handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM,
                                                          _request_stop)

        logger = (AsyncMetricWriter(MetricLogger(self.log_dir))
                  if self.rank == 0 else NullLogger())
        gen = torch.Generator(device=self.device)
        check_finite = cfg.checkify or cfg.debug_nans
        metrics_out: Dict[str, float] = {}
        batches: Iterator = infinite_batches(self.train_loader)
        imgs_seen = 0
        profiler = None
        try:
            for step_idx in range(self.start_step, cfg.max_steps):
                # profiler trace of steps 10-20 when profile_dir is set
                if cfg.profile_dir and step_idx == 10 and self.rank == 0:
                    profiler = _start_profiler(self.device)
                if profiler is not None and step_idx == 20:
                    _stop_profiler(profiler, cfg.profile_dir)
                    profiler = None
                t0 = time.perf_counter()
                self.step_starts.append(t0)
                batch = next(batches)
                self.loader_wait.append(time.perf_counter() - t0)
                metrics = self._step(batch, step_idx, gen)
                done = step_idx + 1  # steps taken
                if check_finite:
                    _check_finite(done, metrics)
                imgs_seen += cfg.batch_size

                if cfg.reset_probe_steps is not None and \
                        done == cfg.reset_probe_steps:
                    print("RESETTING PROBES")
                    seg.reset_probes(torch.Generator().manual_seed(
                        step_seed(cfg.seed, cfg.max_steps + 1)))

                if done % cfg.scalar_log_freq == 0:
                    # device tensors go to the writer thread, which fetches
                    # them; the raw image count becomes imgs_per_sec there
                    host = {k: v for k, v in metrics.items()
                            if not k.startswith("hist/")}
                    host["_imgs_seen"] = float(imgs_seen)
                    imgs_seen = 0
                    logger.log_scalars(done, host)

                if cfg.hist_freq and done % cfg.hist_freq == 0:
                    for k, v in metrics.items():
                        if k.startswith("hist/"):
                            logger.log_histogram_counts(done, k, v)

                if done % cfg.val_freq == 0 or done == cfg.max_steps:
                    metrics_out = self.validate(done)
                    logger.log_scalars(done, metrics_out)
                    print(f"step {done}: " + ", ".join(
                        f"{k}={v:.2f}" for k, v in metrics_out.items()))

                if done % cfg.checkpoint_freq == 0 or done == cfg.max_steps:
                    mgr.save(done, seg, metrics=metrics_out)

                if self._stop(stop_signal):
                    # lands whatever its top-k rank
                    mgr.save_preemption(done, seg, metrics=metrics_out)
                    print(f"exiting after step {done} on signal "
                          f"{stop_signal[0] if stop_signal else 'of a rank'}"
                          f" (resume=true continues from here)")
                    break
        finally:
            if profiler is not None:
                _stop_profiler(profiler, cfg.profile_dir)
            for s, h in prev_handlers.items():
                signal.signal(s, h)
            logger.close()
        return metrics_out


    def _stop(self, stop_signal: list) -> bool:
        """Whether a signal asked this run to stop after this step: on any
        rank, so that every rank checkpoints after the same step (one
        all_reduce a step over several processes)."""
        if self.world == 1 or not self.cfg.graceful_shutdown:
            return bool(stop_signal)
        flag = torch.tensor([len(stop_signal)], dtype=torch.int32,
                            device=self.device)
        return bool(dist.all_reduce_(flag, op="max").item())


def _start_profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=acts)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str) -> None:
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(join(profile_dir, "train_steps.json"))


def train(cfg: Config, vit_cfg: Optional[ViTConfig] = None,
          train_dataset=None, val_dataset=None,
          device: Optional[torch.device] = None) -> Dict[str, float]:
    """Train to ``cfg.max_steps`` and return the last validation's metrics.
    ``vit_cfg`` and the datasets can be injected (tests, in-memory data);
    ``device`` defaults to ``cuda:LOCAL_RANK``. Every process of a group
    calls it."""
    return Trainer(cfg, vit_cfg, train_dataset, val_dataset, device).run()


def main(argv=None):
    from stego_torch.config import prep_args

    overrides = prep_args(argv)
    base = overrides.pop("config", None)
    cfg = (Config.from_yaml(base, **overrides) if base
           else Config.from_dict(overrides, strict=True))
    if not torch.cuda.is_available():
        raise SystemExit("stego_torch.train runs on a CUDA device and found "
                         "none; nothing was trained")
    from stego_torch.kernels import build

    # the kernels' library is built once, before the ranks start
    dist.launch(train, cfg.num_devices, cfg, prepare=build.build)


if __name__ == "__main__":
    main()
