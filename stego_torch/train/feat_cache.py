"""Frozen-trunk feature cache; counterpart of
``stego_tpu/train/feat_cache.py``.

STEGO's trunk is frozen (reference no-grad region, src/modules.py:85) and
its loader transform is deterministic per index outside of
``loader_crop_type="random"``, yet the reference recomputes the same DINO
features for every image in every epoch. ``cache_backbone_feats=true``
runs the trunk once over the split, keeps ``(feats, label)`` on the device
and trains head and probes from index batches
(``train/segmenter.py:make_cached_train_step``): a step is head, loss,
probes and Adam only.

The steps are the image steps' (``_update_from_feats`` is shared), so a
cached step equals the image step on the same images. The cache refuses
configurations whose losses need per-step images (aug alignment, CRF loss)
or whose decoding is random (random loader crops). Over several processes
each rank runs the trunk over its block of the split; the blocks are then
gathered, so that every rank holds the whole cache, or, with
``feat_cache_sharded``, each rank keeps its block and the steps read rows
through ``parallel/dist.py:row_take`` (capacity grows with the ranks).
With ``use_salience`` the cache keeps each image's mask too, as float16,
for the cached step's salience-biased draw.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from stego_torch.config import Config
from stego_torch.parallel import dist


def validate_feat_cache_cfg(cfg: Config) -> None:
    """Reject configurations the cache cannot represent faithfully
    (``feat_cache.py:36-56``)."""
    if cfg.arch != "dino":
        raise ValueError(
            "cache_backbone_feats supports arch=dino (the FPN arm's BatchNorm "
            "head consumes multi-scale taps whose running stats the cache "
            "would freeze)")
    if cfg.loader_crop_type == "random":
        raise ValueError(
            "cache_backbone_feats requires a deterministic loader transform: "
            "loader_crop_type='random' decodes a different crop every epoch "
            "(use crop_type=five materialized crops instead — the reference's "
            "own crop_datasets.py pattern)")
    if cfg.aug_alignment_weight > 0:
        raise ValueError(
            "cache_backbone_feats is incompatible with aug_alignment_weight>0:"
            " the augmented view must pass through the backbone every step")
    if cfg.crf_weight > 0:
        raise ValueError(
            "cache_backbone_feats is incompatible with crf_weight>0: the CRF "
            "loss consumes per-step images")


def estimate_cache_gb(cfg: Config, seg, n_items: int,
                      res: int | None = None, with_mask: bool | None = None
                      ) -> float:
    """Device-memory estimate of the cache (features in the trunk's dtype,
    int16 labels, float16 masks when ``use_salience``), in GiB
    (``feat_cache.py:59-70``)."""
    res = res or cfg.res
    hp = res // seg.vit_cfg.patch_size
    feat_itemsize = 2 if cfg.backbone_dtype == "bfloat16" else 4
    per_item = hp * hp * seg.net.n_feats * feat_itemsize
    per_item += res * res * 2  # int16 labels
    if cfg.use_salience if with_mask is None else with_mask:
        per_item += res * res * 2  # float16 masks
    return n_items * per_item / 2**30


def build_feat_cache(seg, contrastive_ds, cfg: Config,
                     batch_size: int | None = None, res: int | None = None,
                     with_mask: bool | None = None) -> Dict[str, torch.Tensor]:
    """One no-grad trunk pass over the (deterministic) base dataset
    ``contrastive_ds.dataset``, whose items are (img (H, W, 3), label (H, W)
    [, mask]) arrays.

    Returns tensors on the segmenter's device, indexed by base-dataset
    index: ``feats`` (N, H/p, W/p, C) in the trunk's dtype (a bf16 trunk's
    features are bf16 values, so storing them in bf16 loses nothing),
    ``label`` (N, H, W) int16 and, with masks, ``mask`` (N, H, W)
    float16 (the items' third entry). The trunk runs in chunks of ``batch_size``
    (default ``cfg.batch_size``) images; the short final chunk is padded
    with copies of its last image, so that every chunk has one shape
    (``feat_cache.py:123-128``), and the padding's rows are dropped.
    ``res`` and ``with_mask`` override the train split's defaults: the
    validation cache is built at ``cfg.val_res`` and needs no masks.

    Over W processes rank k builds rows [k M, (k + 1) M), M = ceil(N / W),
    and the ranks gather them; with ``feat_cache_sharded`` rank k keeps
    only its block, zero rows past N (``feat_cache.py:94-140``)."""
    validate_feat_cache_cfg(cfg)
    want_mask = cfg.use_salience if with_mask is None else with_mask
    base = contrastive_ds.dataset
    n = len(base)
    w = dist.world()
    est = estimate_cache_gb(cfg, seg, n, res=res, with_mask=want_mask)
    per_device = est / w if cfg.feat_cache_sharded else est
    if per_device > cfg.feat_cache_max_gb:
        raise ValueError(
            f"feature cache for {n} items would need ~{per_device:.1f} GiB "
            f"per device (> feat_cache_max_gb={cfg.feat_cache_max_gb}); "
            f"raise the cap if device memory allows, or train without "
            f"cache_backbone_feats")

    device = next(seg.parameters()).device
    img0, label0 = base[0][:2]  # the shapes, for a rank with no rows
    p = seg.vit_cfg.patch_size
    rows = -(-n // w)
    first = dist.rank() * rows
    feats = torch.zeros((rows, img0.shape[0] // p, img0.shape[1] // p,
                         seg.net.n_feats), dtype=seg.net.backbone_dtype,
                        device=device)
    labels = torch.zeros((rows,) + np.shape(label0), dtype=torch.int16,
                         device=device)
    masks = (torch.zeros((rows,) + np.shape(label0), dtype=torch.float16,
                         device=device) if want_mask else None)
    b = batch_size or cfg.batch_size
    for start in range(first, min(first + rows, n), b):
        items = [base[i] for i in range(start, min(start + b, first + rows,
                                                   n))]
        imgs = np.stack([it[0] for it in items]).astype(np.float32)
        done = slice(start - first, start - first + len(items))
        labels[done] = torch.from_numpy(
            np.stack([it[1] for it in items]).astype(np.int16))
        if want_mask:
            masks[done] = torch.from_numpy(
                np.stack([it[2] for it in items]).astype(np.float16))
        pad = b - len(items)
        if pad:  # one shape for every chunk
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)])
        f = seg.net.backbone_features(torch.from_numpy(imgs).to(device))
        feats[done] = f[:len(items)]
    cache = {"feats": feats, "label": labels}
    if want_mask:
        cache["mask"] = masks
    if cfg.feat_cache_sharded:
        return cache
    return {k: dist.gather_rows(v)[:n] for k, v in cache.items()}


class FeatCacheSampler:
    """Index-only mirror of ``ContrastiveSegDataset.__getitem__``'s pair draw.

    Reproduces the neighbor selection exactly — same ``(seed, epoch, ind)``
    Generator, same first draw (data/contrastive.py:163-169; reference
    data.py:524) — without decoding any image, so the cached mode samples the
    very (ind, ind_pos) sequence the image pipeline would have fed the step.
    ``DataLoader`` drives ``epoch`` like any dataset's.
    """

    def __init__(self, contrastive_ds):
        self.ds = contrastive_ds
        self.epoch = 0
        self.use_pos = contrastive_ds.pos_images or contrastive_ds.pos_labels

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, ind: int) -> Dict[str, np.ndarray]:
        out = {"ind": np.int32(ind)}
        if self.use_pos:
            rng = np.random.default_rng((self.ds.seed, self.epoch, ind))
            nn_choice = int(rng.integers(1, self.ds.num_neighbors + 1))
            out["ind_pos"] = np.int32(self.ds.nns[ind][nn_choice])
        return out
