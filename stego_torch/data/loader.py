"""Host-side batch loader; counterpart of ``stego_tpu/data/loader.py``.

Fixed-shape dict batches of numpy arrays (NHWC), shuffled
deterministically from an explicit seed, with an optional background
thread that prefetches batches while the device runs steps and an optional
thread pool that fetches a batch's items. The reference's ragged collation
(flexible_collate, utils.py:277-323) is not needed: shapes are static by
construction.

The JAX package's wire compaction (``compact_batch``/``restore_dtypes``,
and ``_compact_item`` in its disk cache) is a workaround for its TPU host's
slow link and is not ported (ROADMAP.md queue 1, Do not port these TPU
workarounds): :class:`DiskCachedDataset` stores items as they are.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np


def effective_threads(num_workers: int) -> int:
    """Map the reference's ``num_workers`` config to a loader thread count:
    capped at the host's cores (its default of 24 would oversubscribe small
    hosts; threads beyond cores only add GIL contention)."""
    import os

    return max(0, min(int(num_workers), os.cpu_count() or 1))


def collate(items) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = np.asarray(vals)
    return out


def pad_batch(batch: Dict[str, Any], size: int) -> Dict[str, Any]:
    """Pad a short final batch to ``size`` with ignore-labeled copies
    (ignore-INDEXED in cached-validation index batches)."""
    n = len(next(iter(batch.values())))
    if n == size:
        return batch
    pad = size - n
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        reps = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
        if k.startswith("label") or k == "ind":
            reps[n:] = -1  # padded pixels/indices are ignored downstream
        out[k] = reps
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        num_shards: int = 1,
        shard_index: int = 0,
        num_threads: int = 0,
    ):
        """num_shards/shard_index: multi-host data sharding — every host
        shuffles the SAME global permutation (seeded identically) then takes
        its equal-length stripe, so global batches are disjoint and all hosts
        step the same number of batches.

        num_threads > 1: fetch the items of each batch on a thread pool (the
        analogue of the reference's DataLoader num_workers, minus the process
        fork). Decode via the native fast path releases the GIL, so threads
        scale with host cores; determinism is unaffected because every item's
        randomness comes from a per-(seed, index) Generator, not call order."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.num_threads = num_threads
        self.epoch = 0
        self._skip = 0
        self._pool = None

    def _shard_len(self) -> int:
        return len(self.dataset) // self.num_shards if self.num_shards > 1 \
            else len(self.dataset)

    def __len__(self):
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        if self.num_shards > 1:
            usable = self._shard_len() * self.num_shards
            idx = idx[:usable][self.shard_index::self.num_shards]
        return idx

    def fast_forward(self, n_batches: int) -> None:
        """Position the loader as if ``n_batches`` had already been consumed
        from a fresh instance — exact mid-epoch resume. Training consumes
        exactly one batch per step, so a resumed run calls
        ``fast_forward(start_step)`` and the stream continues with the very
        batch the interrupted run would have seen next (epoch permutation and
        ``dataset.epoch`` pair-sampling state included). Skipped batches are
        never decoded — this is index arithmetic, not replay. (The reference's
        Lightning restart re-seeds the epoch instead, replaying from its
        start; see train_segmentation.py:497 Trainer(..) defaults.)"""
        nb = len(self)
        if nb == 0:
            return
        self.epoch = n_batches // nb
        self._skip = n_batches % nb

    def _fetch(self, chunk) -> list:
        if self.num_threads > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.num_threads)
            return list(self._pool.map(
                self.dataset.__getitem__, (int(i) for i in chunk)
            ))
        return [self.dataset[int(i)] for i in chunk]

    def _iter_batches(self) -> Iterator[Dict[str, Any]]:
        idx = self._indices()
        nb = len(self)
        start, self._skip = self._skip, 0
        for b in range(start, nb):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if len(chunk) == 0:
                return
            yield collate(self._fetch(chunk))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self.epoch
        if self.prefetch <= 0:
            yield from self._iter_batches()
        else:
            yield from _threaded(self._iter_batches(), self.prefetch)
        self.epoch += 1


def _threaded(it: Iterator, depth: int) -> Iterator:
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # surface exceptions in the consumer
            q.put(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def infinite_batches(loader: DataLoader) -> Iterator[Dict[str, Any]]:
    """Step-based training iterator (the reference trains by max_steps)."""
    while True:
        yield from loader


class CachedDataset:
    """RAM cache of a deterministic inner dataset's decoded+transformed items.

    The single host core decodes ~46 imgs/sec at res 224 while the chip
    consumes ~300 — for datasets that fit in RAM (Potsdam, directory sets),
    caching the base items removes the host bottleneck after the first epoch.
    Only wrap datasets whose __getitem__ is deterministic per index (center /
    five-crop trees; NOT loader_crop_type="random"). The pair sampling and
    augmentations of ContrastiveSegDataset stay per-epoch random on top.

    (The reference's MaterializedDataset, data.py:403-416, eagerly does the
    same but is dead code there.)
    """

    def __init__(self, dataset):
        self.dataset = dataset
        self._cache: dict = {}

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __getitem__(self, index):
        hit = self._cache.get(index)
        if hit is None:
            hit = self.dataset[index]
            self._cache[index] = hit
        return hit


class DiskCachedDataset:
    """On-disk ``.npz`` cache of a deterministic inner dataset's items.

    Complements :class:`CachedDataset` (RAM): survives process restarts — the
    crop -> precompute_knns -> train -> eval pipeline otherwise re-decodes the
    same images in every stage — and covers datasets larger than RAM. Items
    are stored as they are (the JAX package's cache packs them into uint8 and
    int16; that packing is not ported), so a read gives the arrays the inner
    dataset gave. A ``meta.json`` signature (dataset class, length, storage
    format, item structure) guards against reusing a stale cache, or one the
    JAX package wrote, for a different configuration.

    Only wrap datasets whose ``__getitem__`` is deterministic per index
    (center/five-crop trees; NOT loader_crop_type="random").
    """

    def __init__(self, dataset, cache_dir: str, signature: dict | None = None):
        import json
        import os

        self.dataset = dataset
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        sig = {"cls": type(dataset).__name__, "len": len(dataset),
               "format": "raw"}
        sig.update(signature or {})
        meta_path = os.path.join(cache_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                old = json.load(f)
            if old != sig:
                raise ValueError(
                    f"disk cache at {cache_dir} was built for {old}, "
                    f"current dataset is {sig}; delete the cache dir or "
                    "point cache_dataset_dir elsewhere"
                )
        else:
            with open(meta_path, "w") as f:
                json.dump(sig, f)

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def _path(self, index: int) -> str:
        import os

        return os.path.join(self.cache_dir, f"{index:08d}.npz")

    def __getitem__(self, index):
        import os

        path = self._path(index)
        if os.path.exists(path):
            with np.load(path, allow_pickle=False) as z:
                return tuple(z[f"a{i}"] for i in range(int(z["n"])))
        item = tuple(self.dataset[index])
        arrays = {"n": np.int64(len(item))}
        for i, v in enumerate(item):
            arrays[f"a{i}"] = np.asarray(v)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # file handle: savez won't append ".npz"
            np.savez(f, **arrays)
        os.replace(tmp, path)  # atomic: concurrent readers never see partials
        return item
