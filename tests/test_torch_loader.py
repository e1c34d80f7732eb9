"""stego_torch's loader (``stego_torch/data/loader.py``) against the JAX
package's: the same index order per epoch and shard, the same batches
after ``fast_forward``, and the same arrays from the RAM and disk caches
of a dataset."""

import os

import numpy as np
import pytest

from stego_tpu.data import datasets as jax_datasets
from stego_tpu.data import loader as jax_loader
from stego_tpu.data import transforms as jax_transforms
from stego_torch.data import datasets, loader, transforms

from tests.test_data import synthetic_dir  # noqa: F401
from tests._torch_cpu import one_intra_op_thread  # noqa: F401


class Items:
    """Item i: its index, a per-index array and a label map."""

    def __init__(self, n=23):
        self.n = n
        self.epoch = 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.epoch, i))
        return {"ind": i, "x": rng.standard_normal((3, 2)).astype(np.float32),
                "label": rng.integers(-1, 5, (2, 2))}


def batches(mod, epochs=2, skip=0, **kw):
    dl = mod.DataLoader(Items(), **kw)
    if skip:
        dl.fast_forward(skip)
    return [b for _ in range(epochs) for b in dl], len(dl)


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shards", [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_loader_order_matches_jax(shuffle, drop_last, shards):
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, drop_last=drop_last,
              num_shards=shards[0], shard_index=shards[1])
    want, nb = batches(jax_loader, **kw)
    got, n = batches(loader, **kw)
    assert n == nb
    assert_batches_equal(got, want)


@pytest.mark.parametrize("skip", [1, 5, 7, 12])
@pytest.mark.parametrize("threads,prefetch", [(0, 0), (3, 2)])
def test_fast_forward_matches_jax(skip, threads, prefetch):
    """fast_forward(n) lands on the batch a fresh loader gives after n,
    in the same epoch, with threads and prefetch or without."""
    kw = dict(batch_size=4, shuffle=True, seed=1, num_threads=threads,
              prefetch=prefetch)
    want, _ = batches(jax_loader, skip=skip, **kw)
    got, _ = batches(loader, skip=skip, **kw)
    assert_batches_equal(got, want)
    fresh, _ = batches(loader, epochs=5, **kw)
    assert_batches_equal(got, fresh[skip:skip + len(got)])


def test_collate_threads_and_infinite_batches_match_jax():
    items = [Items()[i] for i in range(3)]
    want, got = jax_loader.collate(items), loader.collate(items)
    assert_batches_equal([got], [want])
    for n in (0, 1, 3, 10_000):
        assert loader.effective_threads(n) == jax_loader.effective_threads(n)
    want_it = jax_loader.infinite_batches(jax_loader.DataLoader(
        Items(7), 3, shuffle=True))
    got_it = loader.infinite_batches(loader.DataLoader(Items(7), 3,
                                                       shuffle=True))
    assert_batches_equal([next(got_it) for _ in range(7)],
                         [next(want_it) for _ in range(7)])


def test_threaded_prefetch_raises_the_worker_error():
    class Broken(Items):
        def __getitem__(self, i):
            if i == 6:
                raise KeyError("item 6")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="item 6"):
        list(loader.DataLoader(Broken(), 3, prefetch=2))


def directory(mod, tmod, root, split="train"):
    return mod.DirectoryDataset(
        root, "synth", split, tmod.get_transform(16, False, "center"),
        tmod.get_transform(16, True, "center"))


def test_cached_datasets_match_jax(synthetic_dir, tmp_path):  # noqa: F811
    """CachedDataset and DiskCachedDataset give the inner dataset's items,
    as the JAX package's do, on the first read, on a cached read and from
    a new instance over the same directory; a cache made for another
    signature raises."""
    want = jax_loader.CachedDataset(directory(jax_datasets, jax_transforms,
                                              synthetic_dir))
    ram = loader.CachedDataset(directory(datasets, transforms,
                                         synthetic_dir))
    sig = {"res": 16}
    jdisk = jax_loader.DiskCachedDataset(
        directory(jax_datasets, jax_transforms, synthetic_dir),
        str(tmp_path / "jax"), signature=sig)
    disks = [loader.DiskCachedDataset(
        directory(datasets, transforms, synthetic_dir), str(tmp_path / "pt"),
        signature=sig) for _ in range(2)]
    assert len(ram) == len(want) == len(disks[0]) == 8
    assert ram.split == "train"  # attributes pass through
    for reader in (ram, disks[0], disks[0], disks[1]):
        for i in range(len(want)):
            for w, g, jd in zip(want[i], reader[i], jdisk[i]):
                w, g, jd = np.asarray(w), np.asarray(g), np.asarray(jd)
                assert g.dtype == w.dtype == jd.dtype
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(jd, w)
    assert len(os.listdir(tmp_path / "pt")) == 8 + 1  # items + meta.json
    with pytest.raises(ValueError, match="was built for"):
        loader.DiskCachedDataset(directory(datasets, transforms,
                                           synthetic_dir),
                                 str(tmp_path / "pt"), signature={"res": 32})
    with pytest.raises(ValueError, match="was built for"):
        loader.DiskCachedDataset(directory(datasets, transforms,
                                           synthetic_dir),
                                 str(tmp_path / "jax"), signature=sig)
