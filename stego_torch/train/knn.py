"""KNN index of a split; counterpart of ``stego_tpu/train/knn.py``.

Behavioural reference: src/precompute_knns.py. Every image is embedded as
the l2-normalised spatial mean of its frozen-trunk features (at res 224 in
the reference), then the all-pairs cosine similarities of the split give
each image its top 30 neighbours (itself first). The similarity matrix is
built in row chunks, one matmul and one ``torch.topk`` a chunk, and the
result is saved as the reference's compressed ``.npz`` with key ``nns``
under the reference's file name (:func:`knn_cache_file`), so caches pass
between the reference, the JAX package and the port.

Everything runs on the device of the featurizer's weights (the card, unless
the caller put the segmenter on the CPU). Over W processes
(``parallel/dist.py``, ``knn.py:54-113``) rank r embeds batches r, r + W,
... of the one-process loader (:func:`stripe_loader`), the ranks gather the
table, each takes the top-k of its stripe of the row chunks, those are
gathered too and rank 0 writes the file: every image is embedded once, in
the batch a single process would embed it in, so the file is the
one-process file row for row. ``train/knn_app.py`` (``python -m
stego_torch.train.knn_app``) builds the caches of whole datasets.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from stego_torch.data.loader import DataLoader
from stego_torch.models.featurizer import DinoFeaturizer
from stego_torch.ops.math import l2_normalize
from stego_torch.parallel import dist


def knn_cache_file(pytorch_data_dir: str, model_type: str, dataset_name: str,
                   image_set: str, crop_type, res: int) -> str:
    """The KNN cache's path (reference data.py:503-504,
    precompute_knns.py:66-67); the port's copy of
    ``stego_tpu/data/contrastive.py:knn_cache_file``."""
    return join(
        pytorch_data_dir, "nns",
        f"nns_{model_type}_{dataset_name}_{image_set}_{crop_type}_{res}.npz",
    )


def make_embed_fn(net: DinoFeaturizer
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """img (B, H, W, 3) -> (B, n_feats) f32: the trunk's features, their
    spatial mean, l2-normalised (reference get_feats,
    precompute_knns.py:15-21). Runs on the device of ``net``'s weights."""
    device = next(net.parameters()).device

    @torch.no_grad()
    def embed(img: torch.Tensor) -> torch.Tensor:
        feats = net.backbone_features(torch.as_tensor(img).to(device))
        return l2_normalize(feats.float().mean(dim=(1, 2)), dim=1)

    return embed


class _Rows:
    """The items ``rows`` of ``dataset``, as a dataset."""

    def __init__(self, dataset, rows: Sequence[int]):
        self.dataset, self.rows = dataset, list(rows)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int):
        return self.dataset[self.rows[i]]


def stripe_loader(dataset, batch_size: int, num_threads: int = 0
                  ) -> Tuple[DataLoader, List[int]]:
    """This rank's batches of an unshuffled loader of ``batch_size`` over
    ``dataset`` (batches rank, rank + W, ...; all of them for one process),
    as a loader, and the dataset rows they hold, in order."""
    n, w = len(dataset), dist.world()
    rows = [i for s in range(dist.rank() * batch_size, n, w * batch_size)
            for i in range(s, min(s + batch_size, n))]
    return DataLoader(_Rows(dataset, rows), batch_size, shuffle=False,
                      drop_last=False, num_threads=num_threads), rows


def embed_dataset(embed_fn: Callable[[torch.Tensor], torch.Tensor],
                  loader: Iterable) -> torch.Tensor:
    """(N, D) normalised embeddings of every batch of ``loader`` (a batch is
    an image tensor or array, or a dict with ``img``), on the embedding's
    device."""
    chunks = []
    for batch in loader:
        img = batch["img"] if isinstance(batch, dict) else batch
        chunks.append(embed_fn(img))
    return torch.cat(chunks)


def topk_neighbors(feats: Union[torch.Tensor, np.ndarray], k: int = 30,
                   n_chunks: int = 16, max_sims_bytes: int = 1 << 30
                   ) -> np.ndarray:
    """Row-chunked all-pairs cosine top-k (reference
    precompute_knns.py:86-94): (N, min(k, N)) int32 neighbour indices, most
    similar first. Each chunk of rows is one f32 matmul against the whole
    table and one ``torch.topk``; the chunk has N // n_chunks rows, capped
    so that its similarity block stays under ``max_sims_bytes``
    (``knn.py:52-99``). Runs on the tensor's device, or on the first CUDA
    device for a numpy array. Over several processes, which all hold the
    table, rank r takes chunks r, r + W, ... and the ranks gather the
    result."""
    device = feats.device if isinstance(feats, torch.Tensor) else "cuda:0"
    table = torch.as_tensor(feats).to(device=device, dtype=torch.float32)
    n = table.shape[0]
    k = min(k, n)
    step = max(1, n // n_chunks)
    step = min(step, max(1, max_sims_bytes // (4 * n)))
    out, rows = [], []
    for i in range(dist.rank() * step, n, dist.world() * step):
        sims = table[i:i + step] @ table.T
        out.append(torch.topk(sims, k, dim=1).indices.to(torch.int32))
        rows += range(i, min(i + step, n))
    out = torch.cat(out) if out else torch.zeros((0, k), dtype=torch.int32,
                                                  device=device)
    if dist.world() > 1:
        out = dist.gather_stripes(out, rows, n)
    return out.cpu().numpy()


def build_knn_cache(cache_file: str, net: DinoFeaturizer, loader: Iterable,
                    k: int = 30, rows: Optional[Sequence[int]] = None,
                    n: Optional[int] = None) -> np.ndarray:
    """Embed every image of ``loader``, take the top-k and save the
    compressed ``.npz`` (key ``nns``), as the reference does. Returns
    nns. Over several processes ``loader`` holds this rank's images, rows
    ``rows`` of the split of ``n`` (:func:`stripe_loader`); every rank
    returns the whole table and rank 0 writes it."""
    if rows is None or len(rows):
        feats = embed_dataset(make_embed_fn(net), loader)
    else:  # a rank with no batch of its own
        feats = torch.zeros((0, net.n_feats),
                            device=next(net.parameters()).device)
    if dist.world() > 1:
        feats = dist.gather_stripes(feats, rows, n)
    nns = topk_neighbors(feats, k=k)
    if dist.is_primary():
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        np.savez_compressed(cache_file, nns=nns)
    dist.barrier()
    return nns
