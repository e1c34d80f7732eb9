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
the caller put the segmenter on the CPU). Several GPUs are ROADMAP.md queue
1, Multi-GPU (DDP); the ``knn_app`` entry point waits for the train app
(Train app, checkpoints, logging and the app entry points).
"""

from __future__ import annotations

import os
from os.path import join
from typing import Callable, Iterable, Union

import numpy as np
import torch

from stego_torch.models.featurizer import DinoFeaturizer
from stego_torch.ops.math import l2_normalize


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
    device for a numpy array."""
    device = feats.device if isinstance(feats, torch.Tensor) else "cuda:0"
    table = torch.as_tensor(feats).to(device=device, dtype=torch.float32)
    n = table.shape[0]
    k = min(k, n)
    step = max(1, n // n_chunks)
    step = min(step, max(1, max_sims_bytes // (4 * n)))
    out = []
    for i in range(0, n, step):
        sims = table[i:i + step] @ table.T
        out.append(torch.topk(sims, k, dim=1).indices)
    return torch.cat(out).to(torch.int32).cpu().numpy()


def build_knn_cache(cache_file: str, net: DinoFeaturizer, loader: Iterable,
                    k: int = 30) -> np.ndarray:
    """Embed every image of ``loader``, take the top-k and save the
    compressed ``.npz`` (key ``nns``), as the reference does. Returns
    nns."""
    feats = embed_dataset(make_embed_fn(net), loader)
    nns = topk_neighbors(feats, k=k)
    os.makedirs(os.path.dirname(cache_file), exist_ok=True)
    np.savez_compressed(cache_file, nns=nns)
    return nns
