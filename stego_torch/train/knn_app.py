"""``python -m stego_torch.train.knn_app key=value ...``: the KNN
precompute; counterpart of ``stego_tpu/train/knn_app.py`` and of
``precompute_knns.py``.

Behavioral reference: src/precompute_knns.py. For each (crop_type, split,
dataset) every image is embedded with the frozen trunk at res 224, the
top-``knn_k`` cosine neighbour table is built and saved as the compressed
``.npz`` cache (``train/knn.py:build_knn_cache``). Caches that exist are
skipped. ``main`` runs on the card and exits with an error when there is
none; a caller of :func:`precompute_knns` can pass the CPU. Several
processes (``num_devices``, or ``python -m torch.distributed.run``) split
the embedding, as the training app does (``parallel/dist.py:launch``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import torch

from stego_torch.config import Config
from stego_torch.data.contrastive import (ContrastiveSegDataset,
                                          dataset_nice_name)
from stego_torch.data.loader import effective_threads
from stego_torch.data.transforms import get_transform
from stego_torch.kernels import build
from stego_torch.models.vit import ViTConfig
from stego_torch.parallel import dist
from stego_torch.train.knn import (build_knn_cache, knn_cache_file,
                                   stripe_loader)
from stego_torch.utils.precision import full_f32_for

KNN_RES = 224  # reference precompute_knns.py:47
EMBED_BATCH = 256  # reference loader batch (:82)


def precompute_knns(
    cfg: Config,
    dataset_names: Optional[Sequence[str]] = None,
    image_sets: Sequence[str] = ("val", "train"),
    crop_types: Sequence = ("five", None),
    vit_cfg: Optional[ViTConfig] = None,
    res: int = KNN_RES,
    batch_size: int = EMBED_BATCH,
    device: Union[str, torch.device, None] = None,
) -> List[str]:
    """Write the missing KNN caches; returns the files written. The trunk
    is the segmenter's (``cfg.pretrained_weights``, or its seeded random
    init), on ``device`` (default ``cuda:LOCAL_RANK``). Every process of a
    group calls it; each embeds its stripe of every split."""
    from stego_torch.train.app import build_backbone
    from stego_torch.train.segmenter import UnsupervisedSegmenter

    if dataset_names is None:
        dataset_names = [cfg.dataset_name]
    device = dist.device() if device is None else device
    full_f32_for(cfg.backbone_dtype)
    net = None
    written = []
    for crop_type in crop_types:
        for image_set in image_sets:
            for dataset_name in dataset_names:
                nice = dataset_nice_name(cfg, dataset_name)
                cache = knn_cache_file(cfg.pytorch_data_dir, cfg.model_type,
                                       nice, image_set, crop_type, res)
                if os.path.exists(cache):
                    continue
                print(f"{cache} not found, computing")
                dataset = ContrastiveSegDataset(
                    pytorch_data_dir=cfg.pytorch_data_dir,
                    dataset_name=dataset_name,
                    crop_type=crop_type,
                    image_set=image_set,
                    transform=get_transform(res, False, "center"),
                    target_transform=get_transform(res, True, "center"),
                    cfg=cfg.replace(res=res),
                    seed=cfg.seed,
                )
                if net is None:
                    # the trunk of a segmenter of any head (the embedding
                    # reads only the trunk's features)
                    seg = UnsupervisedSegmenter(
                        dataset.n_classes, cfg, vit_cfg=vit_cfg,
                        generator=torch.Generator().manual_seed(cfg.seed))
                    build_backbone(cfg, seg)
                    net = seg.net.to(device).eval()
                    if net.backbone_dtype == torch.bfloat16:
                        net.model.cast_blocks(torch.bfloat16)
                loader, rows = stripe_loader(
                    dataset, min(batch_size, len(dataset)),
                    effective_threads(cfg.num_workers))
                build_knn_cache(cache, net, loader,
                                k=min(cfg.knn_k, len(dataset)), rows=rows,
                                n=len(dataset))
                written.append(cache)
                print("Saved NNs", cfg.model_type, nice, image_set)
    return written


def main(argv=None):
    from stego_torch.config import prep_args

    overrides = prep_args(argv)
    base = overrides.pop("config", None)
    cfg = (Config.from_yaml(base, **overrides) if base
           else Config.from_dict(overrides, strict=True))
    if not torch.cuda.is_available():
        raise SystemExit("stego_torch.train.knn_app runs on a CUDA device "
                         "and found none; nothing was written")
    dist.launch(_precompute, cfg.num_devices, cfg, prepare=build.build)


def _precompute(cfg: Config) -> None:
    """One process's part of ``main``."""
    if cfg.dataset_name == "directory":
        precompute_knns(cfg, crop_types=[None])
    else:
        precompute_knns(cfg)


if __name__ == "__main__":
    main()
