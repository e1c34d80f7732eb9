"""ContrastiveSegDataset: the training-facing dataset wrapper; counterpart
of ``stego_tpu/data/contrastive.py``.

Behavioral reference: src/data.py:419-565. Same responsibilities:
dataset dispatch with per-dataset ``n_classes``, KNN ``.npz`` cache lookup
(the reference's file names, so caches pass between the reference, the JAX
package and the port), KNN-positive sampling (self at index 0 skipped), the
coordinate grid for aug alignment, and the dict item contract consumed by
the train step. Randomness comes from explicit per-(seed, epoch, index)
Generators. :meth:`ContrastiveSegDataset.from_items` wraps items already in
memory (and their KNN table) with the same item contract.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from stego_torch.data.datasets import (
    CityscapesSeg,
    Coco,
    CroppedDataset,
    DirectoryDataset,
    Potsdam,
    PotsdamRaw,
)
from stego_torch.data.transforms import (
    apply_geometric,
    apply_photometric,
    make_coord_grid,
    normalize,
    sample_geometric_params,
    sample_photometric_params,
    unnormalize,
)
from stego_torch.train.knn import knn_cache_file


def dataset_nice_name(cfg, dataset_name: str) -> str:
    """Dataset label used in KNN cache filenames. potsdam_ir embeds in a
    distinct (4-channel) feature space, so its caches must not collide with
    RGB-only ones."""
    nice = cfg.dir_dataset_name if dataset_name == "directory" \
        else dataset_name
    if getattr(cfg, "potsdam_ir", False) and \
            str(dataset_name).startswith("potsdam"):
        nice = f"{nice}_ir4"
    return nice


def dataset_dispatch(dataset_name: str, crop_type, cfg) -> Dict[str, Any]:
    """Dataset table with class counts (reference data.py:447-486)."""
    if dataset_name == "potsdam":
        return dict(n_classes=3, cls=Potsdam,
                    extra=dict(coarse_labels=True,
                               include_ir=getattr(cfg, "potsdam_ir", False)))
    if dataset_name == "potsdamraw":
        return dict(n_classes=3, cls=PotsdamRaw,
                    extra=dict(coarse_labels=True,
                               include_ir=getattr(cfg, "potsdam_ir", False)))
    if dataset_name == "directory":
        return dict(n_classes=cfg.dir_dataset_n_classes, cls=DirectoryDataset,
                    extra=dict(path=cfg.dir_dataset_name))
    if dataset_name == "cityscapes" and crop_type is None:
        return dict(n_classes=27, cls=CityscapesSeg, extra=dict())
    if dataset_name == "cityscapes":
        return dict(n_classes=27, cls=CroppedDataset,
                    extra=dict(dataset_name="cityscapes", crop_type=crop_type,
                               crop_ratio=cfg.crop_ratio))
    if dataset_name == "cocostuff3":
        return dict(n_classes=3, cls=Coco,
                    extra=dict(coarse_labels=True, subset=6,
                               exclude_things=True))
    if dataset_name == "cocostuff15":
        return dict(n_classes=15, cls=Coco,
                    extra=dict(coarse_labels=False, subset=7,
                               exclude_things=True))
    if dataset_name == "cocostuff27" and crop_type is not None:
        return dict(n_classes=27, cls=CroppedDataset,
                    extra=dict(dataset_name="cocostuff27", crop_type=crop_type,
                               crop_ratio=cfg.crop_ratio))
    if dataset_name == "cocostuff27":
        return dict(n_classes=27, cls=Coco,
                    extra=dict(coarse_labels=False, subset=None,
                               exclude_things=False))
    raise ValueError(f"Unknown dataset: {dataset_name}")


class ContrastiveSegDataset:
    def __init__(
        self,
        pytorch_data_dir: str,
        dataset_name: str,
        crop_type: Optional[str],
        image_set: str,
        transform,
        target_transform,
        cfg,
        aug_geometric: bool = False,
        aug_photometric: bool = False,
        num_neighbors: int = 5,
        mask: bool = False,
        pos_labels: bool = False,
        pos_images: bool = False,
        extra_transform=None,
        model_type_override: Optional[str] = None,
        seed: int = 0,
    ):
        self.num_neighbors = num_neighbors
        self.image_set = image_set
        self.dataset_name = dataset_name
        self.mask = mask
        self.pos_labels = pos_labels
        self.pos_images = pos_images
        self.extra_transform = extra_transform
        self.aug_geometric = aug_geometric
        self.aug_photometric = aug_photometric
        self.res = cfg.res
        self.seed = seed
        self.epoch = 0  # bump to reshuffle pair/aug draws across epochs

        disp = dataset_dispatch(dataset_name, crop_type, cfg)
        self.n_classes = disp["n_classes"]
        # cocostuff27 val uses the IIC-fine curated subset when uncropped
        # (reference data.py:483-484)
        extra = dict(disp["extra"])
        if dataset_name == "cocostuff27" and crop_type is None and \
                image_set == "val":
            extra["subset"] = 7
        self.dataset = disp["cls"](
            root=pytorch_data_dir, image_set=image_set, transform=transform,
            target_transform=target_transform, seed=seed, **extra,
        )

        model_type = model_type_override or cfg.model_type
        nice_name = dataset_nice_name(cfg, dataset_name)
        self.feature_cache_file = knn_cache_file(
            pytorch_data_dir, model_type, nice_name, image_set, crop_type,
            cfg.res,
        )
        if pos_labels or pos_images:
            if not os.path.exists(self.feature_cache_file):
                raise ValueError(
                    f"could not find nn file {self.feature_cache_file} "
                    "please run precompute_knns"
                )
            self.nns = np.load(self.feature_cache_file)["nns"]
            assert len(self.dataset) == self.nns.shape[0]

    @classmethod
    def from_items(cls, dataset: Sequence, n_classes: int,
                   nns: Optional[np.ndarray] = None, num_neighbors: int = 5,
                   mask: bool = True, seed: int = 0
                   ) -> "ContrastiveSegDataset":
        """A dataset over ``dataset``, any sequence of (img, label, mask)
        items such as a base dataset already built or arrays in memory,
        with ``__getitem__``'s item contract and draws; ``nns`` (the KNN
        table, self first) turns on the positives (``img_pos``,
        ``label_pos``, ``mask_pos``, ``ind_pos``)."""
        self = cls.__new__(cls)
        self.dataset = dataset
        self.n_classes = n_classes
        self.nns = nns
        self.num_neighbors = num_neighbors
        self.mask = mask
        self.pos_images = self.pos_labels = nns is not None
        self.extra_transform = None
        self.aug_geometric = self.aug_photometric = False
        self.seed = seed
        self.epoch = 0
        if nns is not None and len(dataset) != nns.shape[0]:
            raise ValueError(f"{len(dataset)} items but a KNN table of "
                             f"{nns.shape[0]} rows")
        return self

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, ind: int) -> Dict[str, Any]:
        rng = np.random.default_rng((self.seed, self.epoch, ind))
        pack = self.dataset[ind]

        if self.pos_images or self.pos_labels:
            # neighbor index 0 is self — skipped (reference data.py:524)
            nn_choice = int(rng.integers(1, self.num_neighbors + 1))
            ind_pos = int(self.nns[ind][nn_choice])
            pack_pos = self.dataset[ind_pos]

        extra_trans = self.extra_transform or (lambda i, x: x)

        ret: Dict[str, Any] = {
            "ind": ind,
            "img": extra_trans(ind, pack[0]),
            "label": extra_trans(ind, pack[1]),
        }
        if self.pos_images:
            ret["img_pos"] = extra_trans(ind, pack_pos[0])
            ret["ind_pos"] = ind_pos
        if self.mask:
            ret["mask"] = pack[2]
        if self.pos_labels:
            ret["label_pos"] = extra_trans(ind, pack_pos[1])
            ret["mask_pos"] = pack_pos[2]

        if self.aug_photometric or self.aug_geometric:
            img = pack[0]
            h, w = img.shape[:2]
            coord = make_coord_grid(h, w)
            if self.aug_geometric:
                gp = sample_geometric_params(rng, h, w, out_res=h)
                img_aug = apply_geometric(img, gp)
                coord_aug = apply_geometric(coord, gp)
            else:
                img_aug, coord_aug = img, coord
            if self.aug_photometric:
                pp = sample_photometric_params(rng)
                img_aug = normalize(
                    apply_photometric(np.clip(unnormalize(img_aug), 0, 1), pp)
                )
            ret["img_aug"] = img_aug.astype(np.float32)
            ret["coord_aug"] = coord_aug.astype(np.float32)
        return ret
