"""Dataset classes (host side, numpy outputs); counterpart of
``stego_tpu/data/datasets.py``.

Behavioral reference: src/data.py:75-400. Same on-disk formats and label
mappings, but: explicit per-sample numpy Generators replace the global
seed-reset hack for paired img/label transforms, outputs are HWC float32 /
HW int64 numpy arrays, and file walking needs no torchvision. PIL and scipy
are imported inside the functions that read files.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Dict, List

import numpy as np

from stego_torch.data.transforms import Transform

# Potsdam fine->coarse mapping (reference data.py:144-148)
POTSDAM_FINE_TO_COARSE = {0: 0, 4: 0, 1: 1, 5: 1, 2: 2, 3: 2, 255: -1}

# CocoStuff 182-fine -> 27-coarse (reference data.py:267-283)
COCO_FINE_TO_COARSE = {
    0: 9, 1: 11, 2: 11, 3: 11, 4: 11, 5: 11, 6: 11, 7: 11, 8: 11, 9: 8, 10: 8,
    11: 8, 12: 8, 13: 8, 14: 8, 15: 7, 16: 7, 17: 7, 18: 7, 19: 7, 20: 7,
    21: 7, 22: 7, 23: 7, 24: 7, 25: 6, 26: 6, 27: 6, 28: 6, 29: 6, 30: 6,
    31: 6, 32: 6, 33: 10, 34: 10, 35: 10, 36: 10, 37: 10, 38: 10, 39: 10,
    40: 10, 41: 10, 42: 10, 43: 5, 44: 5, 45: 5, 46: 5, 47: 5, 48: 5, 49: 5,
    50: 5, 51: 2, 52: 2, 53: 2, 54: 2, 55: 2, 56: 2, 57: 2, 58: 2, 59: 2,
    60: 2, 61: 3, 62: 3, 63: 3, 64: 3, 65: 3, 66: 3, 67: 3, 68: 3, 69: 3,
    70: 3, 71: 0, 72: 0, 73: 0, 74: 0, 75: 0, 76: 0, 77: 1, 78: 1, 79: 1,
    80: 1, 81: 1, 82: 1, 83: 4, 84: 4, 85: 4, 86: 4, 87: 4, 88: 4, 89: 4,
    90: 4, 91: 17, 92: 17, 93: 22, 94: 20, 95: 20, 96: 22, 97: 15, 98: 25,
    99: 16, 100: 13, 101: 12, 102: 12, 103: 17, 104: 17, 105: 23, 106: 15,
    107: 15, 108: 17, 109: 15, 110: 21, 111: 15, 112: 25, 113: 13, 114: 13,
    115: 13, 116: 13, 117: 13, 118: 22, 119: 26, 120: 14, 121: 14, 122: 15,
    123: 22, 124: 21, 125: 21, 126: 24, 127: 20, 128: 22, 129: 15, 130: 17,
    131: 16, 132: 15, 133: 22, 134: 24, 135: 21, 136: 17, 137: 25, 138: 16,
    139: 21, 140: 17, 141: 22, 142: 16, 143: 21, 144: 21, 145: 25, 146: 21,
    147: 26, 148: 21, 149: 24, 150: 20, 151: 17, 152: 14, 153: 21, 154: 26,
    155: 15, 156: 23, 157: 20, 158: 21, 159: 24, 160: 15, 161: 24, 162: 22,
    163: 25, 164: 15, 165: 20, 166: 17, 167: 17, 168: 22, 169: 14, 170: 18,
    171: 18, 172: 18, 173: 18, 174: 18, 175: 18, 176: 18, 177: 26, 178: 26,
    179: 19, 180: 19, 181: 24,
}


def _apply_mapping(label: np.ndarray, mapping: Dict[int, int]) -> np.ndarray:
    out = np.zeros_like(label)
    for fine, coarse in mapping.items():
        out[label == fine] = coarse
    return out


def _paired_transform(img, label, transform: Transform,
                      target_transform: Transform, rng: np.random.Generator,
                      force_rgb: bool = False):
    """Apply img/label transforms with ONE shared random state so random crops
    align (replaces the reference's seed-reset coupling, data.py:102-110).
    ``img``/``label`` may be PIL Images or file paths (paths take the native
    fused-decode fast path; ``force_rgb`` replaces the reference's
    ``Image.open(...).convert("RGB")``)."""
    state = rng.bit_generator.state
    r1 = np.random.default_rng()
    r1.bit_generator.state = state
    img_t = transform(img, r1, force_rgb=force_rgb)
    r2 = np.random.default_rng()
    r2.bit_generator.state = state
    label_t = target_transform(label, r2) if label is not None else None
    return img_t, label_t


class DirectoryDataset:
    """Bring-your-own-data layout: ``{root}/{path}/imgs/{split}`` (+ optional
    ``labels/{split}``); label -1 everywhere when labels are absent
    (reference data.py:75-119, README.md:109-129)."""

    def __init__(self, root, path, image_set, transform, target_transform,
                 seed: int = 0):
        self.split = image_set
        self.dir = join(root, path)
        self.img_dir = join(self.dir, "imgs", self.split)
        self.label_dir = join(self.dir, "labels", self.split)
        self.transform = transform
        self.target_transform = target_transform
        self.img_files = np.array(sorted(os.listdir(self.img_dir)))
        assert len(self.img_files) > 0
        if os.path.exists(join(self.dir, "labels")):
            self.label_files = np.array(sorted(os.listdir(self.label_dir)))
            assert len(self.img_files) == len(self.label_files)
        else:
            self.label_files = None
        self.seed = seed

    def __len__(self):
        return len(self.img_files)

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        img = join(self.img_dir, self.img_files[index])
        label_img = (
            join(self.label_dir, self.label_files[index])
            if self.label_files is not None else None
        )
        img_t, label_t = _paired_transform(
            img, label_img, self.transform, self.target_transform, rng
        )
        if label_t is None:
            label_t = np.full(img_t.shape[:2], -1, dtype=np.int64)
        mask = (label_t > 0).astype(np.float32)
        return img_t, label_t, mask


class _PotsdamBase:
    fine_to_coarse = POTSDAM_FINE_TO_COARSE
    include_ir = False  # keep the 4th (near-IR) channel as PIL RGBA
    # (the reference drops IR with a TODO, data.py:153; potsdam_ir=true keeps
    # it — pair with ViTConfig.in_chans=4 / config potsdam_ir)

    def _load_pair(self, img_path: str, gt_path: str):
        from PIL import Image
        from scipy.io import loadmat

        img = loadmat(img_path)["img"]
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (arr * 255).astype(np.uint8)
        if self.include_ir and arr.shape[-1] < 4:
            raise ValueError(
                f"potsdam_ir=true but {img_path} has only {arr.shape[-1]} "
                "channels (no IR band)"
            )
        nc = 4 if self.include_ir else 3
        img = Image.fromarray(arr[:, :, :nc], mode="RGBA" if nc == 4 else None)
        try:
            gt = loadmat(gt_path)["gt"]
            label = Image.fromarray(np.asarray(gt).astype(np.uint8))
        except FileNotFoundError:
            label = Image.fromarray(
                np.ones((img.height, img.width), dtype=np.uint8)
            )
        return img, label

    def _finish(self, index, img, label, transform, target_transform,
                coarse_labels, seed):
        rng = np.random.default_rng((seed, index))
        img_t, label_t = _paired_transform(img, label, transform,
                                           target_transform, rng)
        if coarse_labels:
            label_t = _apply_mapping(label_t, self.fine_to_coarse)
        mask = (label_t > 0).astype(np.float32)
        return img_t, label_t, mask


class Potsdam(_PotsdamBase):
    """Potsdam-3 .mat tiles with split txt files (reference data.py:121-178)."""

    SPLIT_FILES = {
        "train": ["labelled_train.txt"],
        "unlabelled_train": ["unlabelled_train.txt"],
        "val": ["labelled_test.txt"],
        "train+val": ["labelled_train.txt", "labelled_test.txt"],
        "all": ["all.txt"],
    }

    def __init__(self, root, image_set, transform, target_transform,
                 coarse_labels, seed: int = 0, include_ir: bool = False):
        self.root = os.path.join(root, "potsdam")
        self.include_ir = include_ir
        assert image_set in self.SPLIT_FILES
        self.files: List[str] = []
        for split_file in self.SPLIT_FILES[image_set]:
            with open(join(self.root, split_file)) as f:
                self.files.extend(fn.rstrip() for fn in f.readlines())
        self.transform = transform
        self.target_transform = target_transform
        self.coarse_labels = coarse_labels
        self.seed = seed

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        image_id = self.files[index]
        img, label = self._load_pair(
            join(self.root, "imgs", image_id + ".mat"),
            join(self.root, "gt", image_id + ".mat"),
        )
        return self._finish(index, img, label, self.transform,
                            self.target_transform, self.coarse_labels, self.seed)


class PotsdamRaw(_PotsdamBase):
    """38x15x15 raw tile grid (reference data.py:181-229)."""

    def __init__(self, root, image_set, transform, target_transform,
                 coarse_labels, seed: int = 0, include_ir: bool = False):
        self.root = os.path.join(root, "potsdamraw", "processed")
        self.include_ir = include_ir
        self.files = [
            f"{im}_{ih}_{iw}.mat"
            for im in range(38) for ih in range(15) for iw in range(15)
        ]
        self.transform = transform
        self.target_transform = target_transform
        self.coarse_labels = coarse_labels
        self.seed = seed

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        fid = self.files[index]
        img, label = self._load_pair(
            join(self.root, "imgs", fid), join(self.root, "gt", fid)
        )
        return self._finish(index, img, label, self.transform,
                            self.target_transform, self.coarse_labels, self.seed)


class Coco:
    """CocoStuff with curated list files and fine->coarse mapping
    (reference data.py:232-322)."""

    def __init__(self, root, image_set, transform, target_transform,
                 coarse_labels, exclude_things, subset=None, seed: int = 0):
        self.root = join(root, "cocostuff")
        self.coarse_labels = coarse_labels
        self.transform = transform
        self.label_transform = target_transform
        self.subset = subset
        self.exclude_things = exclude_things
        self.seed = seed

        if subset is None:
            image_list = "Coco164kFull_Stuff_Coarse.txt"
        elif subset == 6:  # IIC Coarse
            image_list = "Coco164kFew_Stuff_6.txt"
        elif subset == 7:  # IIC Fine
            image_list = "Coco164kFull_Stuff_Coarse_7.txt"
        else:
            raise ValueError(f"Unknown subset {subset}")

        assert image_set in ("train", "val", "train+val")
        split_dirs = {
            "train": ["train2017"], "val": ["val2017"],
            "train+val": ["train2017", "val2017"],
        }[image_set]

        self.image_files: List[str] = []
        self.label_files: List[str] = []
        for split_dir in split_dirs:
            with open(join(self.root, "curated", split_dir, image_list)) as f:
                for img_id in (fn.rstrip() for fn in f.readlines()):
                    self.image_files.append(
                        join(self.root, "images", split_dir, img_id + ".jpg"))
                    self.label_files.append(
                        join(self.root, "annotations", split_dir, img_id + ".png"))

        self.cocostuff3_coarse_classes = [23, 22, 21]
        self.first_stuff_index = 12

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        img_t, label = _paired_transform(
            self.image_files[index], self.label_files[index], self.transform,
            self.label_transform, rng, force_rgb=True)
        label[label == 255] = -1
        coarse_label = _apply_mapping(label, COCO_FINE_TO_COARSE)
        coarse_label[label == -1] = -1

        if self.coarse_labels:
            coarser = -np.ones_like(label)
            for i, c in enumerate(self.cocostuff3_coarse_classes):
                coarser[coarse_label == c] = i
            return img_t, coarser, (coarser >= 0).astype(np.float32)
        if self.exclude_things:
            return (
                img_t,
                coarse_label - self.first_stuff_index,
                (coarse_label >= self.first_stuff_index).astype(np.float32),
            )
        return img_t, coarse_label, (coarse_label >= 0).astype(np.float32)


class CityscapesSeg:
    """Cityscapes fine-semantic via direct file walking; labels shifted by
    first_nonvoid=7, negatives -> -1 (reference data.py:325-367)."""

    def __init__(self, root, image_set, transform, target_transform,
                 seed: int = 0):
        self.root = join(root, "cityscapes")
        self.split = "train" if image_set == "train" else image_set
        self.transform = transform
        self.target_transform = target_transform
        self.first_nonvoid = 7
        self.seed = seed

        img_root = join(self.root, "leftImg8bit", self.split)
        self.pairs = []
        for city in sorted(os.listdir(img_root)):
            for fn in sorted(os.listdir(join(img_root, city))):
                if not fn.endswith("_leftImg8bit.png"):
                    continue
                base = fn[: -len("_leftImg8bit.png")]
                self.pairs.append((
                    join(img_root, city, fn),
                    join(self.root, "gtFine", self.split, city,
                         base + "_gtFine_labelIds.png"),
                ))
        assert self.pairs, f"no images under {img_root}"

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        img_path, label_path = self.pairs[index]
        img_t, label = _paired_transform(img_path, label_path, self.transform,
                                         self.target_transform, rng,
                                         force_rgb=True)
        label = label - self.first_nonvoid
        label[label < 0] = -1
        mask = (label == -1).astype(np.float32)
        return img_t, label, mask


class CroppedDataset:
    """Materialized five/random-crop trees written by crop_datasets
    (reference data.py:370-400): labels stored +1, so subtract 1."""

    def __init__(self, root, dataset_name, crop_type, crop_ratio, image_set,
                 transform, target_transform, seed: int = 0):
        self.root = join(root, "cropped",
                         f"{dataset_name}_{crop_type}_crop_{crop_ratio}")
        self.transform = transform
        self.target_transform = target_transform
        self.img_dir = join(self.root, "img", image_set)
        self.label_dir = join(self.root, "label", image_set)
        self.num_images = len(os.listdir(self.img_dir))
        assert self.num_images == len(os.listdir(self.label_dir))
        self.seed = seed

    def __len__(self):
        return self.num_images

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        img_t, label = _paired_transform(
            join(self.img_dir, f"{index}.jpg"),
            join(self.label_dir, f"{index}.png"),
            self.transform, self.target_transform, rng, force_rgb=True)
        label = label - 1
        mask = (label == -1).astype(np.float32)
        return img_t, label, mask


class UnlabeledImageFolder:
    """Flat folder of images for demo inference
    (reference demo_segmentation.py:15-31)."""

    def __init__(self, root, transform, seed: int = 0):
        self.root = root
        self.transform = transform
        self.images = sorted(os.listdir(self.root))
        self.seed = seed

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        path = join(self.root, self.images[index])
        return self.transform(path, rng, force_rgb=True), self.images[index]


def get_class_labels(dataset_name: str):
    """Human-readable class names (reference train_segmentation.py:20-50)."""
    if dataset_name.startswith("cityscapes"):
        return [
            "road", "sidewalk", "parking", "rail track", "building", "wall",
            "fence", "guard rail", "bridge", "tunnel", "pole", "polegroup",
            "traffic light", "traffic sign", "vegetation", "terrain", "sky",
            "person", "rider", "car", "truck", "bus", "caravan", "trailer",
            "train", "motorcycle", "bicycle",
        ]
    if dataset_name == "cocostuff27":
        return [
            "electronic", "appliance", "food", "furniture", "indoor",
            "kitchen", "accessory", "animal", "outdoor", "person", "sports",
            "vehicle", "ceiling", "floor", "food", "furniture", "rawmaterial",
            "textile", "wall", "window", "building", "ground", "plant", "sky",
            "solid", "structural", "water",
        ]
    if dataset_name == "potsdam":
        return ["roads and cars", "buildings and clutter",
                "trees and vegetation"]
    raise ValueError(f"Unknown Dataset {dataset_name}")
