"""Offline crop materialization, ``python -m stego_torch.data.crop
key=value ...``; counterpart of ``stego_tpu/data/crop.py`` and of
``crop_datasets.py`` (behavioral reference: src/crop_datasets.py).

Writes ``cropped/{ds}_{crop}_crop_{ratio}/img|label/{split}/{i}.jpg|png`` trees
consumed by :class:`stego_torch.data.datasets.CroppedDataset` — labels stored +1
so 0 can mean "ignore" (reference crop_datasets.py:114-124). Five-crop = four
corners + center at ``crop_ratio`` of each side; random crops use a hash-seeded
position like the reference's ``_random_crops`` (:47-55).
"""

from __future__ import annotations

import os
from os.path import join
from typing import List, Tuple

import numpy as np

from stego_torch.config import Config
from stego_torch.data.contrastive import ContrastiveSegDataset
from stego_torch.data.transforms import normalize, unnormalize


def five_crop_boxes(h: int, w: int, ch: int, cw: int) -> List[Tuple[int, int]]:
    """(top, left) for tl, tr, bl, br, center — torchvision five_crop order."""
    return [
        (0, 0), (0, w - cw), (h - ch, 0), (h - ch, w - cw),
        ((h - ch) // 2, (w - cw) // 2),
    ]


def random_crop_boxes(h: int, w: int, ch: int, cw: int, seed: int,
                      n: int = 5) -> List[Tuple[int, int]]:
    """Deterministic positions from a per-image seed (reference hashes
    (seed, i, axis); we use a numpy Generator — same determinism guarantee)."""
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(0, max(h - ch, 0) + 1)),
         int(rng.integers(0, max(w - cw, 0) + 1)))
        for _ in range(n)
    ]


def materialize_crops(
    cfg: Config,
    dataset_name: str,
    img_set: str,
    crop_type: str = "five",
    crop_ratio: float = 0.5,
) -> str:
    """Write the cropped tree for one (dataset, split); returns the root dir."""
    save_dir = join(
        cfg.pytorch_data_dir, "cropped",
        f"{dataset_name}_{crop_type}_crop_{crop_ratio}",
    )
    img_dir = join(save_dir, "img", img_set)
    label_dir = join(save_dir, "label", img_set)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)

    # identity transforms: crop from the original-resolution images
    identity = _IdentityTransform()
    dataset = ContrastiveSegDataset(
        pytorch_data_dir=cfg.pytorch_data_dir,
        dataset_name=dataset_name,
        crop_type=None,
        image_set=img_set,
        transform=identity,
        target_transform=_IdentityLabelTransform(),
        cfg=cfg,
        seed=cfg.seed,
    )

    from PIL import Image

    for item in range(len(dataset)):
        batch = dataset[item]
        img = np.asarray(batch["img"])  # HWC float normalized
        label = np.asarray(batch["label"])  # HW int
        h, w = img.shape[:2]
        ch, cw = int(h * crop_ratio), int(w * crop_ratio)
        if crop_type == "five":
            boxes = five_crop_boxes(h, w, ch, cw)
        elif crop_type == "random":
            boxes = random_crop_boxes(h, w, ch, cw, seed=item)
        else:
            raise ValueError(f"Unknown crop type {crop_type}")
        for crop_num, (top, left) in enumerate(boxes):
            img_num = item * 5 + crop_num
            crop_img = unnormalize(img[top:top + ch, left:left + cw])
            crop_img = np.clip(crop_img * 255 + 0.5, 0, 255).astype(np.uint8)
            crop_label = (label[top:top + ch, left:left + cw] + 1).astype(
                np.uint8)
            Image.fromarray(crop_img).save(join(img_dir, f"{img_num}.jpg"),
                                           "JPEG")
            Image.fromarray(crop_label).save(join(label_dir, f"{img_num}.png"),
                                             "PNG")
    return save_dir


class _IdentityTransform:
    """Keep original resolution; just normalize (reference passes T.ToTensor())."""

    def __call__(self, img, rng=None, force_rgb=False):
        from PIL import Image

        if isinstance(img, str):
            img = Image.open(img)
        if img.mode != "RGB":
            img = img.convert("RGB")
        return normalize(np.asarray(img).astype(np.float32) / 255.0)


class _IdentityLabelTransform:
    def __call__(self, img, rng=None, force_rgb=False):
        from PIL import Image

        if isinstance(img, str):
            img = Image.open(img)
        arr = np.asarray(img).astype(np.int64)
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr


def main(argv=None):
    from stego_torch.config import prep_args

    overrides = prep_args(argv)
    base = overrides.pop("config", None)
    cfg = (Config.from_yaml(base, **overrides) if base
           else Config.from_dict(overrides, strict=True))
    # reference default sweep (crop_datasets.py:140-143)
    dataset_names = [cfg.dataset_name] if cfg.dataset_name else ["cityscapes"]
    for dataset_name in dataset_names:
        for img_set in ("train", "val"):
            out = materialize_crops(cfg, dataset_name, img_set,
                                    crop_type=cfg.crop_type or "five",
                                    crop_ratio=cfg.crop_ratio)
            print("wrote", out, img_set)


if __name__ == "__main__":
    main()
