"""Label colormaps for the figures; counterpart of
``stego_tpu/data/colormaps.py`` (behavioral reference: src/data.py:16-72)."""

from __future__ import annotations

import numpy as np


def create_pascal_label_colormap() -> np.ndarray:
    """512-entry PASCAL VOC colormap via the canonical bit-twiddling scheme."""
    colormap = np.zeros((512, 3), dtype=int)
    ind = np.arange(512, dtype=int)
    for shift in reversed(range(8)):
        for channel in range(3):
            colormap[:, channel] |= ((ind >> channel) & 1) << shift
        ind >>= 3
    return colormap


def create_cityscapes_colormap() -> np.ndarray:
    """The 28-entry Cityscapes palette used by the reference (data.py:43-72)."""
    colors = [
        (128, 64, 128), (244, 35, 232), (250, 170, 160), (230, 150, 140),
        (70, 70, 70), (102, 102, 156), (190, 153, 153), (180, 165, 180),
        (150, 100, 100), (150, 120, 90), (153, 153, 153), (153, 153, 153),
        (250, 170, 30), (220, 220, 0), (107, 142, 35), (152, 251, 152),
        (70, 130, 180), (220, 20, 60), (255, 0, 0), (0, 0, 142),
        (0, 0, 70), (0, 60, 100), (0, 0, 90), (0, 0, 110),
        (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 0, 0),
    ]
    return np.array(colors)


def colormap_for_dataset(dataset_name: str) -> np.ndarray:
    """Reference selection rule (train_segmentation.py:100-103)."""
    if dataset_name.startswith("cityscapes"):
        return create_cityscapes_colormap()
    return create_pascal_label_colormap()
