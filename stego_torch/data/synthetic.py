"""Procedural labelled scenes and the synthetic accuracy benchmark; the
port's copy of ``stego_tpu/data/synthetic.py`` (numpy only, so copied
rather than imported; ``tests/test_torch_knn.py`` and
``tests/test_torch_synthetic.py`` keep the two equal).

A scene is a Voronoi mosaic of ``n_classes`` regions, each class an
oriented sinusoidal grating in a class-tinted palette, under pixel noise, a
smooth lighting gradient and per-image palette jitter: texture orientation
carries the class, so a trunk's features, the KNN and the probes have
something to find. ``chip_smoke.py`` draws its KNN and feature-cache data
from it.

:func:`write_synthetic_benchmark` writes such scenes as a directory
dataset (the accuracy proxy's data), and :func:`tiny_benchmark_setup` is
the sensitive accuracy instrument's configuration: the tiny ViT trained 40
steps on the res-64 mosaic (``tests/test_torch_accuracy.py``,
``tools/accuracy_bench.py``). The PNGs are written by a small encoder on
the standard library (:func:`write_png`), so no imaging package is needed
to make the dataset; reading it back goes through the port's decoders.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

PALETTE = np.array([
    [0.85, 0.35, 0.35],
    [0.35, 0.80, 0.40],
    [0.35, 0.45, 0.85],
    [0.80, 0.75, 0.30],
    [0.70, 0.35, 0.80],
    [0.35, 0.80, 0.80],
], np.float32)


def render_scene(rng: np.random.Generator, res: int, n_classes: int,
                 n_seeds: int = 7):
    """One (image float32 [0,1] (res,res,3), label int64 (res,res)) scene;
    the first two rows are labelled -1 (ignored)."""
    # Voronoi mosaic over random seed points
    pts = rng.uniform(0, res, size=(n_seeds, 2)).astype(np.float32)
    cls_of_seed = rng.integers(0, n_classes, size=n_seeds)
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
    d2 = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
    label = cls_of_seed[np.argmin(d2, axis=-1)]

    # class-specific oriented gratings (texture signal)
    img = np.zeros((res, res, 3), np.float32)
    period = res / 8.0
    for c in range(n_classes):
        theta = np.pi * c / n_classes + rng.normal(0, 0.08)
        phase = rng.uniform(0, 2 * np.pi)
        wave = 0.5 + 0.5 * np.sin(
            2 * np.pi * (np.cos(theta) * xx + np.sin(theta) * yy) / period
            + phase)
        tint = PALETTE[c % len(PALETTE)] * (1.0 + rng.normal(0, 0.15, 3))
        img[label == c] = (np.clip(tint, 0.05, 1.0)[None]
                           * (0.35 + 0.65 * wave[label == c, None]))

    # smooth lighting gradient + pixel noise (color unreliability)
    gdir = rng.normal(size=2)
    gdir /= np.linalg.norm(gdir) + 1e-9
    light = 0.75 + 0.5 * (gdir[0] * yy + gdir[1] * xx) / res
    img = img * light[..., None]
    img = img + rng.normal(0, 0.06, img.shape).astype(np.float32)
    img = np.clip(img, 0.0, 1.0)

    label = label.astype(np.int64)
    label[:2, :] = -1  # ignore stripe (masked-metric coverage)
    return img, label


def write_png(path: str, pixels: np.ndarray) -> None:
    """An 8-bit PNG of ``pixels``: (H, W) uint8 as grayscale, (H, W, 3) as
    RGB; every row filtered with filter 0 (none), one zlib stream."""
    a = np.ascontiguousarray(pixels, dtype=np.uint8)
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8; got "
                         f"{a.shape}")
    h, w = a.shape[:2]
    rows = a.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_synthetic_benchmark(root: str, name: str = "synthbench",
                              n_train: int = 64, n_val: int = 16,
                              res: int = 96, n_classes: int = 4,
                              seed: int = 0) -> str:
    """Write the dataset if absent (no ``.complete`` marker); returns the
    dataset root ``<root>/<name>`` with ``imgs/{train,val}/NNNN.png`` and
    ``labels/{train,val}/NNNN.png``. One generator over both splits, train
    first, so the pixels are those of the JAX package's at the same
    (seed, sizes); the image rounded to uint8, label -1 written as 255."""
    base = os.path.join(root, name)
    done = os.path.join(base, ".complete")
    if os.path.exists(done):
        return base
    rng = np.random.default_rng(seed)
    for split, count in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(base, "imgs", split), exist_ok=True)
        os.makedirs(os.path.join(base, "labels", split), exist_ok=True)
        for i in range(count):
            img, label = render_scene(rng, res, n_classes)
            u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
            lbl = np.where(label < 0, 255, label).astype(np.uint8)
            write_png(os.path.join(base, "imgs", split, f"{i:04d}.png"), u8)
            write_png(os.path.join(base, "labels", split, f"{i:04d}.png"),
                      lbl)
    with open(done, "w") as f:
        f.write("ok")
    return base


def tiny_benchmark_setup(root: str, *, n_train: int = 32, n_val: int = 8,
                         **config_overrides) -> Tuple[object, object]:
    """The sensitive accuracy instrument (``synthetic.py:103``): writes the
    res-64 mosaic under ``<root>/data`` and returns the port's ``(Config,
    ViTConfig)`` for the tiny ViT (2 blocks, width 32, 4 heads of 8) and
    its 40-step footprint, with the JAX package's fields.
    ``config_overrides`` update Config fields (``backbone_dtype="bfloat16"``
    for the card's row)."""
    from stego_torch.config import Config
    from stego_torch.models.vit import ViTConfig

    data_root = os.path.join(root, "data")
    write_synthetic_benchmark(data_root, n_train=n_train, n_val=n_val, res=64)
    vit_cfg = ViTConfig(patch_size=8, embed_dim=32, depth=2, num_heads=4,
                        img_size=64)
    fields = dict(
        output_root=os.path.join(root, "out"),
        pytorch_data_dir=data_root,
        dataset_name="directory", dir_dataset_name="synthbench",
        dir_dataset_n_classes=4, experiment_name="acc_tiny",
        model_type="vit_small", dino_patch_size=8,
        res=64, val_res=64, batch_size=8, val_batch_size=8,
        max_steps=40, val_freq=40, checkpoint_freq=40, num_neighbors=4,
        crop_type=None, loader_crop_type="center", backbone_dtype="float32",
        cache_dataset=True, seed=0,
    )
    fields.update(config_overrides)
    return Config(**fields), vit_cfg
