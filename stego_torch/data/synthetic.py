"""Procedural labelled scenes; the port's copy of ``render_scene`` and
``PALETTE`` from ``stego_tpu/data/synthetic.py`` (numpy only, so copied
rather than imported; ``tests/test_torch_knn.py`` keeps the two equal).

A scene is a Voronoi mosaic of ``n_classes`` regions, each class an
oriented sinusoidal grating in a class-tinted palette, under pixel noise, a
smooth lighting gradient and per-image palette jitter: texture orientation
carries the class, so a trunk's features, the KNN and the probes have
something to find. ``chip_smoke.py`` draws its KNN and feature-cache data
from it. Nothing here writes files.
"""

from __future__ import annotations

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
