"""Visualization helpers; counterpart of ``stego_tpu/utils/viz.py``
(reference: prep_for_plot/add_plot in src/utils.py:23-43 and the eval
figure code in src/eval_segmentation.py:16-39,178-213).

The PNG trees need PIL; the figures need matplotlib, which each imports
when it draws. :func:`write_figures` draws a set of figures, or, where
matplotlib does not import, prints one line for each figure it could not
write.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from stego_torch.data.transforms import unnormalize


def prep_for_plot(img_nhwc: np.ndarray, rescale: bool = True) -> np.ndarray:
    """Normalized NHWC image -> displayable [0,1] HWC (4-channel inputs show
    their RGB slice; the IR channel is data, not display)."""
    img = unnormalize(np.asarray(img_nhwc))[..., :3]
    if rescale:
        img = (img - img.min()) / max(img.max() - img.min(), 1e-12)
    return np.clip(img, 0, 1)


def save_prediction_images(
    result_dir: str,
    imgs: np.ndarray,
    labels: np.ndarray,
    cluster_preds: Optional[np.ndarray],
    linear_preds: Optional[np.ndarray],
    cmap: np.ndarray,
    indices: Optional[List[int]] = None,
) -> None:
    """Save img/label/cluster[/linear] PNGs per sample
    (reference eval_segmentation.py:181-193)."""
    from PIL import Image

    for sub in ("img", "label", "cluster", "linear"):
        os.makedirs(join(result_dir, sub), exist_ok=True)
    n = len(imgs)
    idx = indices if indices is not None else list(range(n))
    for i in range(n):
        name = f"{idx[i]}"
        plot_img = (prep_for_plot(imgs[i]) * 255).astype(np.uint8)
        Image.fromarray(plot_img).save(join(result_dir, "img", name + ".jpg"))
        lab = np.clip(labels[i], 0, len(cmap) - 1)
        Image.fromarray(cmap[lab].astype(np.uint8)).save(
            join(result_dir, "label", name + ".png"))
        if cluster_preds is not None:
            cp = np.clip(cluster_preds[i], 0, len(cmap) - 1)
            Image.fromarray(cmap[cp].astype(np.uint8)).save(
                join(result_dir, "cluster", name + ".png"))
        if linear_preds is not None:
            lp = np.clip(linear_preds[i], 0, len(cmap) - 1)
            Image.fromarray(cmap[lp].astype(np.uint8)).save(
                join(result_dir, "linear", name + ".png"))


def save_comparison_grid(
    path: str,
    rows: Dict[str, np.ndarray],
    cmap: np.ndarray,
    dark_mode: bool = False,
) -> None:
    """Rows: name -> (N, H, W[, 3]) images or integer label maps."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if dark_mode:
        plt.style.use("dark_background")
    names = list(rows)
    n = len(rows[names[0]])
    fig, ax = plt.subplots(len(names), n,
                           figsize=(n * 3, len(names) * 3), squeeze=False)
    for r, name in enumerate(names):
        for c in range(n):
            arr = rows[name][c]
            if arr.ndim == 2:  # label map
                ax[r, c].imshow(cmap[np.clip(arr, 0, len(cmap) - 1)]
                                .astype(np.uint8))
            else:
                ax[r, c].imshow(prep_for_plot(arr))
            ax[r, c].set_xticks([])
            ax[r, c].set_yticks([])
        ax[r, 0].set_ylabel(name, fontsize=16)
    plt.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def save_frequency_bars(
    path: str, histogram: np.ndarray, class_names: List[str],
    cmap: Optional[np.ndarray] = None,
) -> None:
    """Label-frequency (histogram.sum(0)) and cluster-frequency
    (histogram.sum(1)) log-scale bar charts, one figure — parity with the
    per-validation-epoch frequency bars the reference logs to TB
    (train_segmentation.py:332-359)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hist = np.asarray(histogram, dtype=np.float64)
    label_freq = hist.sum(axis=0)
    cluster_freq = hist.sum(axis=1)
    all_bars = np.concatenate([label_freq, cluster_freq])
    ymin = max(all_bars.min() * 0.8, 1)
    ymax = max(all_bars.max() * 1.2, ymin * 10)
    fig, ax = plt.subplots(1, 2, figsize=(10, 4))
    for a, freqs, title in ((ax[0], label_freq, "Label Frequency"),
                            (ax[1], cluster_freq, "Cluster Frequency")):
        names = (list(class_names)
                 + [f"c{i}" for i in range(len(class_names), len(freqs))])
        colors = None
        if cmap is not None:
            colors = [np.asarray(cmap[i % len(cmap)]) / 255.0
                      for i in range(len(freqs))]
        a.bar(range(len(freqs)), freqs, tick_label=names[:len(freqs)],
              color=colors)
        a.set_ylim(ymin, ymax)
        a.set_title(title)
        a.set_yscale("log")
        a.tick_params(axis="x", labelrotation=90, labelsize=7)
    plt.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def save_confusion_matrix(
    path: str, histogram: np.ndarray, class_names: List[str],
    dark_mode: bool = False,
) -> None:
    """Row-normalized confusion-matrix heatmap
    (reference plot_cm, eval_segmentation.py:16-39)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if dark_mode:
        plt.style.use("dark_background")
    hist = histogram.astype(np.float64)
    hist /= np.clip(hist.sum(axis=0, keepdims=True), 1, None)
    fig = plt.figure(figsize=(10, 10))
    ax = fig.gca()
    ax.imshow(hist.T, cmap="Blues")
    ax.set_title("Predicted labels", fontsize=20)
    ax.set_ylabel("True labels", fontsize=20)
    ax.set_xticks(range(len(class_names)))
    ax.set_yticks(range(len(class_names)))
    ax.set_xticklabels(class_names, rotation=90, fontsize=9)
    ax.set_yticklabels(class_names, fontsize=9)
    plt.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def write_figures(figures: Sequence[Tuple[str, Callable[[str], None]]]
                  ) -> List[str]:
    """Draw each ``(path, draw)``, as ``draw(path)``. Without matplotlib,
    print one line naming each figure not written instead. Returns the
    paths written."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        for path, _ in figures:
            print(f"{path}: not written, matplotlib does not import")
        return []
    for path, draw in figures:
        draw(path)
    return [path for path, _ in figures]
