"""Analysis and figures: correspondence heatmaps, Potsdam mosaics,
precision-recall curves; counterpart of ``stego_tpu/eval/analysis.py``.

Behavioral references: src/plot_dino_correspondence.py, src/plot_potsdam.py,
src/plot_pr_curves.py. The query-versus-map correlation is the loss's
arithmetic (sampled query features against the whole feature map,
per-query mean-centring, a clamp at 0, a bilinear upsample with
align_corners=True; plot_dino_correspondence.py:45-56).

The numbers are computed on the tensors' device and returned whatever can
draw. The figures import matplotlib, and the PNGs and the GIF PIL, only when
they draw; where one does not import, one line names each file not written
(as ``utils/viz.py:write_figures`` does).
"""

from __future__ import annotations

import os
from os.path import join
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from stego_torch.ops.interp import interpolate
from stego_torch.ops.math import l2_normalize, one_hot_feats, \
    tensor_correlation
from stego_torch.ops.sampling import sample_from_coords
from stego_torch.utils.viz import prep_for_plot, write_figures

# ----------------------------------------------------------------------
# correspondence heatmaps


def correspondence_heatmaps(
    feats1: torch.Tensor,
    feats2: torch.Tensor,
    query_points: torch.Tensor,
    out_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-point correspondence fields.

    Args:
      feats1/feats2: (1, h, w, C) feature maps of the image and its KNN pair.
      query_points: (1, P, 1, 2) normalized coords (reference layout).
      out_hw: upsample target (the input image size).
    Returns:
      (heatmap_intra, heatmap_inter): (P, H, W) f32, mean-centred and
      clamped at 0 (plot_dino_correspondence.py:45-56).
    """
    sfeats = l2_normalize(sample_from_coords(feats1, query_points))

    def field(feats):
        attn = tensor_correlation(sfeats, l2_normalize(feats))
        attn = attn - attn.mean(dim=(3, 4), keepdim=True)
        attn = torch.clamp_min(attn, 0.0)[0]  # (1, P, h, w)
        attn = attn.reshape(attn.shape[-3], *attn.shape[-2:])
        return interpolate(attn[..., None], out_hw, "bilinear",
                           align_corners=True)[..., 0]

    return field(feats1), field(feats2)


# the colours of the query points (plot_dino_correspondence.py:128)
QUERY_COLORS = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0)]


def plot_correspondence_figure(
    path: str,
    img: np.ndarray,
    img_pos: np.ndarray,
    heatmap_intra: np.ndarray,
    heatmap_inter: np.ndarray,
    query_points: np.ndarray,
    dark_mode: bool = True,
) -> List[str]:
    """Three-panel figure: query points / self correspondence / KNN
    correspondence (plot_dino_correspondence.py:118-152). Returns the paths
    written."""

    def draw(path):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.colors import ListedColormap

        if dark_mode:
            plt.style.use("dark_background")
        cmaps = [ListedColormap([(r, g, b, i / 255) for i in range(255)])
                 for (r, g, b) in QUERY_COLORS]
        high_res = img.shape[0]
        fig, axes = plt.subplots(1, 3, figsize=(15, 5), dpi=100)
        for ax, title in zip(axes, ("Image and Query Points",
                                    "Self Correspondence",
                                    "KNN Correspondence")):
            ax.set_title(title, fontsize=20)
            ax.set_xticks([])
            ax.set_yticks([])
        axes[0].imshow(prep_for_plot(img))
        axes[1].imshow(prep_for_plot(img) * 0.8)
        axes[2].imshow(prep_for_plot(img_pos) * 0.8)
        for p in range(heatmap_intra.shape[0]):
            # (x=coord0, y=coord1) (plot_dino_correspondence.py:131-136)
            point = (query_points[0, p, 0] + 1) / 2 * high_res
            axes[0].scatter(point[0], point[1], c=[QUERY_COLORS[p % 4]],
                            marker="x", s=500, linewidths=5)
            # a symmetric colour range, as plot_heatmap
            # (plot_dino_correspondence.py:19-33)
            vmax_intra = np.abs(heatmap_intra[p]).max() or 1.0
            vmax_inter = np.abs(heatmap_inter[p]).max() or 1.0
            axes[1].imshow(heatmap_intra[p], alpha=0.5, cmap=cmaps[p % 4],
                           vmin=-vmax_intra, vmax=vmax_intra)
            axes[2].imshow(heatmap_inter[p], alpha=0.5, cmap=cmaps[p % 4],
                           vmin=-vmax_inter, vmax=vmax_inter)
        fig.tight_layout()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path)
        plt.close(fig)

    return write_figures([(path, draw)])


def _pil_image():
    """PIL's ``Image`` module, or None where PIL does not import."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def save_correspondence_gif(
    path: str,
    img: np.ndarray,
    img_pos: np.ndarray,
    heatmaps_intra: np.ndarray,
    heatmaps_inter: np.ndarray,
    query_points: np.ndarray,
    fps: int = 15,
) -> List[str]:
    """Query-point interpolation movie, a GIF by PIL (the reference renders
    an mp4 by ffmpeg, plot_dino_correspondence.py:210-214). Returns the
    paths written."""
    image = _pil_image()
    if image is None:
        print(f"{path}: not written, PIL does not import")
        return []
    base1 = (prep_for_plot(img) * 255).astype(np.uint8)
    base2 = (prep_for_plot(img_pos) * 255).astype(np.uint8)

    def overlay(base, hm):
        hm = hm / (hm.max() + 1e-9)
        out = base.astype(np.float32)
        out[..., 0] = out[..., 0] * (1 - 0.7 * hm) + 255 * 0.7 * hm
        return out.astype(np.uint8)

    frames = []
    h = img.shape[0]
    for p in range(heatmaps_intra.shape[0]):
        left = base1.copy()
        pt = ((query_points[0, p, 0] + 1) / 2 * h).astype(int)
        y0, x0 = np.clip(pt[1], 2, h - 3), np.clip(pt[0], 2, h - 3)
        left[y0 - 2:y0 + 3, x0 - 2:x0 + 3] = [255, 0, 0]
        frame = np.concatenate(
            [left, overlay(base1, heatmaps_intra[p]),
             overlay(base2, heatmaps_inter[p])], axis=1)
        frames.append(image.fromarray(frame))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return [path]


def interpolated_query_path(key_points: Sequence[Sequence[float]],
                            hold: int = 10, steps: int = 10) -> np.ndarray:
    """Hold-then-interpolate query trajectory, (1, P, 1, 2) f32
    (plot_dino_correspondence.py:156-170)."""
    all_points: List[List[float]] = []
    for i in range(len(key_points)):
        all_points.extend([list(key_points[i])] * hold)
        if i < len(key_points) - 1:
            seg = np.stack([
                np.linspace(key_points[i][0], key_points[i + 1][0], steps),
                np.linspace(key_points[i][1], key_points[i + 1][1], steps),
            ], axis=1)
            all_points.extend(seg.tolist())
    return np.asarray(all_points, np.float32).reshape(1, len(all_points), 1, 2)


# ----------------------------------------------------------------------
# Potsdam mosaics

# tiles a prediction call (stego_tpu/eval/analysis.py:230)
MOSAIC_BATCH = 16


def potsdam_mosaic(
    eval_cfg,
    model_path: str,
    device: Union[str, torch.device],
    img_num: int = 6,
    tile_res: int = 320,
    vit_cfg=None,
    dataset=None,
    grid: int = 15,
) -> Dict[str, np.ndarray]:
    """Stitch one PotsdamRaw scene (grid x grid tiles), predict each tile's
    clusters by flip-TTA on ``device``, Hungarian-map them (reference
    plot_potsdam.py:42-91).

    Returns 'img', 'label' and 'cluster', the whole scene's arrays (the
    cluster ids mapped to classes), and writes them as PNGs under
    results/predictions/potsdam of the working directory.
    """
    from stego_torch.data.colormaps import colormap_for_dataset
    from stego_torch.data.contrastive import ContrastiveSegDataset
    from stego_torch.data.transforms import get_transform
    from stego_torch.eval.evaluate import flip_tta_code, load_model_for_eval
    from stego_torch.models.probes import cluster_lookup
    from stego_torch.utils.metrics import UnsupervisedMetrics

    device = torch.device(device)
    seg = load_model_for_eval(model_path, device, vit_cfg=vit_cfg)
    if dataset is None:
        dataset = ContrastiveSegDataset(
            pytorch_data_dir=eval_cfg.pytorch_data_dir,
            dataset_name="potsdamraw", crop_type=None, image_set="all",
            transform=get_transform(tile_res, False, "center"),
            target_transform=get_transform(tile_res, True, "center"),
            cfg=seg.cfg,
        )

    @torch.inference_mode()
    def predict(img):
        # two trunk calls, the image and its flip, as the JAX package's
        # jitted predict
        code = interpolate(flip_tta_code(seg, img), (tile_res, tile_res),
                           "bilinear", align_corners=False)
        lp = cluster_lookup(seg.cluster_probe.clusters, code, alpha=2.0,
                            log_probs=True)
        return lp.argmax(-1)

    metrics = UnsupervisedMetrics("final/cluster/", seg.n_classes,
                                  seg.cfg.extra_clusters, True)
    tiles = grid * grid
    start = tiles * img_num
    imgs, labels, preds = [], [], []
    for i in range(start, start + tiles, MOSAIC_BATCH):
        batch = [dataset[j] for j in range(i, min(i + MOSAIC_BATCH,
                                                  start + tiles))]
        img = np.stack([b["img"] for b in batch])
        label = np.stack([b["label"] for b in batch])
        pred = predict(torch.from_numpy(img).to(device)).cpu().numpy()
        metrics.update(pred, label)
        imgs.append(img)
        labels.append(label)
        preds.append(pred)
    metrics.compute()

    def stitch(parts):
        arr = np.concatenate(parts, axis=0)  # (tiles, H, W[, C])
        arr = arr.reshape(grid, grid, *arr.shape[1:])
        arr = np.swapaxes(arr, 1, 2)  # (gy, H, gx, W, ...)
        return arr.reshape(grid * tile_res, grid * tile_res, *arr.shape[4:])

    full_img = stitch(imgs)
    full_label = stitch(labels)
    full_pred = metrics.map_clusters(stitch(preds))

    cmap = colormap_for_dataset("potsdam")
    result_dir = join("results", "predictions", "potsdam")
    pngs = {
        "img": lambda: (prep_for_plot(full_img) * 255).astype(np.uint8),
        "label": lambda: cmap[np.clip(full_label, 0, len(cmap) - 1)]
        .astype(np.uint8),
        "cluster": lambda: cmap[np.clip(full_pred, 0, len(cmap) - 1)]
        .astype(np.uint8),
    }
    image = _pil_image()
    for sub, pixels in pngs.items():
        path = join(result_dir, sub, f"{img_num}.png")
        if image is None:
            print(f"{path}: not written, PIL does not import")
            continue
        os.makedirs(join(result_dir, sub), exist_ok=True)
        image.fromarray(pixels()).save(path)
    return {"img": full_img, "label": full_label, "cluster": full_pred}


# ----------------------------------------------------------------------
# precision-recall curves


def crf_pair_diffs(img: torch.Tensor, coords1: torch.Tensor,
                   coords2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coord_diff, img_diff): squared coordinate and RGB distances between
    all sampled coordinate pairs, each (B, S*S, S*S) (reference get_crf_fd,
    plot_pr_curves.py:95-107)."""
    n = img.shape[0]
    img_s1 = sample_from_coords(img, coords1).reshape(n, -1, 1, 3)
    img_s2 = sample_from_coords(img, coords2).reshape(n, 1, -1, 3)
    coord_diff = torch.square(coords1.reshape(n, -1, 1, 2)
                              - coords2.reshape(n, 1, -1, 2)).sum(-1)
    img_diff = torch.square(img_s1 - img_s2).sum(-1)
    return coord_diff, img_diff


# the CRF kernel's learnable scalars at the reference's init values
# (CRFModule.__init__, plot_pr_curves.py:53-61)
CRF_INIT = dict(w1=10.0, w2=3.0, shift=-0.3, alpha=0.5, beta=0.15, gamma=0.05)


def init_crf_module(device: Union[str, torch.device] = "cpu"
                    ) -> Dict[str, torch.Tensor]:
    """The six CRF-kernel scalars, f32 0-d tensors at their init values."""
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in CRF_INIT.items()}


def crf_module_apply(params: Dict[str, torch.Tensor],
                     coord_diff: torch.Tensor,
                     img_diff: torch.Tensor) -> torch.Tensor:
    """|w1| exp(-d_xy / 2e^alpha - d_rgb / 2e^beta) + |w2| exp(-d_xy /
    2e^gamma) - shift (reference CRFModule.forward,
    plot_pr_curves.py:63-67)."""
    return (params["w1"].abs()
            * torch.exp(-coord_diff / (2 * torch.exp(params["alpha"]))
                        - img_diff / (2 * torch.exp(params["beta"])))
            + params["w2"].abs()
            * torch.exp(-coord_diff / (2 * torch.exp(params["gamma"])))
            - params["shift"])


def train_crf_recalibrator(coord_diff: torch.Tensor, img_diff: torch.Tensor,
                           ld: torch.Tensor, steps: int = 300,
                           lr: float = 5e-2) -> Dict[str, torch.Tensor]:
    """Train the six CRF-kernel scalars by Adam on the binary cross-entropy
    of the kernel's output (the logits) against label agreement > 0.5, on
    the inputs' device. The reference ships the module
    (plot_pr_curves.py:53-67,124-150) with a training step that returns
    None; the JAX package trains it (optax Adam in a ``fori_loop``), and so
    does this, by ``torch.optim.Adam`` at the same defaults."""
    targets = (ld.reshape(-1) > 0.5).float()
    cd = coord_diff.reshape(-1)
    idiff = img_diff.reshape(-1)
    params = {k: v.clone().requires_grad_(True)
              for k, v in init_crf_module(cd.device).items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = F.binary_cross_entropy_with_logits(
            crf_module_apply(params, cd, idiff), targets)
        loss.backward()
        opt.step()
    return {k: v.detach() for k, v in params.items()}


def crf_kernel_fd(img: torch.Tensor, coords1: torch.Tensor,
                  coords2: torch.Tensor, alpha=0.5, beta=0.15, gamma=0.05,
                  w1=10.0, w2=3.0, shift=-0.3) -> torch.Tensor:
    """The analytic CRF kernel over sampled coordinate pairs (reference
    CRFModule and get_crf_fd, plot_pr_curves.py:53-67,95-107)."""
    coord_diff, img_diff = crf_pair_diffs(img, coords1, coords2)
    return (w1 * torch.exp(-coord_diff / float(np.float32(2 * np.exp(alpha)))
                           - img_diff / float(np.float32(2 * np.exp(beta))))
            + w2 * torch.exp(-coord_diff
                             / float(np.float32(2 * np.exp(gamma))))
            - shift)


def label_agreement_fd(feats: torch.Tensor, label: torch.Tensor,
                       n_classes: int, coords1: torch.Tensor,
                       coords2: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ld, fd): label-agreement targets and feature-similarity predictions
    at sampled coordinate pairs (reference get_net_fd,
    plot_pr_curves.py:109-122); label -1 is its own class."""
    f1 = sample_from_coords(feats, coords1)
    f2 = sample_from_coords(feats, coords2)
    one_hot = one_hot_feats(label.long() + 1, n_classes + 1)
    l1 = sample_from_coords(one_hot, coords1)
    l2 = sample_from_coords(one_hot, coords2)
    fd = tensor_correlation(l2_normalize(f1), l2_normalize(f2))
    ld = tensor_correlation(l1, l2)
    return ld, fd


def precision_recall_curve(targets: np.ndarray, scores: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(precision, recall) of binary ``targets`` ranked by
    ``scores``, as sklearn's ``precision_recall_curve`` (no intermediate
    points dropped): one point for each distinct score, from the highest,
    tied scores counted together; reversed, with the point (recall 0,
    precision 1) appended."""
    order = np.argsort(scores, kind="mergesort")[::-1]
    s = scores[order]
    y = targets[order].astype(np.float64)
    last = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[last]
    fps = 1 + last - tps
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def pr_curve_data(preds: np.ndarray, targets: np.ndarray):
    """Min-max normalized PR curve and average precision (reference plot_pr,
    plot_pr_curves.py:160-167): the step integral sum((r_i - r_{i+1}) p_i),
    sklearn's ``average_precision_score``."""
    preds = np.asarray(preds).reshape(-1).astype(np.float64)
    preds = preds - preds.min()
    rng = preds.max()
    if rng > 0:
        preds = preds / rng
    targets = (np.asarray(targets).reshape(-1) > 0.5).astype(np.int64)
    precisions, recalls = precision_recall_curve(targets, preds)
    ap = max(0.0, float(-np.sum(np.diff(recalls) * precisions[:-1])))
    return precisions, recalls, ap


def plot_pr_curves(path: str, curves: Dict[str, np.ndarray],
                   targets: np.ndarray) -> Dict[str, float]:
    """PR curves of several feature spaces in one figure; returns {name: AP}
    (computed whether or not the figure is drawn)."""
    data = {name: pr_curve_data(np.asarray(preds), np.asarray(targets))
            for name, preds in curves.items()}

    def draw(path):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(5, 4), dpi=100)
        for name, (precisions, recalls, ap) in data.items():
            plt.plot(recalls, precisions, label=f"AP={int(ap * 100)}% {name}")
        plt.xlim([0, 1])
        plt.ylim([0, 1])
        plt.legend(fontsize=12)
        plt.ylabel("Precision", fontsize=16)
        plt.xlabel("Recall", fontsize=16)
        plt.tight_layout()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        plt.savefig(path)
        plt.close()

    write_figures([(path, draw)])
    return {name: float(ap) for name, (_, _, ap) in data.items()}

