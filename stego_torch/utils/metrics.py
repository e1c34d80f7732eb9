"""Hungarian-matched unsupervised segmentation metrics; counterpart of
``stego_tpu/utils/metrics.py``.

The confusion matrix is one ``torch.bincount`` on the predictions' device;
the Hungarian assignment runs on the host with scipy, as the reference's
(src/utils.py:203-274). Over several processes the matrices of an epoch are
summed over the ranks before the matching (``merge_stats``), as the
reference's torchmetrics sync does (src/utils.py:209-217).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from stego_torch.parallel import dist


def update_conf_matrix(stats: torch.Tensor, preds: torch.Tensor,
                       target: torch.Tensor, n_classes: int,
                       extra_clusters: int) -> torch.Tensor:
    """``stats`` ((n_classes + extra, n_classes), indexed [pred, actual])
    plus the counts of this batch. Keeps the reference's masking quirk
    (src/utils.py:219-229): a pixel counts only when its prediction is also
    < n_classes, so pixels of extra clusters are dropped."""
    actual = target.reshape(-1).long()
    preds = preds.reshape(-1).long()
    mask = ((actual >= 0) & (actual < n_classes) & (preds >= 0)
            & (preds < n_classes))
    total = n_classes + extra_clusters
    counts = torch.bincount(preds[mask] * n_classes + actual[mask],
                            minlength=total * n_classes)
    return stats + counts.reshape(total, n_classes).to(stats.dtype)


class UnsupervisedMetrics:
    """Host-side confusion matrix with Hungarian matching (the torchmetrics
    Metric surface of the reference)."""

    def __init__(self, prefix: str, n_classes: int, extra_clusters: int,
                 compute_hungarian: bool):
        self.prefix = prefix
        self.n_classes = n_classes
        self.extra_clusters = extra_clusters
        self.compute_hungarian = compute_hungarian
        self.reset()

    def reset(self):
        self.stats = np.zeros(
            (self.n_classes + self.extra_clusters, self.n_classes),
            dtype=np.int64)
        self.assignments: Tuple[np.ndarray, np.ndarray] | None = None
        self.histogram: np.ndarray | None = None

    def update(self, preds, target):
        self.stats = update_conf_matrix(
            torch.from_numpy(self.stats), torch.as_tensor(preds).cpu(),
            torch.as_tensor(target).cpu(), self.n_classes,
            self.extra_clusters).numpy()

    def merge_stats(self, stats):
        """Accumulate an externally computed confusion matrix (a val step's
        output, or an epoch's sum of them); over several processes the sum
        of every rank's, so every rank calls it (one all_reduce)."""
        stats = dist.all_reduce_(torch.as_tensor(stats).clone()).cpu().numpy()
        self.stats = self.stats + np.asarray(stats, dtype=np.int64)

    def map_clusters(self, clusters):
        """Relabel cluster ids to Hungarian-matched classes
        (reference src/utils.py:231-243); unmatched extras -> -1."""
        assert self.assignments is not None, "call compute() first"
        clusters = np.asarray(clusters)
        if self.extra_clusters == 0:
            return np.asarray(self.assignments[1])[clusters]
        missing = sorted(
            set(range(self.n_classes + self.extra_clusters))
            - set(self.assignments[0]))
        cluster_to_class = np.asarray(self.assignments[1])
        for missing_entry in missing:
            if missing_entry == cluster_to_class.shape[0]:
                cluster_to_class = np.append(cluster_to_class, -1)
            else:
                cluster_to_class = np.insert(cluster_to_class,
                                             missing_entry + 1, -1)
        return cluster_to_class[clusters]

    def compute(self) -> Dict[str, float]:
        """Hungarian match + mIoU / Accuracy (reference src/utils.py:245-274),
        including the extra-clusters overflow-row path."""
        stats = self.stats
        if self.compute_hungarian:
            self.assignments = linear_sum_assignment(stats, maximize=True)
            if self.extra_clusters == 0:
                self.histogram = stats[np.argsort(self.assignments[1]), :]
            else:
                self.assignments_t = linear_sum_assignment(stats.T,
                                                           maximize=True)
                histogram = stats[self.assignments_t[1], :]
                missing = list(
                    set(range(self.n_classes + self.extra_clusters))
                    - set(self.assignments[0]))
                new_row = stats[missing, :].sum(0, keepdims=True)
                histogram = np.concatenate([histogram, new_row], axis=0)
                new_col = np.zeros((self.n_classes + 1, 1),
                                   dtype=histogram.dtype)
                self.histogram = np.concatenate([histogram, new_col], axis=1)
        else:
            self.assignments = (
                np.arange(self.n_classes)[:, None],
                np.arange(self.n_classes)[:, None],
            )
            self.histogram = stats

        hist = self.histogram.astype(np.float64)
        tp = np.diag(hist)
        fp = hist.sum(axis=0) - tp
        fn = hist.sum(axis=1) - tp
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = tp / (tp + fp + fn)
        opc = tp.sum() / hist.sum() if hist.sum() > 0 else float("nan")
        return {
            self.prefix + "mIoU": 100.0 * float(np.nanmean(iou)),
            self.prefix + "Accuracy": 100.0 * float(opc),
        }
