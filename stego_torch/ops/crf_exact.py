"""Exact dense-CRF mean field via the native permutohedral lattice;
counterpart of ``stego_tpu/ops/crf_exact.py``, the same numpy code.

Same parameters as :mod:`stego_torch.ops.crf` (the reference's pydensecrf
pipeline, src/crf.py), but with the bilateral term computed by the
full-resolution lattice filter (``stego_torch/native``) instead of the
coarse-grid approximation, on the host, like pydensecrf. Use via
``crf_backend: "exact"``. It differs from the grid backend on purpose: the
kernels are normalised and their self-interaction is not removed.

Mean-field update (Krähenbühl & Koltun, NeurIPS 2011), Potts compatibility,
symmetrically normalized kernels (``_Kernel.message`` says why the
self-interaction stays):
    Q <- softmax(unary + Σ_m w_m D^-1/2 K_m D^-1/2 Q)
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from stego_torch.data.transforms import resize_bilinear_np
from stego_torch.native import PermutohedralLattice
from stego_torch.ops.crf import (
    BI_RGB_STD,
    BI_W,
    BI_XY_STD,
    MAX_ITER,
    POS_W,
    POS_XY_STD,
)


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _upsample_bilinear(logits: np.ndarray, hw) -> np.ndarray:
    # numpy resize with torch's align_corners=False weights: the host
    # backend needs no device round trip
    return resize_bilinear_np(np.asarray(logits, np.float32), hw)


class _Kernel:
    def __init__(self, positions: np.ndarray):
        # Build the lattice ONCE; the mean-field loop filters it n_iter
        # times. (The one-shot permutohedral_filter ABI rebuilt the lattice
        # per message — ~29 s/img at res 320 vs ~1 s with the split.)
        self.lattice = PermutohedralLattice(
            np.ascontiguousarray(positions, np.float32))
        ones = np.ones((positions.shape[0], 1), np.float32)
        self.inv_sqrt_norm = 1.0 / np.sqrt(
            np.maximum(self.lattice.apply(ones), 1e-20)
        )

    def message(self, q: np.ndarray) -> np.ndarray:
        # symmetric normalization D^-1/2 K D^-1/2 q. The self-interaction's
        # weight is k(i,i)/norm_i ≈ 1/|neighborhood| — negligible for the
        # large-support CRF kernels, so it is not explicitly removed
        # (subtracting full q would over-correct by ~norm_i).
        tmp = self.lattice.apply(q * self.inv_sqrt_norm)
        return tmp * self.inv_sqrt_norm


# The SPATIAL kernel's positions depend only on (h, w): one lattice serves
# every same-size image. apply_lattice is const + local scratch (reentrant),
# so a cached lattice is safely shared across batch threads.
_SPATIAL_CACHE: dict = {}
_SPATIAL_LOCK = threading.Lock()
_SPATIAL_CACHE_MAX = 4  # distinct resolutions kept alive (FIFO eviction)


def _spatial_kernel(h: int, w: int) -> _Kernel:
    # the build runs UNDER the lock: when a batch's worker threads all miss
    # the same (h, w) at once, exactly one pays the multi-second native
    # build and the rest pick up the cached handle (an eval batch is
    # uniform-resolution, so cross-key contention is not a real case)
    with _SPATIAL_LOCK:
        k = _SPATIAL_CACHE.get((h, w))
        if k is not None:
            return k
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        spatial_pos = np.stack([xs / POS_XY_STD, ys / POS_XY_STD],
                               axis=-1).reshape(-1, 2)
        k = _Kernel(spatial_pos)
        if len(_SPATIAL_CACHE) >= _SPATIAL_CACHE_MAX:
            _SPATIAL_CACHE.pop(next(iter(_SPATIAL_CACHE)))
        _SPATIAL_CACHE[(h, w)] = k
        return k


def dense_crf_exact_multi(image01: np.ndarray, logits_list,
                          n_iter: int = MAX_ITER):
    """One image, MULTIPLE logit sets sharing the kernels.

    The bilateral lattice depends only on the image, so refining several
    probe outputs over the same image (eval runs linear AND cluster logits,
    reference src/eval_segmentation.py:128-135) should build it once — the
    build is over half the per-image cost. Returns a list of (H, W, C) probs,
    each bit-identical to a standalone :func:`dense_crf_exact` call.
    """
    h, w = image01.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.asarray(image01, np.float32) * 255.0
    bilateral_pos = np.concatenate([
        np.stack([xs / BI_XY_STD, ys / BI_XY_STD], axis=-1).reshape(-1, 2),
        rgb.reshape(-1, 3) / BI_RGB_STD,
    ], axis=1)

    k_sp = _spatial_kernel(h, w)  # cached per resolution
    k_bi = _Kernel(bilateral_pos)  # image-dependent: built once per image

    out = []
    for logits in logits_list:
        up = _upsample_bilinear(np.asarray(logits, np.float32), (h, w))
        unary = up - np.log(
            np.exp(up - up.max(-1, keepdims=True)).sum(-1, keepdims=True)
        ) - up.max(-1, keepdims=True)
        unary = unary.reshape(h * w, -1)
        q = _softmax(unary)
        for _ in range(n_iter):
            pairwise = POS_W * k_sp.message(q) + BI_W * k_bi.message(q)
            q = _softmax(unary + pairwise)
        out.append(q.reshape(h, w, -1))
    return out


def dense_crf_exact(image01: np.ndarray, logits: np.ndarray,
                    n_iter: int = MAX_ITER) -> np.ndarray:
    """One image: (H, W, 3) in [0,1] + (h, w, C) logits -> (H, W, C) probs."""
    return dense_crf_exact_multi(image01, [logits], n_iter)[0]


def dense_crf_exact_batch_multi(images01: np.ndarray, logits_sets,
                                n_iter: int = MAX_ITER):
    """Batch of images × multiple logit sets, filtered in parallel.

    ``logits_sets`` is a sequence of (B, h, w, C_k) arrays; per image the
    bilateral lattice is built ONCE and shared across the sets
    (:func:`dense_crf_exact_multi`). The native lattice build + apply release
    the GIL (ctypes), so the images go to one thread per core (mirrors the
    reference's per-image multiprocessing Pool,
    src/eval_segmentation.py:52-54,118); a batch of one stays on the
    caller's thread. The threads come from a process-lifetime pool so the
    native filter's thread-local apply scratch (permutohedral.cpp) stays
    warm across batches instead of being re-faulted by fresh threads every
    call. Returns one (B, H, W, C_k) array per logit set.
    """
    n = len(images01)

    def one(i):
        return dense_crf_exact_multi(images01[i],
                                     [ls[i] for ls in logits_sets], n_iter)

    if n <= 1:
        per_img = [one(i) for i in range(n)]
    else:
        per_img = list(_crf_pool().map(one, range(n)))
    return [np.stack([per_img[i][k] for i in range(n)])
            for k in range(len(logits_sets))]


_CRF_POOL = None
_CRF_POOL_LOCK = threading.Lock()


def _crf_pool() -> ThreadPoolExecutor:
    global _CRF_POOL
    with _CRF_POOL_LOCK:
        if _CRF_POOL is None:
            _CRF_POOL = ThreadPoolExecutor(max_workers=os.cpu_count() or 1,
                                           thread_name_prefix="crf")
        return _CRF_POOL
