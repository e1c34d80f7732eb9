"""Metric logging, JSONL always and TensorBoard when available;
counterpart of ``stego_tpu/utils/logging.py``.

Reference observability surface: TensorBoardLogger with scalars every
``scalar_log_freq`` steps (train_segmentation.py:133,172-177). Scalars go to
a JSONL stream (``metrics.jsonl``, machine-readable, written without TB) and
are mirrored to TB events when ``torch.utils.tensorboard`` imports. The
validation figures (panel, confusion matrix, class frequencies) are PNG
files beside ``metrics.jsonl`` (``train/app.py:save_validation_figures``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_histogram(self, step: int, name: str, values) -> None:
        if self._tb is not None:
            import numpy as np

            self._tb.add_histogram(name, np.asarray(values), int(step))

    def log_histogram_counts(self, step: int, name: str, counts,
                             lo: float = -1.0, hi: float = 1.0) -> None:
        """Log a pre-binned histogram (counts computed on device)."""
        if self._tb is None:
            return
        import numpy as np

        counts = np.asarray(counts, np.float64)
        nbins = len(counts)
        edges = np.linspace(lo, hi, nbins + 1)
        centers = (edges[:-1] + edges[1:]) / 2
        total = counts.sum()
        if total == 0:
            return
        self._tb.add_histogram_raw(
            name, min=lo, max=hi, num=int(total),
            sum=float((centers * counts).sum()),
            sum_squares=float((centers**2 * counts).sum()),
            bucket_limits=edges[1:].tolist(),
            bucket_counts=counts.tolist(),
            global_step=int(step),
        )

    def log_image(self, step: int, name: str, img_hwc) -> None:
        if self._tb is not None:
            import numpy as np

            self._tb.add_image(name, np.asarray(img_hwc), int(step),
                               dataformats="HWC")

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class AsyncMetricWriter:
    """Decouple metric fetches from the train loop.

    ``float(cuda_scalar)`` waits for the device to finish every step queued
    before it. The train loop hands device tensors straight to this writer;
    a single worker thread fetches them (one copy per drain of its queue)
    and forwards them to the wrapped logger in submission order, so the hot
    loop never synchronizes for a scalar. Values may be tensors (on any
    device), numpy arrays, or plain floats.

    An ``_imgs_seen`` count in a scalars dict is converted to an honest
    ``imgs_per_sec`` from FETCH-COMPLETION timestamps: the worker's blocking
    fetch of a step's loss finishes only after that step executed, so
    consecutive completions are spaced by true device progress — a host-side
    clock would measure the submission rate instead (the fetch-free loop
    enqueues windows far ahead of the device).

    ``close()`` drains the queue, joins the worker, closes the wrapped
    logger, and re-raises the first worker error (a logging failure must not
    pass silently, but it also must not kill an in-flight step)."""

    def __init__(self, logger):
        import queue
        import threading

        self._logger = logger
        self._q: "queue.Queue" = queue.Queue()
        self._err = None
        self._last_fetch_t = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- same surface as MetricLogger ---------------------------------
    def log_scalars(self, step: int, scalars) -> None:
        self._q.put(("scalars", int(step), scalars))

    def log_histogram(self, step: int, name: str, values) -> None:
        self._q.put(("hist", int(step), name, values))

    def log_histogram_counts(self, step: int, name: str, counts,
                             lo: float = -1.0, hi: float = 1.0) -> None:
        self._q.put(("hist_counts", int(step), name, counts, lo, hi))

    def log_image(self, step: int, name: str, img_hwc) -> None:
        self._q.put(("image", int(step), name, img_hwc))

    def _run(self):
        import queue as qmod

        import numpy as np

        pending_imgs = 0.0
        stop = False
        while not stop:
            items = [self._q.get()]
            while True:
                try:
                    items.append(self._q.get_nowait())
                except qmod.Empty:
                    break
            if items[-1] is None:
                stop = True
            work = [it for it in items if it is not None]
            if not work:
                return
            try:
                # ONE device->host copy per drain (_fetch), not one per value
                payloads = _fetch(
                    [it[2] if it[0] == "scalars" else it[3] for it in work])
                now = time.perf_counter()
                # imgs_per_sec only on the drain's LAST counted item: fetch
                # completion spacing tracks device progress at drain
                # granularity, not within a drain
                last_counted = max(
                    (i for i, it in enumerate(work)
                     if it[0] == "scalars" and "_imgs_seen" in it[2]),
                    default=None)
                for i, (it, payload) in enumerate(zip(work, payloads)):
                    kind = it[0]
                    if kind == "scalars":
                        host = {k: float(v) for k, v in payload.items()}
                        imgs = host.pop("_imgs_seen", None)
                        if imgs is not None:
                            pending_imgs += imgs
                            if i == last_counted:
                                if self._last_fetch_t is not None:
                                    dt = max(now - self._last_fetch_t, 1e-9)
                                    host["imgs_per_sec"] = pending_imgs / dt
                                self._last_fetch_t = now
                                pending_imgs = 0.0
                        self._logger.log_scalars(it[1], host)
                    elif kind == "hist":
                        self._logger.log_histogram(it[1], it[2],
                                                   np.asarray(payload))
                    elif kind == "hist_counts":
                        self._logger.log_histogram_counts(
                            it[1], it[2], np.asarray(payload), it[4], it[5])
                    elif kind == "image":
                        self._logger.log_image(it[1], it[2],
                                               np.asarray(payload))
            except Exception as e:  # noqa: BLE001 — surfaced at close()
                if self._err is None:
                    self._err = e

    def close(self):
        self._q.put(None)
        self._thread.join()
        self._logger.close()
        if self._err is not None:
            e, self._err = self._err, None
            raise RuntimeError("async metric logging failed") from e


class NullLogger:
    """No-op logger for non-primary hosts."""

    def log_scalars(self, *a, **k):
        pass

    def log_histogram(self, *a, **k):
        pass

    def log_histogram_counts(self, *a, **k):
        pass

    def log_image(self, *a, **k):
        pass

    def close(self):
        pass


def _fetch(payloads):
    """``payloads`` (each a dict of values, or one value) with every tensor
    brought to the host as numpy: the tensors of each device are flattened
    into one f64 buffer and copied with ONE device->host transfer (f64 holds
    f32 metrics and integer counts below 2**53 exactly)."""
    import torch

    leaves = []  # (payload index, key or None, tensor)
    for i, p in enumerate(payloads):
        items = p.items() if isinstance(p, dict) else [(None, p)]
        leaves += [(i, k, v) for k, v in items if isinstance(v, torch.Tensor)]
    host = {}
    by_device = {}
    for leaf in leaves:
        by_device.setdefault(leaf[2].device, []).append(leaf)
    for group in by_device.values():
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for _, _, t in group]).cpu().numpy()
        at = 0
        for i, k, t in group:
            n = t.numel()
            host[(i, k)] = flat[at:at + n].reshape(tuple(t.shape))
            at += n
    out = []
    for i, p in enumerate(payloads):
        if isinstance(p, dict):
            out.append({k: host.get((i, k), v) for k, v in p.items()})
        else:
            out.append(host.get((i, None), p))
    return out
