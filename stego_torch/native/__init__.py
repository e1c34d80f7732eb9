"""The permutohedral lattice (C++, loaded with ctypes); counterpart of the
lattice half of ``stego_tpu/native/__init__.py``.

``permutohedral.cpp`` is the JAX package's source byte for byte: the
permutohedral-lattice Gaussian filter (Adams, Baek & Davis, 2010) behind the
exact dense-CRF backend (``ops/crf_exact.py``; the reference's pydensecrf).
It builds at first use with one ``g++ -O3 -march=native -shared -fPIC
-std=c++17`` call into ``build/stego_torch/`` at the root of the checkout
(git-ignored), named by a hash of the source, as ``data/native_io.py``
builds the image decoder. When it cannot build or load, :func:`load_library`
raises with the compiler's message: the exact CRF has no other backend to
give way to. ctypes releases the GIL for the calls, so threads filter
images in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "permutohedral.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """The lattice's CDLL, built on first use; raises ``RuntimeError``
    naming the compiler's error when it cannot build or load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from stego_torch.kernels.build import BUILD_DIR

        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"libstego_permutohedral_{digest}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                   "-std=c++17", str(_SRC), "-o", str(tmp)]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               text=True)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    f"the permutohedral lattice did not build "
                    f"({' '.join(cmd)}):\n{e.stderr}") from e
            except OSError as e:
                raise RuntimeError(
                    f"the permutohedral lattice did not build: {e}") from e
            os.replace(tmp, lib_path)
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            raise RuntimeError(
                f"the permutohedral lattice did not load: {e}") from e
        fp = ctypes.POINTER(ctypes.c_float)
        lib.permutohedral_filter.restype = None
        lib.permutohedral_filter.argtypes = [
            fp, fp, fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.permutohedral_create.restype = ctypes.c_void_p
        lib.permutohedral_create.argtypes = [fp, ctypes.c_int, ctypes.c_int]
        lib.permutohedral_apply.restype = None
        lib.permutohedral_apply.argtypes = [ctypes.c_void_p, fp, fp,
                                            ctypes.c_int]
        lib.permutohedral_destroy.restype = None
        lib.permutohedral_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class PermutohedralLattice:
    """Build-once / filter-many lattice for a fixed position set: the
    lattice (hashing, simplex enumeration, blur neighbours) depends only on
    the positions, and mean-field inference filters one kernel 10 times an
    image."""

    def __init__(self, positions: np.ndarray):
        lib = load_library()
        positions = np.ascontiguousarray(positions, np.float32)
        if positions.ndim != 2:
            raise ValueError(f"positions must be (N, pd), got "
                             f"{positions.shape}")
        self._n, self._pd = positions.shape
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib = lib
        self._handle = lib.permutohedral_create(
            positions.ctypes.data_as(fp), self._n, self._pd)

    def apply(self, values: np.ndarray) -> np.ndarray:
        """Filter (N, vd) float32 values through the prebuilt lattice."""
        values = np.ascontiguousarray(values, np.float32)
        if values.ndim != 2 or values.shape[0] != self._n:
            raise ValueError(f"values must be ({self._n}, vd), got "
                             f"{values.shape}")
        out = np.zeros_like(values)
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.permutohedral_apply(
            self._handle, values.ctypes.data_as(fp), out.ctypes.data_as(fp),
            values.shape[1])
        return out

    def __del__(self):  # pragma: no cover - interpreter-shutdown tolerant
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.permutohedral_destroy(handle)
            self._handle = None


def permutohedral_filter(positions: np.ndarray, values: np.ndarray,
                         normalize: bool = False) -> np.ndarray:
    """out_i ~ sum_j exp(-|p_i - p_j|^2 / 2) v_j in one call (the lattice
    approximation, defined up to a global constant).

    positions: (N, pd) float32, pre-divided by the kernel's standard
    deviations. values: (N, vd) float32. normalize: divide by the filtered
    all-ones channel, a weighted average."""
    lib = load_library()
    positions = np.ascontiguousarray(positions, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    n, pd = positions.shape
    if values.shape[0] != n:
        raise ValueError(f"{n} positions but {values.shape[0]} values")
    if normalize:
        values = np.concatenate([values, np.ones((n, 1), np.float32)], axis=1)
    vd = values.shape[1]
    out = np.zeros((n, vd), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.permutohedral_filter(
        positions.ctypes.data_as(fp), values.ctypes.data_as(fp),
        out.ctypes.data_as(fp), n, pd, vd)
    if normalize:
        return out[:, :-1] / np.maximum(out[:, -1:], 1e-20)
    return out
