"""Build the port's CUDA kernels and load them with ctypes.

Every ``stego_torch/csrc/*.cu`` file is compiled for Hopper (``sm_90a``)
by its own ``nvcc`` process, all started together, and the objects are
linked into one shared library with a plain C interface. The build then
takes about as long as its slowest source, not the sum of all, so a
kernel added to ``csrc/`` lengthens it only when it is the slowest one
(``chip_smoke.py`` builds every kernel inside a fixed time limit).

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o stego_torch/csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/stego_torch/libstego_torch_<hash>.so *.o -lcuda

(``-lcuda``: kernels A and C2 build their TMA tensor maps with
``cuTensorMapEncodeTiled`` from libcuda.)

The library is built at first use, into ``build/stego_torch/`` at the root of
the checkout (listed in ``.gitignore``), and named by a hash of the flags,
the sources and the headers they include (``csrc/*.cuh``), so an edited
source or header is rebuilt and an unchanged one is not. The
compiler's output, ``-Xptxas -v`` register and shared-memory counts
included, goes to ``build/stego_torch/build.log``.

Nothing here runs at import. A missing ``nvcc`` or a failed build raises:
the kernel wrappers never fall back to their plain versions for a CUDA
tensor. Each C entry returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stego_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LINK_LIBS = ("-lcuda",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entries in csrc/ (pointers and the stream as void*).
SIGNATURES = {
    "stego_layer_norm": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    "stego_add_layer_norm": (_P,) * 6 + (_I, _I, _I, _F, _I, _P),
    "stego_attention": (_P, _P, _P, _P, _I, _I, _I) + (_L,) * 12
    + (_F, _I, _I, _P),
    "stego_attention_f32": (_P, _P, _P, _P, _I, _I, _I) + (_L,) * 12
    + (_F, _I, _I, _P),
    "stego_attention_consumers": (_P, _P, _P, _P, _I, _I, _I) + (_L,) * 12
    + (_F, _I, _I, _I, _P),
    "stego_attention_narrow": (_P, _P, _P, _P, _I, _I, _I, _I) + (_L,) * 12
    + (_F, _I, _I, _P),
    "stego_attention_narrow_f32": (_P, _P, _P, _P, _I, _I, _I, _I)
    + (_L,) * 12 + (_F, _I, _I, _P),
    "stego_corr_sampled_gather": (_P,) * 17 + (_I,) * 10 + (_P,),
    "stego_corr_sampled_adjoint": (_P,) * 8 + (_I,) * 7 + (_P,),
    "stego_corr_stream_fwd": (_P,) * 11 + (_I,) * 7 + (_F, _F, _I, _P),
    "stego_corr_stream_bwd": (_P,) * 11 + (_I,) * 7 + (_P,),
    "stego_corr_stream_bwd_occupancy": (_I, _I, _I, _P),
    "stego_corr_stream_fwd_occupancy": (_I, _I, _I, _P),
    "stego_corr_stream_fwd_fixups": (_I, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or the
    toolkit's default prefix ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "stego_torch CUDA kernels cannot be built")


def sources() -> list[Path]:
    """The sources nvcc compiles, one object each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def hashed_files() -> list[Path]:
    """Every file the build reads: the sources and the headers they
    include (``csrc/*.cuh``)."""
    return sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])


def library_path(defines: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines + LINK_LIBS).encode())
    for src in hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libstego_torch_{h.hexdigest()[:16]}.so"


def build(defines: tuple = ()) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    returns its path. ``defines`` (``-DNAME=VALUE`` flags) builds a variant
    of the kernels for a tool that times one against another; the port's
    kernels take none. Raises RuntimeError when nvcc is missing or fails."""
    out = library_path(defines)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = out.with_name(f"{tag}.so.tmp")
    compiles = [[nvcc, *NVCC_FLAGS, *defines, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in compiles]
    log, error = [], None

    def record(cmd, returncode, stdout, stderr):
        nonlocal error
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if returncode != 0 and error is None:
            error = (f"nvcc failed with exit code {returncode} ({cmd[-1]}):"
                     f"\n{stderr[-4000:]}")

    for cmd, proc in zip(compiles, procs):
        stdout, stderr = proc.communicate()  # sets returncode
        record(cmd, proc.returncode, stdout, stderr)
    if error is None:
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs), *LINK_LIBS]
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        record(link, proc.returncode, proc.stdout, proc.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / f"build{'' if not defines else '.' + out.stem}.log"
     ).write_text("".join(log))
    if error is not None:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(error)
    os.replace(tmp, out)
    return out


def load(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with the C signatures of its entries."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.stego_error_string.argtypes = [ctypes.c_int]
    lib.stego_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if err != 0:
        msg = library().stego_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
