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

A variant of the library built with ``-D`` flags (``chip_smoke.py``'s and
``tools/c2_ablation.py``'s C2 checks) compiles only the sources that read
one of its macros, and links the port's objects of the others: each object
is kept under ``build/stego_torch/obj/``, named by a hash of the flags, the
source, the headers and the defines it reads, and builds running together
in one process compile each object once.

The library is built at first use, into ``build/stego_torch/`` at the root of
the checkout (listed in ``.gitignore``), and named by a hash of the flags,
the sources and the headers they include (``csrc/*.cuh``), so an edited
source or header is rebuilt and an unchanged one is not. The
compiler's output, ``-Xptxas -v`` register and shared-memory counts
included, goes to ``build/stego_torch/build.log`` (every object's, shared
or not).

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
from concurrent.futures import Future
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
# objects being compiled in this process, so that builds running together
# (a variant beside the port's) wait for one compile instead of repeating it
_objects_lock = threading.Lock()
_compiling: dict[Path, Future] = {}


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


def _reads(define: str, text: bytes) -> bool:
    """Whether a source whose text (headers included) is ``text`` reads the
    flag ``define``: a ``-DNAME[=VALUE]`` whose NAME it holds, or any other
    flag."""
    if not define.startswith("-D"):
        return True
    return define[2:].split("=", 1)[0].encode() in text


def object_path(src: Path, defines: tuple = ()) -> Path:
    """Where the object of ``src`` compiled with ``defines`` is kept: named
    by a hash of the flags, the source, the headers and those of
    ``defines`` that it reads, so a variant shares the objects of the
    sources its defines leave alone."""
    text = src.read_bytes() + b"".join(
        p.read_bytes() for p in hashed_files() if p.suffix == ".cuh")
    reads = tuple(d for d in defines if _reads(d, text))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + reads).encode())
    h.update(src.name.encode())
    h.update(text)
    return BUILD_DIR / "obj" / f"{src.stem}_{h.hexdigest()[:16]}.o"


def _compile(nvcc: str, jobs: list) -> None:
    """Compile each (source, object, flags, future) of ``jobs``, all
    started together; the compiler's output goes beside each object (.log)
    and each future is resolved, with the error when nvcc failed."""
    procs = []
    try:
        for src, obj, defines, _ in jobs:
            tmp = obj.with_name(f"{obj.stem}.{os.getpid()}.tmp.o")
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", str(tmp),
                   str(src)]
            procs.append((cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for (_, obj, _, future), (cmd, tmp, proc) in zip(jobs, procs):
            stdout, stderr = proc.communicate()  # sets returncode
            obj.with_suffix(".log").write_text(
                " ".join(cmd) + "\n" + stdout + stderr)
            if proc.returncode == 0:
                os.replace(tmp, obj)
                error = None
            else:
                tmp.unlink(missing_ok=True)
                error = RuntimeError(
                    f"nvcc failed with exit code {proc.returncode} "
                    f"({cmd[-1]}):\n{stderr[-4000:]}")
            with _objects_lock:
                _compiling.pop(obj, None)
            if error is None:
                future.set_result(obj)
            else:
                future.set_exception(error)
    finally:  # nothing left waiting on a compile that never ran
        for _, obj, _, future in jobs:
            if not future.done():
                with _objects_lock:
                    _compiling.pop(obj, None)
                future.set_exception(RuntimeError(f"{obj.name}: not built"))


def build(defines: tuple = ()) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    returns its path. ``defines`` (``-DNAME=VALUE`` flags) builds a variant
    of the kernels for a tool that times one against another; the port's
    kernels take none. Raises RuntimeError when nvcc is missing or fails."""
    out = library_path(defines)
    if out.exists():
        return out
    nvcc = find_nvcc()
    (BUILD_DIR / "obj").mkdir(parents=True, exist_ok=True)
    objs = [object_path(src, defines) for src in sources()]
    jobs, waits = [], []
    with _objects_lock:
        for src, obj in zip(sources(), objs):
            future = _compiling.get(obj)
            if future is None and obj.exists():
                continue
            if future is None:
                future = _compiling[obj] = Future()
                jobs.append((src, obj, defines, future))
            waits.append(future)
    _compile(nvcc, jobs)
    errors = [f.exception() for f in waits if f.exception() is not None]
    log = [obj.with_suffix(".log").read_text() for obj in objs
           if obj.with_suffix(".log").exists()]
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
    if not errors:
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs), *LINK_LIBS]
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            errors.append(RuntimeError(
                f"nvcc failed with exit code {proc.returncode} (link):"
                f"\n{proc.stderr[-4000:]}"))
    (BUILD_DIR / f"build{'' if not defines else '.' + out.stem}.log"
     ).write_text("".join(log))
    if errors:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(str(errors[0]))
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
