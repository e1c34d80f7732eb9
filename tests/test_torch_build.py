"""stego_torch's kernel build: which files name the library."""

import shutil

import pytest

from stego_torch.kernels import build
from tests._torch_cpu import one_intra_op_thread  # noqa: F401


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that the build reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", copy)
    return copy


def _touch_byte(path):
    data = bytearray(path.read_bytes())
    data[-1] ^= 1
    path.write_bytes(bytes(data))


def test_headers_are_hashed_and_not_compiled(csrc):
    """nvcc compiles the .cu files; the .cuh headers they include name the
    library too."""
    assert {p.suffix for p in build.sources()} == {".cu"}
    assert csrc / "tf32x3.cuh" in build.hashed_files()
    assert set(build.sources()) < set(build.hashed_files())


@pytest.mark.parametrize("name", ["tf32x3.cuh", "corr_stream.cu",
                                  "attention.cu"])
def test_library_name_changes_with_any_file_it_reads(csrc, name):
    """A byte changed in a header or a source gives another library, so a
    stale one in build/ is never loaded."""
    before = build.library_path()
    assert build.library_path() == before
    _touch_byte(csrc / name)
    assert build.library_path() != before


def test_library_name_ignores_other_files(csrc):
    (csrc / "notes.txt").write_text("not read by nvcc")
    before = build.library_path()
    _touch_byte(csrc / "notes.txt")
    assert build.library_path() == before


def test_library_name_changes_with_defines(csrc):
    """A variant built with -D flags (tools/c2_ablation.py) is a library
    of its own, never the port's."""
    port = build.library_path()
    a = build.library_path(("-DSTEGO_C2_BWD_ABLATION=1",))
    b = build.library_path(("-DSTEGO_C2_BWD_ABLATION=2",))
    assert len({port, a, b}) == 3
    assert build.library_path(("-DSTEGO_C2_BWD_ABLATION=1",)) == a
