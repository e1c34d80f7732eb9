"""stego_torch's kernel build: which files name the library."""

import shutil
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

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


C2_DEFINE = "-DSTEGO_C2_FWD_ABLATION=8"


@pytest.fixture
def fake_nvcc(csrc, tmp_path, monkeypatch):
    """A stand-in for nvcc that writes an empty output and records what it
    compiled ("link" for a link) to the returned file; it fails on a
    source named in ``fail.txt`` beside it."""
    calls, fail = tmp_path / "calls.txt", tmp_path / "fail.txt"
    script = tmp_path / "nvcc"
    script.write_text(f"""#!{sys.executable}
import os, sys
args = sys.argv[1:]
what = os.path.basename(args[-1]) if "-c" in args else "link"
with open({str(calls)!r}, "a") as f:
    f.write(what + "\\n")
if os.path.exists({str(fail)!r}) and open({str(fail)!r}).read() == what:
    sys.exit("error: " + what)
open(args[args.index("-o") + 1], "w").close()
""")
    script.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(script))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return calls


def _compiled(calls):
    return Counter(w for w in calls.read_text().split() if w != "link")


def test_object_names_follow_the_defines_a_source_reads(csrc):
    """A define that only corr_stream.cu reads renames its object alone; a
    flag that is not a define renames every object."""
    for src in build.sources():
        same = build.object_path(src) == build.object_path(src, (C2_DEFINE,))
        assert same == (src.name != "corr_stream.cu"), src.name
        assert build.object_path(src) != build.object_path(src, ("-G",))


def test_header_byte_renames_every_object(csrc):
    before = {src: build.object_path(src) for src in build.sources()}
    _touch_byte(csrc / "tf32x3.cuh")
    assert all(build.object_path(src) != obj for src, obj in before.items())


def test_variants_built_together_compile_each_object_once(fake_nvcc):
    """The port's library and two C2 variants built at once, as
    chip_smoke.py builds them: every source is compiled once, corr_stream.cu
    once a build; each library's log holds every object's compile."""
    variants = ((), (C2_DEFINE,), ("-DSTEGO_C2_FWD_ABLATION=16",))
    with ThreadPoolExecutor(3) as pool:
        paths = list(pool.map(build.build, variants))
    assert len(set(paths)) == 3 and all(p.exists() for p in paths)
    names = {src.name for src in build.sources()}
    assert _compiled(fake_nvcc) == {
        name: 3 if name == "corr_stream.cu" else 1 for name in names}
    for path in paths[1:]:
        log = (build.BUILD_DIR / f"build.{path.stem}.log").read_text()
        assert all(name in log for name in names)
    assert build.build((C2_DEFINE,)) == paths[1]  # built: no compile
    assert sum(_compiled(fake_nvcc).values()) == len(names) + 2


def test_failed_compile_raises_and_is_retried(fake_nvcc):
    """nvcc's failure raises, names the source and leaves no object, so
    the next build compiles it again."""
    (fake_nvcc.parent / "fail.txt").write_text("attention.cu")
    with pytest.raises(RuntimeError, match="attention.cu"):
        build.build()
    assert not build.library_path().exists()
    (fake_nvcc.parent / "fail.txt").unlink()
    assert build.build().exists()
    assert _compiled(fake_nvcc)["attention.cu"] == 2
    assert _compiled(fake_nvcc)["layer_norm.cu"] == 1
