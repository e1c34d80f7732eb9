"""The port's synthetic accuracy benchmark against the JAX package's
(``stego_tpu/data/synthetic.py``): the PNG tree its standard-library
encoder writes decodes (PIL, here only) pixel for pixel to the one the
JAX package writes with PIL at the same seed; the port's decoders read it
back; and ``tiny_benchmark_setup`` gives the JAX package's configuration."""

import dataclasses
import os

import numpy as np
import pytest
from PIL import Image

from stego_tpu.data import synthetic as jsyn
from stego_torch.data import synthetic as syn
from stego_torch.data.datasets import DirectoryDataset
from stego_torch.data.transforms import get_transform, normalize

from tests.test_torch_config import torch_config
from tests._torch_cpu import one_intra_op_thread  # noqa: F401


def files(base):
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)


def test_png_tree_equals_jax_pixel_for_pixel(tmp_path):
    """Same files, the same ``.complete`` marker, and every image and label
    (255 for -1) decoded equal, at a non-default seed and size."""
    kw = dict(n_train=3, n_val=2, res=24, n_classes=3, seed=5)
    ours = syn.write_synthetic_benchmark(str(tmp_path / "port"), **kw)
    theirs = jsyn.write_synthetic_benchmark(str(tmp_path / "jax"), **kw)
    assert files(ours) == files(theirs)
    assert ".complete" in files(ours)
    pngs = [f for f in files(ours) if f.endswith(".png")]
    assert len(pngs) == 2 * (3 + 2)
    for f in pngs:
        with Image.open(os.path.join(ours, f)) as a, \
                Image.open(os.path.join(theirs, f)) as b:
            assert a.mode == b.mode and a.size == b.size, f
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)
    lbl = np.asarray(Image.open(os.path.join(ours, "labels/val/0001.png")))
    assert (lbl[:2] == 255).all() and set(np.unique(lbl)) <= {0, 1, 2, 255}
    # written once: a second call leaves the tree alone
    mtime = os.path.getmtime(os.path.join(ours, "imgs/train/0000.png"))
    syn.write_synthetic_benchmark(str(tmp_path / "port"), **kw)
    assert os.path.getmtime(os.path.join(ours, "imgs/train/0000.png")) \
        == mtime


def test_directory_dataset_reads_the_tree(tmp_path):
    """DirectoryDataset at the benchmark's resolution gives the rendered
    scenes back: the image normalised from its uint8 rounding and the
    label with the ignore stripe as written (255, which the metrics ignore
    as >= n_classes, as the reference's directory datasets do), by the
    native decoder where it builds and by PIL otherwise."""
    kw = dict(n_train=2, n_val=1, res=32, n_classes=4, seed=1)
    base = syn.write_synthetic_benchmark(str(tmp_path), **kw)
    ds = DirectoryDataset(str(tmp_path), "synthbench", "train",
                          get_transform(32, False, "center"),
                          get_transform(32, True, "center"))
    rng = np.random.default_rng(1)
    for i in range(2):
        img, label = syn.render_scene(rng, 32, 4)
        got_img, got_label, mask = ds[i]
        u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.float32)
        np.testing.assert_allclose(got_img, normalize(u8 / 255.0),
                                   rtol=0, atol=1e-5)
        want = np.where(label < 0, 255, label)
        np.testing.assert_array_equal(got_label, want)
        np.testing.assert_array_equal(mask, (want > 0).astype(np.float32))
    assert os.path.isdir(os.path.join(base, "labels", "val"))


@pytest.mark.parametrize("pixels", [
    np.arange(12, dtype=np.uint8).reshape(3, 4),
    np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)])
def test_write_png_round_trips(tmp_path, pixels):
    path = str(tmp_path / "x.png")
    syn.write_png(path, pixels)
    with Image.open(path) as im:
        assert im.mode == ("L" if pixels.ndim == 2 else "RGB")
        np.testing.assert_array_equal(np.asarray(im), pixels)
    with pytest.raises(ValueError):
        syn.write_png(path, np.zeros((2, 2, 4), np.uint8))


def test_tiny_benchmark_setup_matches_jax(tmp_path):
    """The same Config fields (every one) and ViTConfig, overrides
    applied, and the same dataset under ``<root>/data``."""
    cfg, vit = syn.tiny_benchmark_setup(str(tmp_path / "p"), n_train=2,
                                        n_val=1, backbone_dtype="bfloat16")
    jcfg, jvit = jsyn.tiny_benchmark_setup(str(tmp_path / "p"), n_train=2,
                                           n_val=1, backbone_dtype="bfloat16")
    assert cfg == torch_config(jcfg)
    assert dataclasses.asdict(vit) == dataclasses.asdict(jvit)
    assert (vit.embed_dim, vit.num_heads, vit.depth) == (32, 4, 2)
    assert os.path.exists(os.path.join(str(tmp_path / "p"), "data",
                                       "synthbench", ".complete"))
