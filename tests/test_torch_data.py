"""stego_torch's data pipeline (``stego_torch/data/``) against the JAX
package's, on the JAX package's own synthetic on-disk fixtures: every
dataset class, every loader crop, both epochs, with and without the host
augmentations, item by item equal in value and dtype; the transforms and
the augmentation helpers; and the crop tool, which must write the same
files."""

import os

import numpy as np
import pytest
from PIL import Image
from scipy.io import savemat

from stego_tpu.config import Config as jax_config
from stego_tpu.data import contrastive as jax_contrastive
from stego_tpu.data import crop as jax_crop
from stego_tpu.data import datasets as jax_datasets
from stego_tpu.data import transforms as jax_transforms
from stego_torch.config import Config
from stego_torch.data import contrastive, crop, datasets, transforms

from tests.test_data import synthetic_dir  # noqa: F401
from tests.test_datasets_real_formats import (  # noqa: F401
    cityscapes_root, coco_root, potsdam_root)
from tests._torch_cpu import one_intra_op_thread  # noqa: F401

RES = 16
N_NEIGHBORS = 3


def write_nns(root, nice, image_set, crop_type, n, res=RES):
    """A KNN table with self first and distinct neighbours, under the
    reference's cache name."""
    path = contrastive.knn_cache_file(root, "vit_small", nice, image_set,
                                      crop_type, res)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, nns=np.stack(
        [(np.arange(n) + k) % n for k in range(N_NEIGHBORS + 2)], axis=1))


def both(root, dataset_name, image_set, crop_type=None, loader_crop="center",
         aug=False, pos=True, **cfg_kw):
    """The JAX package's and the port's ContrastiveSegDataset on the same
    files and config."""
    kw = dict(dataset_name=dataset_name, res=RES, crop_type=crop_type,
              num_neighbors=N_NEIGHBORS, seed=3, **cfg_kw)
    out = []
    for mod, tmod, cfg in (
            (jax_contrastive, jax_transforms, jax_config(**kw)),
            (contrastive, transforms, Config(**kw))):
        out.append(mod.ContrastiveSegDataset(
            pytorch_data_dir=root, dataset_name=dataset_name,
            crop_type=crop_type, image_set=image_set,
            transform=tmod.get_transform(RES, False, loader_crop),
            target_transform=tmod.get_transform(RES, True, loader_crop),
            cfg=cfg, aug_geometric=aug, aug_photometric=aug,
            num_neighbors=N_NEIGHBORS, mask=True, pos_images=pos,
            pos_labels=pos, seed=3))
    return out


def assert_items_equal(want_ds, got_ds, epochs=(0, 1)):
    assert len(got_ds) == len(want_ds) and got_ds.n_classes == want_ds.n_classes
    for epoch in epochs:
        want_ds.epoch = got_ds.epoch = epoch
        for i in range(len(want_ds)):
            want, got = want_ds[i], got_ds[i]
            assert sorted(got) == sorted(want)
            for k in want:
                w, g = np.asarray(want[k]), np.asarray(got[k])
                assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
                np.testing.assert_array_equal(g, w, err_msg=f"{k} item {i}")
                assert type(got[k]) is type(want[k]), k


@pytest.mark.parametrize("loader_crop", ["center", "random", None])
@pytest.mark.parametrize("aug", [False, True])
def test_directory_items_match_jax(synthetic_dir, loader_crop,  # noqa: F811
                                   aug):
    want, got = both(synthetic_dir, "directory", "train",
                     loader_crop=loader_crop, aug=aug,
                     dir_dataset_name="synth", dir_dataset_n_classes=5)
    assert_items_equal(want, got)


def test_directory_val_without_positives_matches_jax(
        synthetic_dir):  # noqa: F811
    want, got = both(synthetic_dir, "directory", "val", pos=False,
                     dir_dataset_name="synth", dir_dataset_n_classes=5)
    assert_items_equal(want, got, epochs=(0,))


@pytest.mark.parametrize("image_set", ["train", "val"])
@pytest.mark.parametrize("potsdam_ir", [False, True])
@pytest.mark.parametrize("aug", [False, True])
def test_potsdam_items_match_jax(potsdam_root, image_set,  # noqa: F811
                                 potsdam_ir, aug):
    nice = "potsdam_ir4" if potsdam_ir else "potsdam"
    n = 2 if image_set == "train" else 1
    write_nns(potsdam_root, nice, image_set, None, n)
    want, got = both(potsdam_root, "potsdam", image_set, aug=aug,
                     potsdam_ir=potsdam_ir)
    assert_items_equal(want, got)


@pytest.mark.parametrize("aug", [False, True])
def test_potsdamraw_items_match_jax(tmp_path, aug):
    root = tmp_path / "data"
    proc = root / "potsdamraw" / "processed"
    rng = np.random.default_rng(4)
    for sub in ("imgs", "gt"):
        (proc / sub).mkdir(parents=True)
    for name in ("0_0_0.mat", "0_0_1.mat"):
        savemat(proc / "imgs" / name, {"img": rng.integers(
            0, 255, (24, 20, 4), dtype=np.uint8)})
        savemat(proc / "gt" / name, {"gt": rng.integers(
            0, 6, (24, 20), dtype=np.uint8)})
    want, got = both(str(root), "potsdamraw", "all", pos=False, aug=aug)
    assert len(got) == 38 * 15 * 15
    want.dataset.files = want.dataset.files[:2]
    got.dataset.files = got.dataset.files[:2]
    assert_items_equal(want, got)


@pytest.mark.parametrize("dataset_name", ["cocostuff27", "cocostuff15",
                                          "cocostuff3"])
@pytest.mark.parametrize("image_set", ["train", "val"])
@pytest.mark.parametrize("aug", [False, True])
def test_coco_items_match_jax(coco_root, dataset_name,  # noqa: F811
                              image_set, aug):
    write_nns(coco_root, dataset_name, image_set, None, 2)
    want, got = both(coco_root, dataset_name, image_set,
                     loader_crop="random", aug=aug)
    assert_items_equal(want, got)


def test_cityscapes_and_cropped_items_match_jax(cityscapes_root,  # noqa: F811
                                                tmp_path):
    """CityscapesSeg, then the five-crop tree that each package's crop tool
    writes from it: the same files, read back by CroppedDataset as the same
    items."""
    write_nns(cityscapes_root, "cityscapes", "train", None, 4)
    for aug in (False, True):
        assert_items_equal(*both(cityscapes_root, "cityscapes", "train",
                                 aug=aug))
    cfg = dict(pytorch_data_dir=cityscapes_root, dataset_name="cityscapes",
               crop_ratio=0.5, res=RES)
    written = {}
    for name, mod, c in (("jax", jax_crop, jax_config(**cfg)),
                         ("port", crop, Config(**cfg))):
        out = mod.materialize_crops(c, "cityscapes", "train", "five", 0.5)
        moved = str(tmp_path / f"cropped_{name}")
        os.rename(out, moved)
        written[name] = moved
    files = sorted(os.path.relpath(os.path.join(d, f), written["jax"])
                   for d, _, fs in os.walk(written["jax"]) for f in fs)
    assert len(files) == 2 * 4 * 5
    for rel in files:
        with open(os.path.join(written["jax"], rel), "rb") as a, \
                open(os.path.join(written["port"], rel), "rb") as b:
            assert a.read() == b.read(), rel
    os.rename(written["port"], os.path.join(
        cityscapes_root, "cropped", "cityscapes_five_crop_0.5"))
    write_nns(cityscapes_root, "cityscapes", "train", "five", 20)
    for aug in (False, True):
        assert_items_equal(*both(cityscapes_root, "cityscapes", "train",
                                 crop_type="five", crop_ratio=0.5, aug=aug))


def test_crop_boxes_match_jax():
    assert crop.five_crop_boxes(10, 20, 5, 10) == \
        jax_crop.five_crop_boxes(10, 20, 5, 10)
    for seed in range(3):
        assert crop.random_crop_boxes(30, 40, 12, 9, seed) == \
            jax_crop.random_crop_boxes(30, 40, 12, 9, seed)


def test_unlabeled_folder_matches_jax(synthetic_dir):  # noqa: F811
    folder = os.path.join(synthetic_dir, "synth", "imgs", "val")
    want = jax_datasets.UnlabeledImageFolder(
        folder, jax_transforms.get_transform(RES, False, "center"))
    got = datasets.UnlabeledImageFolder(
        folder, transforms.get_transform(RES, False, "center"))
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        assert got[i][1] == want[i][1]


@pytest.mark.parametrize("shape", [(30, 50, 3), (50, 30, 4), (12, 12, 3)])
def test_transforms_and_augmentations_match_jax(shape):
    """get_transform on PIL images (every crop type, images and labels),
    the geometric and photometric parameter draws and their application,
    and the coordinate grid."""
    rng = np.random.default_rng(sum(shape))
    arr = rng.integers(0, 255, shape, dtype=np.uint8)
    mode = "RGBA" if shape[-1] == 4 else None
    for crop_type in ("center", "random", None):
        for is_label, img in ((False, Image.fromarray(arr, mode=mode)),
                              (True, Image.fromarray(arr[..., 0]))):
            want = jax_transforms.get_transform(20, is_label, crop_type)(
                img, np.random.default_rng(1))
            got = transforms.get_transform(20, is_label, crop_type)(
                img, np.random.default_rng(1))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    img01 = arr.astype(np.float32) / 255.0
    for seed in range(4):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        h, w = shape[:2]
        gw = jax_transforms.sample_geometric_params(r1, h, w, out_res=16)
        gp = transforms.sample_geometric_params(r2, h, w, out_res=16)
        assert (gp.flip, gp.crop_box, gp.out_res) == \
            (gw.flip, gw.crop_box, gw.out_res)
        np.testing.assert_array_equal(transforms.apply_geometric(img01, gp),
                                      jax_transforms.apply_geometric(img01,
                                                                     gw))
        pw = jax_transforms.sample_photometric_params(r1)
        pp = transforms.sample_photometric_params(r2)
        np.testing.assert_array_equal(
            transforms.apply_photometric(img01, pp),
            jax_transforms.apply_photometric(img01, pw))
    np.testing.assert_array_equal(transforms.make_coord_grid(5, 7),
                                  jax_transforms.make_coord_grid(5, 7))
    np.testing.assert_array_equal(
        transforms.normalize(img01), jax_transforms.normalize(img01))


@pytest.mark.parametrize("dataset_name,crop_type", [
    ("potsdam", None), ("potsdamraw", None), ("directory", None),
    ("cityscapes", None), ("cityscapes", "five"), ("cocostuff3", None),
    ("cocostuff15", None), ("cocostuff27", None), ("cocostuff27", "five"),
])
def test_dataset_dispatch_matches_jax(dataset_name, crop_type):
    cfg = dict(dataset_name=dataset_name, dir_dataset_name="d",
               dir_dataset_n_classes=4)
    want = jax_contrastive.dataset_dispatch(dataset_name, crop_type,
                                            jax_config(**cfg))
    got = contrastive.dataset_dispatch(dataset_name, crop_type,
                                       Config(**cfg))
    assert got["n_classes"] == want["n_classes"]
    assert got["cls"].__name__ == want["cls"].__name__
    assert got["extra"] == want["extra"]
    irs = (False, True) if dataset_name.startswith("potsdam") else (False,)
    for potsdam_ir in irs:
        assert contrastive.dataset_nice_name(
            Config(potsdam_ir=potsdam_ir, **cfg), dataset_name) == \
            jax_contrastive.dataset_nice_name(
                jax_config(potsdam_ir=potsdam_ir, **cfg), dataset_name)


def test_from_items_matches_contrastive_dataset(synthetic_dir):  # noqa: F811
    """ContrastiveSegDataset.from_items over a dataset's own items gives
    the items the file-backed dataset gives, positives included."""
    _, ds = both(synthetic_dir, "directory", "train",
                 dir_dataset_name="synth", dir_dataset_n_classes=5)
    mem = contrastive.ContrastiveSegDataset.from_items(
        [ds.dataset[i] for i in range(len(ds))], ds.n_classes, nns=ds.nns,
        num_neighbors=N_NEIGHBORS, seed=3)
    assert_items_equal(ds, mem)
    with pytest.raises(ValueError, match="KNN table"):
        contrastive.ContrastiveSegDataset.from_items(
            [ds.dataset[0]], 5, nns=ds.nns)
