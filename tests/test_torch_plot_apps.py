"""``python -m stego_torch.eval.plot_apps``'s three mains end to end on the
CPU against the JAX package's, on written directory datasets (res 32) and
a written 2 x 2 PotsdamRaw scene, f32: the correspondence heatmaps of
ViT-T/8 from the same DINO weights file (rtol 1e-4, atol 1e-5: twelve
blocks between the weights and the heatmaps), the PR curves' inputs, the
recalibrator's scalars and the APs from a JAX-exported checkpoint with
JAX's sample coordinates injected, and the Potsdam mosaic; and each main
refuses to run without a CUDA device unless asked for the CPU. The JAX
mains' figures are recorded, not drawn; the port's are drawn."""

import functools

import jax
import numpy as np
import pytest
import torch

from stego_tpu.eval import analysis as jan
from stego_tpu.eval import plot_apps as japps
from stego_torch.config import Config
from stego_torch.data.contrastive import dataset_nice_name
from stego_torch.eval import analysis as an
from stego_torch.eval import plot_apps as apps
from stego_torch.models.vit import VIT_CONFIGS, VisionTransformer
from stego_torch.train.knn import knn_cache_file

from tests.test_torch_analysis import (GRID, TILE, export_tiny,
                                       write_potsdamraw)
from tests._torch_cpu import one_intra_op_thread  # noqa: F401

RES = 32


def capture(monkeypatch, module, name, store, fn=None):
    """Replace ``module.name`` by ``fn`` (by default the function itself),
    its arguments and result landing in ``store``."""
    fn = fn or getattr(module, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        store.append((args, kw, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


def write_directory_set(root, n_train, n_val, seed=0):
    """A directory dataset ``synth`` of class-coloured 32 x 32 PNGs (3
    classes), as the fixture of ``tests/test_integration.py`` writes it."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, count in (("train", n_train), ("val", n_val)):
        for sub in ("imgs", "labels"):
            (root / "synth" / sub / split).mkdir(parents=True)
        for i in range(count):
            img = np.zeros((RES, RES, 3), np.uint8)
            img[:, :, i % 3] = 200
            img += rng.integers(0, 55, img.shape, dtype=np.uint8)
            label = np.full((RES, RES), i % 3, np.uint8)
            label[:4, :4] = 255
            Image.fromarray(img).save(root / "synth" / "imgs" / split
                                      / f"{i:03d}.png")
            Image.fromarray(label).save(root / "synth" / "labels" / split
                                        / f"{i:03d}.png")
    return str(root)


def test_correspondence_main_matches_jax(tmp_path, monkeypatch):
    """ViT-T/8 (3 heads, the head-major path) from one DINO weights file,
    f32: the heatmaps of the three query points and of the movie's path,
    the figure and the GIF written under output_root."""
    data_root = write_directory_set(tmp_path / "data", 8, 0)
    weights = str(tmp_path / "dino.pth")
    trunk = VisionTransformer(VIT_CONFIGS["vit_tiny"][8],
                              torch.Generator().manual_seed(1))
    torch.save(trunk.state_dict(), weights)
    argv = [f"pytorch_data_dir={data_root}", "dataset_name=directory",
            "dir_dataset_name=synth", "dir_dataset_n_classes=3",
            f"res={RES}", "model_type=vit_tiny", "dino_patch_size=8",
            "backbone_dtype=float32", f"pretrained_weights={weights}",
            f"output_root={tmp_path / 'out'}", "img_num=5",
            "plot_movie=true"]
    cfg = Config(dataset_name="directory", dir_dataset_name="synth",
                 model_type="vit_tiny")
    n = 8  # the train images; each one's two neighbours are one image
    nns = np.stack([np.arange(n), (np.arange(n) + 3) % n,
                    (np.arange(n) + 3) % n], 1)
    path = knn_cache_file(data_root, "vit_tiny",
                          dataset_nice_name(cfg, "directory"), "train",
                          None, RES)
    (tmp_path / "data" / "nns").mkdir()
    np.savez(path, nns=nns)
    figs, gifs = [], []
    capture(monkeypatch, japps, "plot_correspondence_figure", figs,
            lambda *a, **k: None)
    capture(monkeypatch, japps, "save_correspondence_gif", gifs,
            lambda *a, **k: None)
    japps.correspondence_main(argv)
    got = apps.correspondence_main(argv, device="cpu")
    (fig_args, _, _), (gif_args, _, _) = figs[0], gifs[0]
    for g, w in zip(got["heatmaps"] + got["movie"],
                    fig_args[3:5] + gif_args[3:5]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)
    assert [p.split("/")[-1] for p in got["written"]] == \
        ["correspondence.png", "attention_interp.gif"]


def jax_coords(cfg):
    """The JAX main's coordinates of batch ``b``, as the port's ``coords``
    hook takes them."""
    key = jax.random.PRNGKey(0)
    s = cfg.feature_samples

    def coords(b, n):
        k1, k2 = jax.random.split(jax.random.fold_in(key, b))
        return tuple(torch.from_numpy(np.array(jax.random.uniform(
            k, (n, s, s, 2), minval=-1, maxval=1))) for k in (k1, k2))

    return coords


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The tiny JAX-exported checkpoint the PR curves and the mosaic
    read."""
    return export_tiny(str(tmp_path_factory.mktemp("ckpt") / "m.ckpt"))


def test_pr_curves_main_matches_jax(ckpt, tmp_path, monkeypatch):
    """Two batches of 1 val image at res 320 from a JAX-exported
    checkpoint, JAX's coordinates: the four curves' scores and the label
    agreement (rtol 1e-4, atol 1e-5), the recalibrator's scalars (rtol
    1e-4, atol 1e-6) and the APs (1e-3)."""
    data_root = write_directory_set(tmp_path / "data", 0, 2)
    argv = [f"pytorch_data_dir={data_root}", "dataset_name=directory",
            "dir_dataset_name=synth", "dir_dataset_n_classes=3",
            f"model_path={ckpt}", "batch_size=1", "feature_samples=6",
            "backbone_dtype=float32", f"output_root={tmp_path / 'out'}"]
    curves, params = [], []
    capture(monkeypatch, japps, "plot_pr_curves", curves,
            lambda path, c, t: {k: jan.pr_curve_data(v, t)[2]
                                for k, v in c.items()})
    capture(monkeypatch, japps, "train_crf_recalibrator", params)
    japps.pr_curves_main(argv)
    cfg, _ = apps._cfg_from_cli(argv)
    got = apps.pr_curves_main(argv, device="cpu", coords=jax_coords(cfg))
    (_, want_curves, want_targets), _, want_aps = curves[0]
    assert got["targets"].shape == (2 * 36 * 36,)
    np.testing.assert_allclose(got["targets"], want_targets, rtol=1e-4,
                               atol=1e-5)
    assert sorted(got["curves"]) == sorted(want_curves)
    for name, w in want_curves.items():
        np.testing.assert_allclose(got["curves"][name], w, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # w2 is driven to |w2| ~ 2e-4 here, where |.| has its kink and Adam's
    # steps (lr 5e-2 x the sign of the gradient) swing it about 0: held to
    # 1e-6 absolute there, as every scalar is held to 1e-4 relative
    for k, w in params[0][2].items():
        np.testing.assert_allclose(float(got["crf_params"][k]), float(w),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for name, ap in want_aps.items():
        assert abs(got["aps"][name] - ap) <= 1e-3, name


def test_potsdam_main_matches_jax(ckpt, tmp_path, monkeypatch):
    """potsdam_main on a 2 x 2 scene (each package's potsdam_mosaic at
    grid 2, tile_res 32): the same stitched labels and the same mapped
    predictions on at least 99% of the pixels."""
    monkeypatch.chdir(tmp_path)
    root = write_potsdamraw(tmp_path / "data")
    outs = {}
    for name, mod, fn in (("jax", japps, jan.potsdam_mosaic),
                          ("port", apps, an.potsdam_mosaic)):
        store = []
        monkeypatch.setattr(mod, "potsdam_mosaic", functools.partial(
            fn, tile_res=TILE, grid=GRID))
        capture(monkeypatch, mod, "potsdam_mosaic", store)
        argv = [f"pytorch_data_dir={root}", f"model_path={ckpt}",
                "img_num=0"]
        if name == "jax":
            mod.potsdam_main(argv)
        else:
            assert mod.potsdam_main(argv, device="cpu") is store[0][2]
        outs[name] = store[0][2]
    np.testing.assert_array_equal(outs["port"]["label"], outs["jax"]["label"])
    assert (outs["port"]["cluster"] == outs["jax"]["cluster"]).mean() >= 0.99


@pytest.mark.parametrize("app", sorted(apps.APPS))
def test_plot_app_needs_a_cuda_device(app, monkeypatch):
    """Without a CUDA device each app exits before it reads anything,
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        apps.main([app, "model_path=/nonexistent.ckpt"])
