"""The trunk wrappers and ``stego_torch/eval/analysis.py`` against the JAX
package on the CPU, f32, on the same seeded numpy inputs: the four wrappers
on the small ViT, the correspondence heatmaps and the PR curves' pair
functions (rtol 1e-5, atol 1e-6), the PR curve and its AP against the JAX
function's sklearn result with tied scores (1e-12), the CRF recalibrator
against 300 optax steps (rtol 1e-4) and the Potsdam mosaic of a written
2 x 2 PotsdamRaw scene from a JAX-exported checkpoint (predictions equal
wherever the top two cluster logits differ by more than 1e-4)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import savemat

from stego_tpu.eval import analysis as jan
from stego_tpu.models import vit as jvit
from stego_tpu.models.export import export_stego_checkpoint
from stego_torch.eval import analysis as an
from stego_torch.eval.evaluate import flip_tta_code, load_model_for_eval
from stego_torch.models import vit
from stego_torch.ops.interp import interpolate
from stego_torch.ops.math import l2_normalize

from tests.test_torch_convert import jax_model, make_cfg
from tests.test_torch_vit import JAX_CFG, image, jax_backbone, port_vit
from tests._torch_cpu import one_intra_op_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
WRAPPERS = ("vit_forward_feats", "vit_cls_forward",
            "vit_get_last_selfattention", "vit_get_intermediate_layers")


@pytest.fixture(scope="module")
def trunks():
    bb = jax_backbone(2)
    return bb, port_vit(bb), image(3, 32)


@pytest.mark.parametrize("name", WRAPPERS)
def test_trunk_wrapper_matches_jax(trunks, name):
    """Each wrapper, f32 and no kernel by default, as the JAX one."""
    bb, model, img = trunks
    kw = {"n": 2} if name == "vit_get_intermediate_layers" else {}
    want = getattr(jvit, name)(bb, jnp.asarray(img), JAX_CFG, **kw)
    with torch.no_grad():
        got = getattr(vit, name)(model, torch.from_numpy(img), **kw)
    if name != "vit_get_intermediate_layers":
        want, got = [want], [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_correspondence_heatmaps_match_jax():
    rng = np.random.default_rng(0)
    f1, f2 = (rng.standard_normal((1, 6, 6, 24)).astype(np.float32)
              for _ in range(2))
    query = jan.interpolated_query_path([[-0.7, -0.7], [0.3, 0.9]],
                                        hold=2, steps=3)
    np.testing.assert_array_equal(
        query, an.interpolated_query_path([[-0.7, -0.7], [0.3, 0.9]],
                                          hold=2, steps=3))
    want = jan.correspondence_heatmaps(jnp.asarray(f1), jnp.asarray(f2),
                                       jnp.asarray(query), (40, 40))
    got = an.correspondence_heatmaps(torch.from_numpy(f1),
                                     torch.from_numpy(f2),
                                     torch.from_numpy(query), (40, 40))
    for g, w in zip(got, want):
        assert g.shape == (query.shape[1], 40, 40)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def pair_inputs(seed=1, b=2, res=16, s=5, n_classes=4):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, res, res, 3)).astype(np.float32)
    feats = rng.standard_normal((b, res // 4, res // 4, 12)).astype(
        np.float32)
    label = rng.integers(-1, n_classes, (b, res, res))
    c1, c2 = (rng.uniform(-1, 1, (b, s, s, 2)).astype(np.float32)
              for _ in range(2))
    return img, feats, label, c1, c2


@pytest.mark.parametrize("name", ["crf_pair_diffs", "crf_kernel_fd",
                                  "label_agreement_fd"])
def test_pr_pair_function_matches_jax(name):
    img, feats, label, c1, c2 = pair_inputs()
    if name == "label_agreement_fd":
        args = (feats, label, 4, c1, c2)
    else:
        args = (img, c1, c2)

    def call(mod, to):
        return getattr(mod, name)(*(to(a) if isinstance(a, np.ndarray)
                                    else a for a in args))

    want, got = call(jan, jnp.asarray), call(an, torch.from_numpy)
    if name == "crf_kernel_fd":
        want, got = [want], [got]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("levels", [5, 40, None])
def test_pr_curve_data_matches_sklearn(levels):
    """Scores rounded to ``levels`` values (ties everywhere) and
    continuous: the curve and the AP of the JAX function (sklearn's
    precision_recall_curve, average_precision_score) within 1e-12."""
    rng = np.random.default_rng(7)
    targets = rng.random(3000)
    preds = targets * 0.5 + rng.random(3000)
    if levels:
        preds = np.round(preds * levels) / levels
    want = jan.pr_curve_data(preds, targets)
    got = an.pr_curve_data(preds, targets)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert abs(got[2] - float(want[2])) <= 1e-12


def test_crf_recalibrator_matches_optax():
    """300 Adam steps at lr 5e-2 (torch.optim.Adam against optax.adam)
    give the six scalars within rtol 1e-4."""
    img, _, label, c1, c2 = pair_inputs(seed=3, b=2, res=24, s=8)
    rng = np.random.default_rng(4)
    ld = (rng.random((2, 8, 8, 8, 8)) > 0.6).astype(np.float32)
    cd, idiff = (np.array(x) for x in jan.crf_pair_diffs(
        jnp.asarray(img), jnp.asarray(c1), jnp.asarray(c2)))
    want = jan.train_crf_recalibrator(jnp.asarray(cd), jnp.asarray(idiff),
                                      jnp.asarray(ld))
    got = an.train_crf_recalibrator(torch.from_numpy(cd),
                                    torch.from_numpy(idiff),
                                    torch.from_numpy(ld))
    assert sorted(got) == sorted(want)
    init = an.init_crf_module()
    for k, w in want.items():
        assert float(got[k]) != float(init[k])  # it trained
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4)


GRID, TILE = 2, 32


@functools.lru_cache(maxsize=None)
def potsdam_tiles():
    """A PotsdamRaw scene of GRID x GRID tiles: seeded RGB .mat tiles with
    coarse-label blocks."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(GRID * GRID):
        img = rng.integers(0, 256, (TILE, TILE, 3), dtype=np.uint8)
        gt = np.repeat(np.repeat(rng.integers(0, 6, (4, 4)), 8, 0), 8, 1)
        out.append((img, gt.astype(np.uint8)))
    return out


def write_potsdamraw(root):
    proc = root / "potsdamraw" / "processed"
    for sub in ("imgs", "gt"):
        (proc / sub).mkdir(parents=True)
    for i, (img, gt) in enumerate(potsdam_tiles()):
        name = f"0_0_{i}.mat"  # PotsdamRaw's file order, scene 0
        savemat(proc / "imgs" / name, {"img": img})
        savemat(proc / "gt" / name, {"gt": gt})
    return str(root)


def export_tiny(path, seed=6):
    cfg = make_cfg()
    _, bb, params = jax_model(cfg, seed)
    export_stego_checkpoint(path, cfg, bb, params)
    return path


def test_potsdam_mosaic_matches_jax(tmp_path, monkeypatch):
    """The mosaic of a 2 x 2 scene from a JAX-exported checkpoint: the
    stitched image and labels as the JAX function's, the mapped cluster
    predictions equal wherever the top two cluster logits differ by more
    than 1e-4; both write their PNGs under the working directory."""
    monkeypatch.chdir(tmp_path)
    root = write_potsdamraw(tmp_path / "data")
    ckpt = export_tiny(str(tmp_path / "m.ckpt"))
    cfg = make_cfg(pytorch_data_dir=root)
    want = jan.potsdam_mosaic(cfg, ckpt, img_num=0, tile_res=TILE,
                              grid=GRID)
    got = an.potsdam_mosaic(cfg, ckpt, "cpu", img_num=0, tile_res=TILE,
                            grid=GRID)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["img"], want["img"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["label"], want["label"])
    seg = load_model_for_eval(ckpt, "cpu")
    imgs = torch.from_numpy(got["img"].reshape(GRID, TILE, GRID, TILE, 3)
                            .swapaxes(1, 2).reshape(-1, TILE, TILE, 3))
    with torch.no_grad():
        code = interpolate(flip_tta_code(seg, imgs), (TILE, TILE))
        logits = l2_normalize(code) @ l2_normalize(
            seg.cluster_probe.clusters, dim=1).T * 2.0
    top = torch.topk(logits, 2, dim=-1).values
    margin = (top[..., 0] - top[..., 1]).reshape(GRID, GRID, TILE, TILE) \
        .swapaxes(1, 2).reshape(GRID * TILE, GRID * TILE).numpy()
    sure = margin > 1e-4
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(got["cluster"][sure], want["cluster"][sure])
    for sub in ("img", "label", "cluster"):
        assert (tmp_path / "results" / "predictions" / "potsdam" / sub
                / "0.png").exists()
