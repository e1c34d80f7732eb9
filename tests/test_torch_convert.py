"""Weights carried between the JAX package and stego_torch: JAX pytrees ->
port modules, and the Lightning .ckpt in both directions."""

import jax
import numpy as np
import pytest
import torch

from stego_tpu.config import Config
from stego_tpu.models.convert import \
    load_stego_checkpoint as jax_load_stego_checkpoint
from stego_tpu.models.export import export_stego_checkpoint
from stego_tpu.models.export import vit_state_dict as jax_vit_state_dict
from stego_tpu.train.segmenter import \
    UnsupervisedSegmenter as JaxUnsupervisedSegmenter
from stego_torch.models import convert
from stego_torch.models.vit import VIT_CONFIGS, VisionTransformer

from tests.test_torch_vit import CFG, JAX_CFG, jax_backbone


def make_cfg(**kw):
    base = dict(dataset_name="directory", dir_dataset_name="s",
                dir_dataset_n_classes=5, res=32, dim=6, crop_type=None,
                backbone_dtype="float32", dino_patch_size=8)
    base.update(kw)
    return Config(**base)


def jax_model(cfg, seed=0):
    seg = JaxUnsupervisedSegmenter(5, cfg, vit_cfg=JAX_CFG)
    params = jax.tree.map(np.asarray,
                          seg.init_params(jax.random.PRNGKey(seed)))
    return seg, jax_backbone(seed), params


def assert_tree_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_vit_state_dict_equals_jax_export():
    bb = jax_backbone(1)
    want = jax_vit_state_dict(bb)
    got = convert.vit_state_dict(bb)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    vit = VisionTransformer(CFG)
    vit.load_state_dict(got)  # the port's parameter names are DINO's


@pytest.mark.parametrize("projection_type", ["linear", "nonlinear"])
def test_export_stego_checkpoint_loads_into_port(tmp_path, projection_type):
    """JAX export_stego_checkpoint -> port load_stego_checkpoint: every
    tensor equal to from_jax_params on the same pytrees, cfg carried."""
    cfg = make_cfg(projection_type=projection_type, extra_clusters=1)
    _, bb, params = jax_model(cfg)
    path = str(tmp_path / "model.ckpt")
    export_stego_checkpoint(path, cfg, bb, params, step=3)
    loaded = convert.load_stego_checkpoint(path)
    direct = convert.from_jax_params(bb, params, cfg)
    assert loaded.cfg == cfg and loaded.n_classes == 5
    assert loaded.vit_cfg == CFG
    assert loaded.cluster_probe.clusters.shape == (6, 6)
    sd = direct.state_dict()
    assert loaded.state_dict().keys() == sd.keys()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_to_jax_params_inverts_from_jax_params():
    cfg = make_cfg()
    _, bb, params = jax_model(cfg, seed=2)
    got_bb, got_params = convert.to_jax_params(
        convert.from_jax_params(bb, params, cfg))
    assert_tree_equal(got_bb, bb)
    for key in ("head", "linear_probe", "cluster_probe"):
        assert_tree_equal(got_params[key], params[key])


def test_port_checkpoint_loads_into_jax(tmp_path):
    """save_stego_checkpoint -> the JAX loader: the same pytrees."""
    cfg = make_cfg()
    seg = convert.from_jax_params(*jax_model(cfg, seed=3)[1:], cfg)
    path = str(tmp_path / "port.ckpt")
    convert.save_stego_checkpoint(path, seg, step=5)
    loaded = jax_load_stego_checkpoint(path)
    bb, params = convert.to_jax_params(seg)
    assert_tree_equal(loaded["backbone"], bb)
    for key in ("head", "linear_probe", "cluster_probe"):
        assert_tree_equal(loaded[key], params[key])
    assert loaded["cfg_dict"] == cfg.to_dict()


def test_infer_vit_cfg_vit_small_8():
    cfg = VIT_CONFIGS["vit_small"][8]
    sd = VisionTransformer(cfg).state_dict()
    assert convert.infer_vit_cfg(sd) == cfg


def test_jax_train_state_round_trip_after_two_steps():
    """A JAX train state after two steps (Adam moments and counts non-zero,
    the decoder in the net group) goes into the port's modules and Adams
    and comes back unchanged."""
    from stego_tpu.train.segmenter import make_train_step

    cfg = make_cfg(rec_weight=0.5, use_pallas_loss=False, feature_samples=2,
                   neg_samples=1)
    jseg, bb, _ = jax_model(cfg)
    state = jseg.init_state(jax.random.PRNGKey(4))
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    batch = {"img": img, "img_pos": img[::-1].copy(),
             "label": rng.integers(-1, 5, (2, 32, 32)).astype(np.int32)}
    step = jax.jit(make_train_step(jseg, with_hist=False))
    for i in range(2):
        state, _ = step(bb, state, batch, jax.random.PRNGKey(10 + i))
    state = jax.tree.map(np.asarray, state)
    seg = convert.from_jax_params(bb, state["params"], cfg)
    convert.load_jax_train_state(seg, state)
    assert seg.step == 2
    net = seg.optimizers()["net"]
    assert len(net.param_groups[0]["params"]) == 8  # head + decoder
    assert all(float(st["step"]) == 2 for st in net.state.values())
    assert_tree_equal(convert.jax_train_state(seg, like=state), state)


def test_train_only_entries_cross_both_checkpoint_writers(tmp_path):
    """train_cluster_probe and the decoder: JAX export -> port load, and
    port save -> JAX loader, equal to the JAX params."""
    cfg = make_cfg()
    _, bb, params = jax_model(cfg, seed=5)
    path = str(tmp_path / "jax.ckpt")
    export_stego_checkpoint(path, cfg, bb, params)
    seg = convert.load_stego_checkpoint(path)
    np.testing.assert_array_equal(
        seg.train_cluster_probe.clusters.detach().numpy(),
        params["train_cluster_probe"]["clusters"])
    np.testing.assert_array_equal(
        seg.decoder.weight.detach().numpy()[:, :, 0, 0].T,
        params["decoder"]["kernel"])
    out = str(tmp_path / "port.ckpt")
    convert.save_stego_checkpoint(out, seg)
    loaded = jax_load_stego_checkpoint(out)
    for key in ("train_cluster_probe", "decoder"):
        assert_tree_equal(loaded[key], params[key])
    _, back = convert.to_jax_params(seg)
    for key in ("train_cluster_probe", "decoder"):
        assert_tree_equal(back[key], params[key])
