"""The stego_torch train and val steps against the JAX package's, one step
and then a second with the Adam moments carried, on a small seeded model
(ViT depth 2, embed 128, res 64: 8 x 8 feature maps, batch 4). The port is
handed the JAX step's own random draws (dropout masks, coordinates,
negative permutations), reproduced from its key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.config import Config
from stego_tpu.ops.math import block_local_super_perm as jax_block_perm
from stego_tpu.ops.probe_ce import \
    upsampled_masked_cross_entropy as jax_upsampled_ce
from stego_tpu.train.segmenter import \
    UnsupervisedSegmenter as JaxUnsupervisedSegmenter
from stego_tpu.train.segmenter import _split_step_keys
from stego_tpu.train.segmenter import make_train_step as jax_make_train_step
from stego_tpu.train.segmenter import make_val_step as jax_make_val_step
from stego_tpu.train.segmenter import \
    masked_cross_entropy as jax_masked_cross_entropy
from stego_tpu.models.featurizer import dropout2d as jax_dropout2d
from stego_tpu.utils.metrics import UnsupervisedMetrics as JaxMetrics
from stego_tpu.utils.metrics import update_conf_matrix as jax_conf_matrix
from stego_torch.models.convert import (from_jax_params, jax_train_state,
                                        load_jax_train_state)
from stego_torch.models.featurizer import dropout2d
from stego_torch.ops.probe_ce import upsampled_masked_cross_entropy
from stego_torch.train.segmenter import (draw_step_randomness,
                                         make_train_step, make_val_step,
                                         masked_cross_entropy,
                                         resolve_corr_sampling)
from stego_torch.utils.metrics import UnsupervisedMetrics, update_conf_matrix

from tests.test_torch_config import torch_config
from stego_tpu.models.vit import ViTConfig as JaxViTConfig
from tests.test_torch_vit import JAX_CFG, TINY, jax_backbone, tiny_backbone

B, RES, N_CLASSES = 4, 64, 5
STATE_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_fused_sampling.py:265
METRIC_TOL = dict(rtol=2e-4, atol=1e-5)


def make_cfg(**kw):
    base = dict(dataset_name="directory", dir_dataset_name="s",
                dir_dataset_n_classes=N_CLASSES, res=RES, dim=16,
                feature_samples=2, neg_samples=2, batch_size=B,
                crop_type=None, backbone_dtype="float32",
                fused_sampling="on")
    base.update(kw)
    return Config(**base)


def make_batch(seed, label_res=RES):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, RES, RES, 3)).astype(np.float32)
    pos = img + 0.05 * rng.standard_normal(img.shape).astype(np.float32)
    label = rng.integers(-1, N_CLASSES, (B, label_res, label_res))
    label_pos = rng.integers(-1, N_CLASSES, (B, label_res, label_res))
    return {"img": img, "img_pos": pos, "label": label.astype(np.int32),
            "label_pos": label_pos.astype(np.int32)}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def jax_step_draws(jseg, key, b):
    """The random inputs the JAX train step draws from ``key``, as the
    port's ``rand`` dict: the 8-way key split (``_split_step_keys``), each
    head_code's ``split(rng)`` into two bernoulli(1 - p) keep-masks, the
    signal's dropout masks, and the loss's ``split(corr, 3)`` into uniform
    coordinates and one block_local_super_perm per ``split(k_neg, neg)``."""
    cfg = jseg.cfg
    net = jseg.net
    ks = _split_step_keys(key)

    def keep(k):
        return torch.from_numpy(np.array(jax.random.bernoulli(
            k, 1.0 - net.dropout_p, (b, 1, 1, net.n_feats))))

    out = {}
    for i in ("1", "2"):
        k1, k2 = jax.random.split(ks["head" + i])
        out[f"head{i}_keep1"], out[f"head{i}_keep2"] = keep(k1), keep(k2)
        if cfg.dropout:
            out[f"feat{i}_keep"] = keep(ks["feat" + i])
    k_c1, k_c2, k_neg = jax.random.split(ks["corr"], 3)
    s = cfg.feature_samples
    for i, k in (("1", k_c1), ("2", k_c2)):
        out["coords" + i] = torch.from_numpy(np.array(jax.random.uniform(
            k, (b, s, s, 2), jnp.float32, -1.0, 1.0)))
    out["perms"] = ([torch.from_numpy(np.array(jax_block_perm(b, nk, 1)))
                     .long() for nk in jax.random.split(k_neg,
                                                        cfg.neg_samples)]
                    if cfg.neg_samples else [])
    return out


def setup(cfg, seed=0, tiny=False):
    """JAX segmenter, backbone and train state (numpy), and the port's
    segmenter holding the same weights and train state; ``tiny``: ViT-T's
    geometry (192 wide, 3 heads of 64) instead of 2 heads of 64."""
    vit_cfg = JaxViTConfig(**TINY) if tiny else JAX_CFG
    jseg = JaxUnsupervisedSegmenter(N_CLASSES, cfg, vit_cfg=vit_cfg)
    bb = tiny_backbone(seed) if tiny else jax_backbone(seed)
    state = jax.tree.map(np.asarray,
                         jseg.init_state(jax.random.PRNGKey(seed + 1)))
    seg = from_jax_params(bb, state["params"], torch_config(cfg))
    load_jax_train_state(seg, state)
    return jseg, bb, state, seg


def assert_state_close(seg, jstate, tol=STATE_TOL):
    got = jax_train_state(seg, like=jstate)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), **tol),
        got["params"], jstate["params"])
    for name in ("net", "linear", "cluster"):
        ja, pa = jstate["opt"][name][0], got["opt"][name][0]
        assert int(pa.count) == int(ja.count), name
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            np.asarray(a, np.float64), np.asarray(b, np.float64), **tol),
            (pa.mu, pa.nu), (ja.mu, ja.nu))
    assert int(got["step"]) == int(jstate["step"])


def port_cd_near_bin_edges(seg, batch, rand):
    """How many of the port's sampled cd values (the hist inputs) lie within
    1e-6 of a histogram bin edge, before the step changes the head."""
    from stego_torch.ops.corr_stream import contrastive_correlation_loss_fused

    with torch.no_grad():
        feats = seg.net.backbone_features(torch.cat([batch["img"],
                                                     batch["img_pos"]]))
        f1, f2 = feats[:B], feats[B:]
        c1 = seg.net.head_code(f1, rand["head1_keep1"], rand["head1_keep2"])
        c2 = seg.net.head_code(f2, rand["head2_keep1"], rand["head2_keep2"])
        out = contrastive_correlation_loss_fused(
            seg.corr_cfg, f1, f2, c1, c2, rand["coords1"], rand["coords2"],
            rand["perms"], return_cd_tensors=True)
    near = {}
    for name in ("pos_intra", "pos_inter", "neg_inter"):
        x = (torch.clamp(out[name + "_cd"], -1, 1) + 1) * 32
        near[name] = int(((x - torch.round(x)).abs() < 32e-6).sum())
    return near


def run_both(cfg, n_steps=2, with_hist=True, label_res=RES, tiny=False):
    jseg, bb, jstate, seg = setup(cfg, tiny=tiny)
    jstep = jax.jit(jax_make_train_step(jseg, with_hist=with_hist))
    step = make_train_step(seg, with_hist=with_hist)
    batch = make_batch(3, label_res)
    tb = to_torch(batch)
    for i in range(n_steps):
        key = jax.random.PRNGKey(100 + i)
        rand = jax_step_draws(jseg, key, B)
        near = port_cd_near_bin_edges(seg, tb, rand) if with_hist else None
        jstate, jm = jstep(bb, jstate, batch, key)
        jstate = jax.tree.map(np.asarray, jstate)
        m = step(tb, rand)
        assert m.keys() == jm.keys()
        for k in jm:
            if k.startswith("hist/"):
                diff = np.abs(m[k].numpy() - np.asarray(jm[k])).sum()
                assert diff <= 2 * near[k[5:]], (k, diff, near)
                assert int(m[k].sum()) == int(np.asarray(jm[k]).sum())
            else:
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           **METRIC_TOL, err_msg=k)
        assert_state_close(seg, jstate)
    return seg, jstate


def test_train_step_matches_jax_two_steps():
    """Default loss (fused sampling, pointwise, zero clamp, dropout), f32:
    metrics, histograms, updated params and Adam moments after each of two
    steps."""
    run_both(make_cfg())


def test_train_step_vit_tiny_matches_jax_two_steps():
    """ViT-T's 3-head trunk with use_flash_attention in f32: JAX's
    head-major Pallas kernels (interpret mode) against the port's
    trunk_attention (its plain versions on the CPU); the same gates over
    two steps."""
    seg, _ = run_both(make_cfg(use_flash_attention=True), tiny=True)
    assert seg.net.model.cfg.num_heads == 3


def test_train_step_wide_code_many_samples_matches_jax_two_steps():
    """``dim=100, feature_samples=12``: 100 code channels and 144 samples
    an image, past one chunk of C1's code channels and one tile of its
    samples on the card (here C1's plain version; JAX: its kernel in
    interpret mode, padding both to 128); the same gates over two steps."""
    seg, _ = run_both(make_cfg(dim=100, feature_samples=12))
    assert seg.step == 2


def test_train_step_without_hist_matches_jax():
    run_both(make_cfg(), n_steps=1, with_hist=False)


def test_train_step_rec_weight_matches_jax():
    """rec_weight > 0: the decoder joins the net optimizer and the loss."""
    seg, _ = run_both(make_cfg(rec_weight=0.5), n_steps=1)
    assert len(seg.optimizers()["net"].param_groups[0]["params"]) == 8


def test_train_step_true_labels_matches_jax():
    """use_true_labels: the loss signal is the one-hot label map, at the
    feature resolution so the fused sampler sees one grid."""
    run_both(make_cfg(use_true_labels=True, dropout=False), n_steps=1,
             label_res=RES // 8)


def test_train_step_einsum_loss_matches_jax():
    """use_pallas_loss=False: the einsum oracle, its cd histograms from
    every pair."""
    cfg = make_cfg(use_pallas_loss=False, fused_sampling="auto",
                   pointwise=False, stabalize=True)
    run_both(cfg, n_steps=1)


def test_hist_and_no_hist_variants_leave_equal_states():
    cfg = make_cfg()
    seg_a, seg_b = setup(cfg)[3], setup(cfg)[3]
    tb = to_torch(make_batch(4))
    g = torch.Generator().manual_seed(0)
    rand = draw_step_randomness(seg_a, B, g)
    ma = make_train_step(seg_a, with_hist=True)(tb, rand)
    mb = make_train_step(seg_b, with_hist=False)(tb, rand)
    assert set(ma) - set(mb) == {"hist/pos_intra", "hist/pos_inter",
                                 "hist/neg_inter"}
    assert torch.equal(ma["loss/total"], mb["loss/total"])
    for (na, pa), (nb, pb) in zip(seg_a.named_parameters(),
                                  seg_b.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na


def test_bf16_train_step_close_to_jax():
    """bf16 trunk (2 heads of d = 64, so attention and LayerNorm take the
    kernels' paths, here their plain versions) and bf16 features in the
    loss: loss/total within 2e-2 relative of the JAX step's."""
    cfg = make_cfg(backbone_dtype="bfloat16")
    jseg, bb, jstate, seg = setup(cfg)
    batch = make_batch(5)
    key = jax.random.PRNGKey(7)
    rand = jax_step_draws(jseg, key, B)
    _, jm = jax.jit(jax_make_train_step(jseg))(bb, jstate, batch, key)
    m = make_train_step(seg)(to_torch(batch), rand)
    np.testing.assert_allclose(float(m["loss/total"]),
                               float(jm["loss/total"]), rtol=2e-2)


def test_draw_step_randomness_shapes():
    cfg = make_cfg()
    _, _, _, seg = setup(cfg)
    rand = draw_step_randomness(seg, B, torch.Generator().manual_seed(0))
    keys = {f"{p}{i}_{m}" for i in "12"
            for p, m in (("head", "keep1"), ("head", "keep2"),
                         ("feat", "keep"))}
    assert set(rand) == keys | {"coords1", "coords2", "perms"}
    assert rand["head1_keep1"].shape == (B, 1, 1, 128)
    assert rand["head1_keep1"].dtype == torch.bool
    assert rand["coords1"].shape == (B, 2, 2, 2)
    assert float(rand["coords1"].abs().max()) <= 1.0
    assert len(rand["perms"]) == 2 and rand["perms"][0].shape == (B,)


def test_resolve_corr_sampling():
    seg = setup(make_cfg(fused_sampling="auto"))[3]
    assert resolve_corr_sampling(seg) == "fused"
    seg.cfg = torch_config(make_cfg(fused_sampling="off"))
    assert resolve_corr_sampling(seg) == "gather"
    seg.cfg = torch_config(make_cfg(fused_sampling="on",
                                    full_field_loss=True))
    with pytest.raises(ValueError, match="fused_sampling='on'"):
        resolve_corr_sampling(seg)


def test_train_step_full_field_matches_jax_two_steps():
    """full_field_loss: the dense loss through C2's plain version (JAX: the
    streamed kernel in interpret mode), f32; the step logs cd means and no
    histograms (``segmenter.py:190``)."""
    seg, _ = run_both(make_cfg(full_field_loss=True, fused_sampling="auto"))
    assert seg.step == 2


def test_train_step_streamed_sampling_matches_jax_two_steps():
    """fused_sampling="off": grid-sampled coordinates into C2, with the
    hist variant's cd histograms."""
    run_both(make_cfg(fused_sampling="off"))


def test_train_step_pallas_loss_bf16_matches_jax_two_steps():
    """pallas_loss_bf16: the sampler resolves to "gather" and C2 runs its
    code side in bf16 with f32 sums, as on the TPU."""
    run_both(make_cfg(pallas_loss_bf16=True, fused_sampling="auto"))


def test_reset_probes_gives_fresh_probes_and_optimizers():
    cfg = make_cfg()
    seg = setup(cfg)[3]
    tb = to_torch(make_batch(1))
    g = torch.Generator().manual_seed(0)
    make_train_step(seg, with_hist=False)(tb, draw_step_randomness(seg, B, g))
    before = seg.optimizers()
    head = seg.net.cluster1[0].weight.clone()
    seg.reset_probes(torch.Generator().manual_seed(1))
    opts = seg.optimizers()
    assert not opts["linear"].state and not opts["cluster"].state
    assert opts["net"] is before["net"] and opts["net"].state
    assert torch.equal(seg.net.cluster1[0].weight, head)
    again = torch.Generator().manual_seed(1)
    w = torch.rand(seg.linear_probe.weight.shape, generator=again)
    bound = 1.0 / 16 ** 0.5
    torch.testing.assert_close(seg.linear_probe.weight, w * 2 * bound - bound)


@pytest.mark.parametrize("extra", [0, 2])
def test_val_step_matches_jax(extra):
    """f32 val step: confusion matrices equal to the JAX step's, summing to
    the valid pixels; then UnsupervisedMetrics on them equal to JAX's."""
    cfg = make_cfg(extra_clusters=extra)
    jseg, bb, state, seg = setup(cfg)
    batch = make_batch(6)
    jout = jax_make_val_step(jseg)(bb, state["params"], batch)
    out = make_val_step(seg)(to_torch(batch))
    for k in ("conf_linear", "conf_cluster"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    n_valid = int((batch["label"] >= 0).sum())
    assert int(out["conf_linear"].sum()) == n_valid
    # without Hungarian matching both packages need extra == 0
    for hungarian in (True, False) if extra == 0 else (True,):
        jm = JaxMetrics("test/", N_CLASSES, extra, hungarian)
        pm = UnsupervisedMetrics("test/", N_CLASSES, extra, hungarian)
        jm.merge_stats(np.asarray(jout["conf_cluster"]))
        pm.merge_stats(out["conf_cluster"])
        assert pm.compute() == jm.compute()
        clusters = np.arange(N_CLASSES + extra)
        if hungarian:
            np.testing.assert_array_equal(pm.map_clusters(clusters),
                                          jm.map_clusters(clusters))


def test_update_conf_matrix_matches_jax():
    rng = np.random.default_rng(2)
    preds = rng.integers(-1, 8, (3, 5, 6))
    target = rng.integers(-1, 7, (3, 5, 6))
    stats = rng.integers(0, 9, (8, 5))
    want = jax_conf_matrix(jnp.asarray(stats, jnp.int32), jnp.asarray(preds),
                           jnp.asarray(target), 5, 3)
    got = update_conf_matrix(torch.from_numpy(stats), torch.from_numpy(preds),
                             torch.from_numpy(target), 5, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    m = UnsupervisedMetrics("x/", 5, 3, True)
    m.update(preds, target)
    np.testing.assert_array_equal(m.stats, got.numpy() - stats)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("out_res", [8, 20])
def test_upsampled_masked_cross_entropy_matches_jax(dtype, rtol, out_res):
    """Loss and logit gradient; f32 to reassociation, bf16 within the bf16
    trunk's 2e-2 (the JAX version rounds between its two separable
    passes, F.interpolate once)."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    labels = rng.integers(-1, 7, (2, out_res, out_res)).astype(np.int32)

    def jfn(x):
        return jax_upsampled_ce(x, jnp.asarray(labels), 5,
                                compute_dtype=getattr(jnp, dtype))

    jl, jg = jax.value_and_grad(jfn)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = upsampled_masked_cross_entropy(x, torch.from_numpy(labels), 5,
                                          compute_dtype=getattr(torch,
                                                                dtype))
    (g,) = torch.autograd.grad(loss, [x])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=rtol)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=rtol,
                               atol=rtol * 1e-2)


@pytest.mark.parametrize("in_hw,out_hw", [((8, 8), (64, 64)),
                                          ((5, 7), (20, 9))])
def test_bilinear_matrix_upsample_equals_interpolate(in_hw, out_hw):
    """The loss's two weight-matrix matmuls give F.interpolate's bilinear
    resize (align_corners=False) in f32."""
    from stego_torch.ops.probe_ce import bilinear_matrix

    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 3) + in_hw).astype(np.float32))
    wh, ww = (bilinear_matrix(o, i) for o, i in zip(out_hw, in_hw))
    got = wh @ x @ ww.T
    want = torch.nn.functional.interpolate(x, size=out_hw, mode="bilinear",
                                           align_corners=False)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_masked_cross_entropy_and_dropout2d_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    labels = rng.integers(-1, 8, (2, 3, 4)).astype(np.int32)
    np.testing.assert_allclose(
        float(masked_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 5)),
        float(jax_masked_cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels), 5)), rtol=1e-6)
    key = jax.random.PRNGKey(3)
    keep = np.array(jax.random.bernoulli(key, 0.9, (2, 1, 1, 6)))
    np.testing.assert_array_equal(
        dropout2d(torch.from_numpy(logits), 0.1,
                  torch.from_numpy(keep)).numpy(),
        np.asarray(jax_dropout2d(jnp.asarray(logits), 0.1, key)))
