"""The feature-pyramid arch against the JAX package's: the head fed the same
taps at granularity 1-4 (train-mode and eval-mode BatchNorm, and the
running statistics' refresh) within rtol 1e-5, atol 1e-6 of the JAX
head's, evaluated in f32 and in f64; the sampled loss
with the code on its own 56 x 56 grid (C1's and C2's plain versions) against
the JAX gather-form loss with its coordinate and permutation draws injected
(PARITY_r05's sampled-loss tolerances); two train steps against
``stego_tpu``'s ``make_train_step`` with its draws injected, at
``tests/test_torch_train_step.py``'s gates (metrics, parameters, Adam
moments and the BatchNorm running statistics); the constants the port
copies; and the error for full-field mode on two grids. The arch over
several processes is ``tests/test_torch_ddp.py``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.models import fpn as jax_fpn
from stego_tpu.models import picie as jax_picie
from stego_tpu.models import resnet as jax_resnet
from stego_tpu.models import zoo as jax_zoo
from stego_tpu.ops import interp as jax_interp
from stego_tpu.ops.correlation import CorrLossCfg as JaxCorrLossCfg
from stego_tpu.ops.pallas_corr import \
    contrastive_correlation_loss_fused as jax_corr_loss_fused
from stego_tpu.train.segmenter import \
    UnsupervisedSegmenter as JaxUnsupervisedSegmenter
from stego_tpu.train.segmenter import make_train_step as jax_make_train_step
from stego_torch.models import convert, fpn, picie, resnet, zoo
from stego_torch.models.convert import (from_jax_params, jax_train_state,
                                        load_jax_train_state)
from stego_torch.ops import corr_stream
from stego_torch.ops.correlation import CorrLossCfg
from stego_torch.models.vit import ViTConfig
from stego_torch.train.segmenter import (UnsupervisedSegmenter,
                                         make_train_step,
                                         resolve_corr_sampling)

from tests.test_fpn import make_torch_resnet50_sd
from tests.test_torch_config import torch_config
from tests.test_torch_corr_loss import GRAD_TOL, LOSS_TOL, loss_draws, t
from tests.test_torch_train_step import METRIC_TOL, jax_step_draws, make_cfg
from tests._torch_cpu import one_intra_op_thread  # noqa: F401

HEAD_TOL = dict(rtol=1e-5, atol=1e-6)
B, DIM = 2, 5


@pytest.mark.parametrize("name,ours,theirs", [
    ("FEAT_CHANNELS", fpn.FEAT_CHANNELS, jax_fpn.FEAT_CHANNELS),
    ("EXTRA_CHANNELS", fpn.EXTRA_CHANNELS, jax_fpn.EXTRA_CHANNELS),
    ("SPATIAL_RESOLUTIONS", fpn.SPATIAL_RESOLUTIONS,
     jax_fpn.SPATIAL_RESOLUTIONS),
    ("OUT_RES", fpn.OUT_RES, jax_fpn.OUT_RES),
    ("BN_MOMENTUM", fpn.BN_MOMENTUM, jax_fpn.BN_MOMENTUM),
    ("BOTTLENECK_COUNTS", resnet.BOTTLENECK_COUNTS,
     jax_resnet.BOTTLENECK_COUNTS),
    ("STAGE_PLANES", resnet.STAGE_PLANES, jax_resnet.STAGE_PLANES),
    ("BN_EPS", resnet.BN_EPS, jax_resnet.BN_EPS),
    ("VGG11_CFG", zoo.VGG11_CFG, jax_zoo.VGG11_CFG),
    ("DENSENET121_BLOCKS", zoo.DENSENET121_BLOCKS,
     jax_zoo.DENSENET121_BLOCKS),
    ("GROWTH", zoo.GROWTH, jax_zoo.GROWTH),
    ("OUT_DIM", picie.OUT_DIM, jax_picie.OUT_DIM),
    ("DECODER_IN", picie.DECODER_IN, jax_picie.DECODER_IN),
])
def test_constants_equal_jax(name, ours, theirs):
    """The port's copies of the JAX modules' constants."""
    assert ours == theirs, name


def assert_head_close(got, want, ref, msg):
    """The port's head output ``got`` within HEAD_TOL of the JAX head's in
    f32 (``want``) and in f64 (``ref``, :func:`interpolate_f64` for its
    resizes)."""
    np.testing.assert_allclose(got, want, **HEAD_TOL, err_msg=msg)
    np.testing.assert_allclose(got, ref, **HEAD_TOL, err_msg=msg + " (f64)")


def interpolate_f64(x, size, method="bilinear", align_corners=False):
    """``stego_tpu.ops.interp.interpolate``'s bilinear resize in f64: its
    weight matrices before their f32 cast, applied as it applies them."""
    assert method == "bilinear"
    out_hw = (size, size) if isinstance(size, int) else tuple(size)
    if tuple(x.shape[1:3]) == out_hw:
        return x
    wh, ww = (jax_interp._linear_weight_matrix(o, i, align_corners)
              for o, i in zip(out_hw, x.shape[1:3]))
    out = jnp.einsum("ih,bhwc->biwc", wh, x)
    return jnp.einsum("jw,biwc->bijc", ww, out)


def taps(seed, b=B):
    """Seeded NHWC taps at ResNet-50's shapes for a res-224 image (layer2
    28 x 28, layer3 14 x 14, layer4 7 x 7) and a 40 x 40 image."""
    rng = np.random.default_rng(seed)
    shapes = {"layer2": (28, 512), "layer3": (14, 1024), "layer4": (7, 2048),
              "img": (40, 3)}
    return {k: rng.standard_normal((b, s, s, c)).astype(np.float32)
            for k, (s, c) in shapes.items()}


@pytest.mark.parametrize("granularity", [1, 2, 3, 4])
def test_fpn_head_matches_jax(granularity):
    """The head's code in training (batch statistics) and in evaluation
    (the running statistics, drawn at random), and the running statistics
    after one refresh, against the JAX head on the same taps; granularity
    3's code is discrete (log-softmax)."""
    continuous = granularity != 3
    jnet = jax_fpn.FeaturePyramidNet(granularity, DIM, continuous)
    head = jax.tree.map(np.asarray, jnet.init_head(jax.random.PRNGKey(
        granularity)))
    rng = np.random.default_rng(granularity)
    for k in range(2, granularity + 1):
        for norm in ("norm1", "norm2"):
            p = head[f"conv{k}"][norm]
            p["ema_mean"] = rng.standard_normal(p["ema_mean"].shape) \
                .astype(np.float32)
            p["ema_var"] = rng.uniform(0.5, 2.0, p["ema_var"].shape) \
                .astype(np.float32)
    x = taps(granularity)
    net = fpn.FeaturePyramidNet(granularity, DIM, continuous)
    missing, unexpected = net.load_state_dict(convert.fpn_head_state_dict(
        head), strict=False)
    assert not unexpected
    assert all(k.startswith("model.") or k.endswith("num_batches_tracked")
               for k in missing)
    tx = {k: t(v) for k, v in x.items()}
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    for train in (True, False):
        want = np.asarray(jnet.head_code(head, jx, train=train))
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_fpn, "interpolate", interpolate_f64)
            ref = np.asarray(jnet.head_code(
                jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), head),
                {k: jnp.asarray(v, jnp.float64) for k, v in x.items()},
                train=train))
        assert ref.dtype == np.float64
        with torch.no_grad():
            got = net.head_code(tx, train=train).numpy()
        assert got.shape == (B, 56, 56, DIM)
        assert_head_close(got, want, ref, f"train={train}")
    new_head = jax.tree.map(np.asarray, jnet.bn_state_update(head, jx))
    net.bn_state_update(tx)
    want_sd = convert.fpn_head_state_dict(new_head)
    for k, v in net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       **HEAD_TOL, err_msg=k)


def two_grid_maps(seed, b=3, hw=3, code_hw=56, cf=64, cc=6):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, s, c)).astype(np.float32)
                 for s, c in ((hw, cf), (hw, cf), (code_hw, cc),
                              (code_hw, cc)))


@pytest.mark.parametrize("route", ["fused", "gather"])
def test_two_grid_sampled_loss_matches_jax(route):
    """The sampled loss with 3 x 3 features and 56 x 56 code: C1's plain
    version (``route="fused"``) and the bilinear route into C2's plain
    version (``"gather"``) against the JAX front end's gather form
    (interpret mode, each tensor sampled on its own grid), its draws
    injected: losses and cd means, and the code gradients of a seeded
    combination of them."""
    arrs = two_grid_maps(5)
    b, s, neg = 3, 3, 2
    jcfg = JaxCorrLossCfg(feature_samples=s, neg_samples=neg)
    cfg = CorrLossCfg(feature_samples=s, neg_samples=neg)
    key = jax.random.PRNGKey(11)
    c1d, c2d, perms = loss_draws(key, b, s, neg)

    def total(out):
        return (out["pos_intra_loss"] + 2 * out["pos_inter_loss"]
                + 3 * out["neg_inter_loss"] + out["pos_inter_cd"]
                - out["neg_inter_cd"])

    def jfn(c1, c2):
        out = jax_corr_loss_fused(jcfg, key, jnp.asarray(arrs[0]),
                                  jnp.asarray(arrs[1]), c1, c2,
                                  interpret=True, sampling_impl="gather")
        return total(out), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(arrs[2]), jnp.asarray(arrs[3]))
    c1 = t(arrs[2]).requires_grad_(True)
    c2 = t(arrs[3]).requires_grad_(True)
    out = corr_stream.contrastive_correlation_loss_fused(
        cfg, t(arrs[0]), t(arrs[1]), c1, c2, t(c1d), t(c2d),
        [t(p) for p in perms], sampling_impl=route)
    for k in jout:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), **LOSS_TOL,
                                   err_msg=k)
    grads = torch.autograd.grad(total(out), [c1, c2])
    for g, w in zip(grads, jgrads):
        assert g.shape == (b, 56, 56, 6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_full_field_on_two_grids_raises():
    """Full-field mode pairs every feature position with the code at the
    same position: two grids raise (the JAX package cannot run them
    either)."""
    arrs = two_grid_maps(6, b=2)
    cfg = CorrLossCfg(feature_samples=2, neg_samples=1)
    perms = [torch.tensor([1, 0])]
    with pytest.raises(ValueError, match="share"):
        corr_stream.contrastive_correlation_loss_fused(
            cfg, *(t(a) for a in arrs), torch.zeros(2, 2, 2, 2),
            torch.zeros(2, 2, 2, 2), perms, full_field=True)


FPN_RES = 64


def fpn_cfg(**kw):
    base = dict(arch="feature-pyramid", model_type="resnet50", granularity=3,
                res=FPN_RES, dim=6, feature_samples=3, fused_sampling="auto",
                batch_size=B)
    base.update(kw)
    return make_cfg(**base)


def fpn_batch(seed):
    rng = np.random.default_rng(seed)
    img = (0.5 * rng.standard_normal((B, FPN_RES, FPN_RES, 3))) \
        .astype(np.float32)
    pos = img + 0.1 * rng.standard_normal(img.shape).astype(np.float32)
    label = rng.integers(-1, 5, (B, FPN_RES, FPN_RES)).astype(np.int32)
    return {"img": img, "img_pos": pos, "label": label}


# chip_smoke.py's ADAM_LIVE: the least gradient whose Adam step a step holds.
# A conv bias before a train-mode BatchNorm, and a kernel entry whose input
# channel is constant over the batch, have an analytic gradient of 0 (the
# norm takes the mean out); what both packages compute is rounding noise
# (~1e-9), which Adam's first steps turn into moves of up to lr either way.
ADAM_LIVE = 1e-7


def assert_fpn_state_close(seg, jstate, mu_before, steps, lr, dead):
    """:func:`assert_state_close`'s gates (rtol 2e-4, atol 1e-5) on the
    Adam moments and the BatchNorm running variances, and on the parameters
    where every step's JAX gradient so far (from its first moments) was at
    least ADAM_LIVE (``dead``: {path: mask} of the others, kept across
    steps); a parameter of a noise-level gradient moves at most lr a step in
    either package; a running mean, which such a bias or kernel entry
    shifts, is held where every parameter of its convolution channel is
    within the gates, within rtol 2e-4 of its channel's running std (the
    scale at which the norm reads it: a sum over thousands of inputs, it
    takes each weight's rtol times the inputs' size) and atol 1e-5."""
    got = jax_train_state(seg, like=jstate)
    tol = dict(rtol=2e-4, atol=1e-5)
    for name in ("net", "linear", "cluster"):
        ja, pa = jstate["opt"][name][0], got["opt"][name][0]
        assert int(pa.count) == int(ja.count), name
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            np.asarray(a, np.float64), np.asarray(b, np.float64), **tol),
            (pa.mu, pa.nu), (ja.mu, ja.nu))
    grads = jax.tree.map(lambda m1, m0: (np.asarray(m1) - 0.9
                                         * np.asarray(m0)) / 0.1,
                         jstate["opt"]["net"][0].mu, mu_before)
    near = {}
    flat = jax.tree_util.tree_flatten_with_path(jstate["params"])[0]
    gflat = dict(jax.tree_util.tree_flatten_with_path(got["params"])[0])
    for path, want in flat:
        have = np.asarray(gflat[path], np.float64)
        want = np.asarray(want, np.float64)
        keys = [k.key for k in path]
        close = np.abs(have - want) <= tol["atol"] + tol["rtol"] \
            * np.abs(want)
        if keys[0] != "head" or keys[-1] == "ema_var":
            assert close.all(), keys
            continue
        if keys[-1] == "ema_mean":
            continue
        key = tuple(keys)
        dead[key] = dead.get(key, False) | (np.abs(_get(grads, keys))
                                            < ADAM_LIVE)
        live = ~dead[key]
        assert close[live].all(), (keys, np.abs(have - want)[live].max())
        assert (np.abs(have - want) <= 2 * lr * steps + 1e-6).all(), keys
        if keys[-2].startswith("conv"):  # per output channel (last axis)
            norm = "norm" + keys[-2][-1]
            ch = close.reshape(-1, close.shape[-1]).all(axis=0)
            key = (keys[1], norm)
            near[key] = near.get(key, True) & ch
    for (conv, norm), ch in near.items():
        p = jstate["params"]["head"][conv][norm]
        have = got["params"]["head"][conv][norm]["ema_mean"]
        err = np.abs(have - p["ema_mean"])[ch]
        bound = tol["atol"] + tol["rtol"] * np.sqrt(p["ema_var"])[ch]
        assert (err <= bound).all(), (conv, norm, (err / bound).max())
        assert ch.mean() >= 0.25, (conv, norm, ch.mean())  # not vacuous


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("continuous", [True, False])
def test_fpn_train_step_matches_jax_two_steps(continuous):
    """Two steps of the feature-pyramid arch (granularity 3, res 64: layer4
    2 x 2, code 56 x 56; 3 x 3 samples, 2 negatives) from the same weights
    (a torchvision-layout ResNet-50 folded by both packages, the JAX head
    and train state carried across): the port's loss through C1's plain
    version on two grids, JAX's through its gather form; each step's
    metrics, then the parameters, Adam moments and BatchNorm running
    statistics (JAX's ``ema_*`` leaves), refreshed after the Adam
    updates (:func:`assert_fpn_state_close`)."""
    jcfg = fpn_cfg(continuous=continuous)
    jseg = JaxUnsupervisedSegmenter(5, jcfg)
    bb = jax_resnet.resnet50_params_from_torch(make_torch_resnet50_sd(2))
    jstate = jax.tree.map(np.asarray, jseg.init_state(jax.random.PRNGKey(4)))
    seg = from_jax_params(bb, jstate["params"], torch_config(jcfg))
    load_jax_train_state(seg, jstate)
    assert resolve_corr_sampling(seg) == "fused"
    before = {k: v.clone() for k, v in seg.state_dict().items()
              if "running" in k}
    jstep = jax.jit(jax_make_train_step(jseg, with_hist=False))
    step = make_train_step(seg, with_hist=False)
    batch = fpn_batch(7)
    tb = {k: t(v) for k, v in batch.items()}
    dead = {}
    for i in range(2):
        key = jax.random.PRNGKey(200 + i)
        rand = jax_step_draws(jseg, key, B)
        mu = jstate["opt"]["net"][0].mu
        jstate, jm = jstep(bb, jstate, batch, key)
        jstate = jax.tree.map(np.asarray, jstate)
        m = step(tb, rand)
        assert m.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       **METRIC_TOL, err_msg=k)
        assert_fpn_state_close(seg, jstate, mu, i + 1, jcfg.lr, dead)
    after = seg.state_dict()
    assert all(not torch.equal(v, after[k]) for k, v in before.items())
    assert int(after["net.conv2.double_conv.1.num_batches_tracked"]) == 2
    # the carried-out state is the JAX layout, ema leaves included
    got = jax_train_state(seg, like=jstate)
    assert "ema_mean" in got["params"]["head"]["conv3"]["norm2"]


def test_fpn_segmenter_round_trips_jax_params():
    """from_jax_params then to_jax_params gives the JAX pytrees back: the
    folded ResNet-50, the head with its running statistics and the
    probes."""
    jcfg = fpn_cfg(granularity=4, res=224)
    jseg = JaxUnsupervisedSegmenter(5, jcfg)
    bb = jax.tree.map(np.asarray, jax_resnet.resnet50_params_from_torch(
        make_torch_resnet50_sd(0)))
    params = jax.tree.map(np.asarray,
                          jseg.init_params(jax.random.PRNGKey(0)))
    seg = from_jax_params(bb, params, torch_config(jcfg))
    assert isinstance(seg.net, fpn.FeaturePyramidNet)
    assert seg.net.granularity == 4 and seg.vit_cfg is None
    bb2, params2 = convert.to_jax_params(seg)
    jax.tree.map(np.testing.assert_array_equal, bb2, bb)
    jax.tree.map(np.testing.assert_array_equal, params2, params)


def test_fpn_train_step_asks_cudnn_for_deterministic_algorithms(
        monkeypatch):
    """The feature-pyramid arch's train step sets
    ``torch.backends.cudnn.deterministic`` (on the card a run cut and
    resumed, or two straight runs, differed without it;
    ``utils/precision.py``); a ViT's leaves it."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    vit = ViTConfig(patch_size=8, embed_dim=32, depth=1, num_heads=2,
                    img_size=32)
    make_train_step(UnsupervisedSegmenter(
        5, torch_config(make_cfg(dim=6, res=32)), vit_cfg=vit),
        with_hist=False)
    assert torch.backends.cudnn.deterministic is False
    make_train_step(UnsupervisedSegmenter(5, torch_config(fpn_cfg())),
                    with_hist=False)
    assert torch.backends.cudnn.deterministic is True
