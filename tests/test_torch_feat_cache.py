"""stego_torch's feature cache and cached steps against the JAX package's
(``stego_tpu/train/feat_cache.py``, ``make_cached_train_step``,
``make_cached_val_step``/``_epoch``), on a small seeded model: ViT patch 8,
width 128, depth 2, 2 heads, res 32 (4 x 4 feature maps), dim 6, 3 x 3
samples, 2 negatives, 10 images cached in chunks of 4 (a short final
chunk). The port is handed the JAX step's own random draws."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.config import Config
from stego_tpu.parallel.mesh import make_mesh
from stego_tpu.train import feat_cache as jax_fc
from stego_tpu.train.segmenter import \
    make_cached_train_step as jax_make_cached_train_step
from stego_tpu.train.segmenter import \
    make_cached_val_epoch as jax_make_cached_val_epoch
from stego_tpu.train.segmenter import \
    make_cached_val_step as jax_make_cached_val_step
from stego_torch.train import feat_cache as fc
from stego_torch.train.segmenter import (draw_step_randomness,
                                         make_cached_train_step,
                                         make_cached_val_epoch,
                                         make_cached_val_step,
                                         make_train_step, make_val_step)

from tests.test_torch_config import torch_config
from tests.test_torch_train_step import (METRIC_TOL, N_CLASSES,
                                         assert_state_close, jax_step_draws,
                                         setup)

RES, N_ITEMS, CHUNK, B = 32, 10, 4, 4
F32_TOL = dict(rtol=1e-4, atol=1e-5)
IND = np.array([3, 0, 9, 5], np.int32)
IND_POS = np.array([1, 6, 2, 8], np.int32)


def make_cfg(**kw):
    base = dict(dataset_name="directory", dir_dataset_name="s",
                dir_dataset_n_classes=N_CLASSES, res=RES, dim=6,
                feature_samples=3, neg_samples=2, batch_size=CHUNK,
                crop_type=None, backbone_dtype="float32", num_neighbors=3,
                cache_backbone_feats=True)
    base.update(kw)
    return Config(**base)


class _Base:
    """Deterministic (img, label) arrays, one per index."""

    def __init__(self, n=N_ITEMS, seed=0):
        rng = np.random.default_rng(seed)
        self.items = [
            (rng.standard_normal((RES, RES, 3)).astype(np.float32),
             rng.integers(-1, N_CLASSES, (RES, RES)).astype(np.int64))
            for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _Contrastive:
    """The surface of ContrastiveSegDataset that the cache and its sampler
    read (``tests/test_feat_cache.py:65-82``)."""

    def __init__(self, seed=0, num_neighbors=3):
        self.dataset = _Base()
        self.seed = seed
        self.epoch = 0
        self.num_neighbors = num_neighbors
        rng = np.random.default_rng(1)
        self.nns = np.stack([
            np.concatenate([[i], rng.permutation(N_ITEMS)[:num_neighbors]])
            for i in range(N_ITEMS)])
        self.pos_images = True
        self.pos_labels = True

    def __len__(self):
        return len(self.dataset)


def both_caches(cfg, seed=0):
    """JAX segmenter, backbone and state, the port's segmenter, and the
    cache each package builds of the same items."""
    jseg, bb, state, seg = setup(cfg, seed)
    ds = _Contrastive()
    jcache = jax_fc.build_feat_cache(jseg, bb, ds, cfg, make_mesh(1))
    cache = fc.build_feat_cache(seg, ds, torch_config(cfg))
    return jseg, bb, state, seg, ds, jcache, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_feat_cache_matches_jax(dtype):
    """Features and labels of every item, the short final chunk's too. f32
    within rtol 1e-4, atol 1e-5; a bf16 trunk within its bf16 tolerance (max
    abs 6e-2, mean abs 4e-3, tests/test_torch_vit.py), stored as bf16."""
    *_, jcache, cache = both_caches(make_cfg(backbone_dtype=dtype))
    feats = cache["feats"]
    assert feats.shape == (N_ITEMS, RES // 8, RES // 8, 128)
    assert feats.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(cache["label"].numpy(),
                                  np.asarray(jcache["label"]))
    assert cache["label"].dtype == torch.int16
    got, want = feats.float().numpy(), np.asarray(jcache["feats"])
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        diff = np.abs(got - want)
        assert diff.max() <= 6e-2 and diff.mean() <= 4e-3, (diff.max(),
                                                             diff.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_rows_equal_trunk_output(dtype):
    """A cache row is the trunk's output for that image, in the chunk of 4
    and in the padded final chunk: f32 within rtol 1e-4, atol 1e-5; bf16
    equal to the bf16-rounded f32 output of the same trunk."""
    cfg = torch_config(make_cfg(backbone_dtype=dtype))
    seg = setup(make_cfg(backbone_dtype=dtype))[3]
    ds = _Contrastive()
    cache = fc.build_feat_cache(seg, ds, cfg)
    for i in (2, N_ITEMS - 1):
        img = torch.from_numpy(ds.dataset[i][0])[None]
        want = seg.net.backbone_features(img)[0]
        got = cache["feats"][i]
        if dtype == "float32":
            torch.testing.assert_close(got, want, **F32_TOL)
        else:
            torch.testing.assert_close(got.float(),
                                       want.bfloat16().float(), rtol=0,
                                       atol=0)


def test_estimate_and_validate_match_jax():
    """estimate_cache_gb and validate_feat_cache_cfg agree with JAX's: the
    same estimates and the same refusals."""
    jseg, _, _, seg = setup(make_cfg())
    for kw, args in ((dict(), {}), (dict(backbone_dtype="bfloat16"), {}),
                     (dict(use_salience=True), {}),
                     (dict(), dict(res=64, with_mask=False)),
                     (dict(), dict(with_mask=True))):
        cfg = make_cfg(**kw)
        assert fc.estimate_cache_gb(torch_config(cfg), seg, 1000, **args) \
            == jax_fc.estimate_cache_gb(cfg, jseg, 1000, **args)
    for bad in (dict(loader_crop_type="random"),
                dict(aug_alignment_weight=0.1), dict(crf_weight=0.1),
                dict(arch="feature-pyramid", model_type="resnet50")):
        cfg = make_cfg(**bad)
        with pytest.raises(ValueError):
            jax_fc.validate_feat_cache_cfg(cfg)
        with pytest.raises(ValueError):
            fc.validate_feat_cache_cfg(torch_config(cfg))
    jax_fc.validate_feat_cache_cfg(make_cfg())
    fc.validate_feat_cache_cfg(torch_config(make_cfg()))


def test_cache_size_cap_raises():
    cfg = make_cfg(feat_cache_max_gb=1e-9)
    seg = setup(cfg)[3]
    with pytest.raises(ValueError, match="feat_cache_max_gb"):
        fc.build_feat_cache(seg, _Contrastive(), torch_config(cfg))


@pytest.mark.parametrize("kw,when", [
    (dict(aug_alignment_weight=0.5), "step"),
    (dict(steps_per_dispatch=2), "step"),
])
def test_unported_cache_options_raise(kw, when):
    """steps_per_dispatch > 1 raises NotImplementedError naming ROADMAP
    (the sharded cache is ported: tests/test_torch_ddp.py); the
    aug-alignment loss raises ValueError in the cached step, as the cache's
    build does (the augmented view needs the trunk every step)."""
    cfg = make_cfg(**kw)
    seg = setup(make_cfg())[3]
    seg.cfg = torch_config(cfg)
    exc, match = ((ValueError, "aug_alignment_weight")
                  if cfg.aug_alignment_weight else
                  (NotImplementedError, "ROADMAP"))
    with pytest.raises(exc, match=match):
        if when == "build":
            fc.build_feat_cache(seg, _Contrastive(), seg.cfg)
        else:
            make_cached_train_step(seg)


def test_sampler_matches_jax_over_two_epochs():
    """FeatCacheSampler's (ind, ind_pos) draws are JAX's, bit for bit."""
    ds = _Contrastive(seed=5)
    port, jax_sampler = fc.FeatCacheSampler(ds), jax_fc.FeatCacheSampler(ds)
    seen = set()
    for epoch in (0, 1):
        port.epoch = jax_sampler.epoch = epoch
        for ind in range(len(port)):
            got, want = port[ind], jax_sampler[ind]
            assert got.keys() == want.keys()
            for k in want:
                assert got[k] == want[k] and got[k].dtype == want[k].dtype
            seen.add((epoch, ind, int(got["ind_pos"])))
    assert len({(i, p) for _, i, p in seen}) > N_ITEMS  # epochs differ


def compare_metrics(m, jm):
    assert m.keys() == jm.keys()
    for k in jm:
        if k.startswith("hist/"):
            # a cd within ~1e-6 of a bin edge may land in the next bin
            assert int(m[k].sum()) == int(np.asarray(jm[k]).sum()), k
            assert np.abs(m[k].numpy() - np.asarray(jm[k])).sum() <= 2, k
        else:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       **METRIC_TOL, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(fused_sampling="on"),
    dict(full_field_loss=True, fused_sampling="auto"),
    dict(fused_sampling="off"),
], ids=["sampled", "full_field", "gather"])
def test_cached_train_step_matches_jax_two_steps(kw):
    """Two f32 cached steps with Adam moments carried: metrics within rtol
    2e-4, atol 1e-5 and parameters and moments within the same
    (tests/test_torch_train_step.py, from tests/test_fused_sampling.py:265).
    Sampled: C1's plain version against the JAX kernel in interpret mode;
    full-field and gather: C2's."""
    cfg = make_cfg(**kw)
    jseg, _, jstate, seg, _, jcache, cache = both_caches(cfg)
    jstep = jax.jit(jax_make_cached_train_step(jseg))
    step = make_cached_train_step(seg)
    batch = {"ind": IND, "ind_pos": IND_POS}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(2):
        key = jax.random.PRNGKey(200 + i)
        jstate, jm = jstep(jcache, jstate, jbatch, key)
        jstate = jax.tree.map(np.asarray, jstate)
        m = step(cache, batch, jax_step_draws(jseg, key, B))
        compare_metrics(m, jm)
        assert_state_close(seg, jstate)
    assert seg.step == 2


def test_cached_step_equals_image_step():
    """The port's cached step against its own image step from the same
    state, with the same draws, on the same images: metrics within rtol
    1e-5, atol 1e-6 and parameters within the same
    (tests/test_feat_cache.py:102-128)."""
    cfg = make_cfg(fused_sampling="on")
    seg = setup(cfg)[3]
    ds = _Contrastive()
    cache = fc.build_feat_cache(seg, ds, torch_config(cfg))
    seg_img = copy.deepcopy(seg)
    rand = draw_step_randomness(seg, B, torch.Generator().manual_seed(3))
    base = ds.dataset

    def stack(sel, j):
        return torch.from_numpy(np.stack([base[int(i)][j] for i in sel]))

    img_batch = {"img": stack(IND, 0), "img_pos": stack(IND_POS, 0),
                 "label": stack(IND, 1), "label_pos": stack(IND_POS, 1)}
    m_img = make_train_step(seg_img)(img_batch, rand)
    m_c = make_cached_train_step(seg)(cache, {"ind": IND, "ind_pos": IND_POS},
                                      rand)
    assert m_img.keys() == m_c.keys()
    for k in m_img:
        torch.testing.assert_close(m_c[k], m_img[k], rtol=1e-5, atol=1e-6,
                                   msg=k)
    for (na, pa), (nb, pb) in zip(seg.named_parameters(),
                                  seg_img.named_parameters()):
        assert na == nb
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-6, msg=na)


VAL_INDS = np.array([[0, 3, 5, 7], [2, 9, 4, 1], [8, 6, -1, -1]], np.int32)


@pytest.mark.parametrize("extra", [0, 2])
def test_cached_val_step_matches_jax(extra):
    """Confusion matrices and predictions equal to JAX's for each batch,
    the padded one (ind = -1) included, which counts only its real rows'
    valid pixels."""
    cfg = make_cfg(extra_clusters=extra)
    jseg, _, state, seg, ds, jcache, cache = both_caches(cfg)
    jstep = jax.jit(jax_make_cached_val_step(jseg))
    step = make_cached_val_step(seg)
    for row in VAL_INDS:
        jout = jstep(jcache, state["params"], {"ind": jnp.asarray(row)})
        out = step(cache, {"ind": row})
        for k in ("conf_linear", "conf_cluster", "linear_preds",
                  "cluster_preds"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]),
                                          err_msg=k)
        n_valid = sum(int((ds.dataset[i][1] >= 0).sum()) for i in row
                      if i >= 0)
        assert int(out["conf_linear"].sum()) == n_valid


def test_cached_val_epoch_matches_jax_and_batch_loop():
    cfg = make_cfg(extra_clusters=1)
    jseg, _, state, seg, _, jcache, cache = both_caches(cfg)
    jout = jax.jit(jax_make_cached_val_epoch(jseg))(
        jcache, state["params"], jnp.asarray(VAL_INDS))
    out = make_cached_val_epoch(seg)(cache, torch.from_numpy(VAL_INDS))
    step = make_cached_val_step(seg)
    for k in ("conf_linear", "conf_cluster"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
        want = sum(step(cache, {"ind": row})[k] for row in VAL_INDS)
        assert torch.equal(out[k], want)


def test_cached_val_step_equals_image_val_step():
    """The port's cached val step on the same images as its image val step
    gives the same predictions and confusion matrices."""
    cfg = make_cfg()
    seg = setup(cfg)[3]
    ds = _Contrastive()
    cache = fc.build_feat_cache(seg, ds, torch_config(cfg))
    ind = VAL_INDS[0]
    batch = {"img": torch.from_numpy(np.stack([ds.dataset[i][0]
                                               for i in ind])),
             "label": torch.from_numpy(np.stack([ds.dataset[i][1]
                                                 for i in ind]))}
    out_i = make_val_step(seg)(batch)
    out_c = make_cached_val_step(seg)(cache, {"ind": ind})
    for k in out_i:
        assert torch.equal(out_i[k], out_c[k]), k
