"""The train step's salience-biased draw and aug-alignment loss against the
JAX package's (``stego_tpu/ops/correlation.py:115-157``,
``train/segmenter.py:346-363, 477-510``): the draw's mapping from indices
to coordinates, its placement and empty masks; two steps of each branch
on the small seeded model of ``tests/test_torch_train_step.py`` with the
JAX step's own draws (the salience draw's indices injected as the
uniforms that map to them) at that file's tolerances; the cached salience
step against the image step; and each rank's part of the new draws."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.ops.correlation import _draw_coords as jax_draw_coords
from stego_tpu.ops.correlation import \
    sample_nonzero_locations as jax_sample_nonzero_locations
from stego_tpu.train.segmenter import _split_step_keys
from stego_tpu.train.segmenter import make_train_step as jax_make_train_step
from stego_torch.ops import augment
from stego_torch.ops.correlation import (index_coords, salience_coords,
                                         salience_indices,
                                         sample_nonzero_locations)
from stego_torch.train import feat_cache as fc
from stego_torch.train.segmenter import (PER_IMAGE_DRAWS,
                                         draw_step_randomness, local_draws,
                                         make_cached_train_step,
                                         make_train_step)

from tests.test_torch_config import torch_config
from tests.test_torch_feat_cache import IND, IND_POS, _Contrastive
from tests.test_torch_feat_cache import make_cfg as cache_cfg
from tests.test_torch_train_step import (B, METRIC_TOL, RES,
                                         assert_state_close, jax_step_draws,
                                         make_batch, make_cfg, setup,
                                         to_torch)


def masks(seed, b, h, w):
    """(B, H, W) float masks: sparse, one all zero (the uniform fallback),
    one all ones."""
    rng = np.random.default_rng(seed)
    m = (rng.random((b, h, w)) < 0.15).astype(np.float32)
    m[1] = 0.0
    if b > 2:
        m[2] = 1.0
    return m


def jax_indices(key, mask, n):
    """The flat indices ``sample_nonzero_locations`` draws from ``key``
    (its categorical draw, ``correlation.py:128-132``)."""
    b = mask.shape[0]
    flat = jnp.asarray(mask).reshape(b, -1) > 0
    any_nz = jnp.any(flat, axis=1, keepdims=True)
    logits = jnp.where(flat | ~any_nz, 0.0, -jnp.inf)
    return np.array(jax.random.categorical(key, logits[:, None, :],
                                           axis=-1, shape=(b, n)))


def uniforms_for(mask, idx):
    """Uniforms in [0, 1) that ``salience_indices`` maps to ``idx``: the
    middle of each index's slot of the inverse CDF."""
    b = mask.shape[0]
    flat = mask.reshape(b, -1) > 0
    counts = np.cumsum(flat, axis=1)
    total = counts[:, -1:]
    rank = np.take_along_axis(counts, idx, 1) - 1
    u = np.where(total > 0, (rank + 0.5) / np.maximum(total, 1),
                 (idx + 0.5) / flat.shape[1])
    return torch.from_numpy(u.astype(np.float32))


def jax_salience_draws(key, mask, s):
    """(uniform coords, the uniforms of the mask's points, the mix
    uniforms) that the port maps to JAX's ``_draw_coords(key, ...)``."""
    b = mask.shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    idx = jax_indices(k1, mask, s * s)
    reg = jax.random.uniform(k2, (b, s, s, 2), jnp.float32, -1.0, 1.0)
    mix = jax.random.uniform(k3, (b, s, s))
    return (torch.from_numpy(np.array(reg)), uniforms_for(mask, idx),
            torch.from_numpy(np.array(mix)))


def test_index_coords_match_sample_nonzero_locations():
    """At JAX's own indices the port's coordinates equal
    ``sample_nonzero_locations``'s exactly (both axes over H, (x, y)
    order), on a non-square mask; and the uniforms made for those indices
    map back to them."""
    b, h, w, n = 4, 6, 10, 50
    mask = masks(0, b, h, w)
    key = jax.random.PRNGKey(3)
    idx = jax_indices(key, mask, n)
    want = np.asarray(jax_sample_nonzero_locations(key, jnp.asarray(mask),
                                                   n))
    got = index_coords(torch.from_numpy(idx), h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    back = salience_indices(torch.from_numpy(mask), uniforms_for(mask, idx))
    np.testing.assert_array_equal(back.numpy(), idx)


def test_points_land_on_mask_and_empty_masks_are_uniform():
    """Every point of a nonempty mask lies on a nonzero pixel; an empty
    mask's points cover the whole map, as JAX's fallback does."""
    b, h, w, n = 3, 8, 8, 4000
    mask = torch.from_numpy(masks(1, b, h, w))
    u = torch.rand((b, n), generator=torch.Generator().manual_seed(0))
    idx = salience_indices(mask, u)
    flat = mask.reshape(b, -1)
    assert bool((flat[[0, 2]].gather(1, idx[[0, 2]]) > 0).all())
    assert set(idx[1].tolist()) == set(range(h * w))
    # every nonzero pixel of mask 0 is reachable
    assert set(idx[0].tolist()) == set(torch.nonzero(flat[0])[:, 0].tolist())
    coords = sample_nonzero_locations(mask, u)
    assert coords.shape == (b, n, 2) and float(coords.abs().max()) <= 1.0


def test_salience_coords_match_draw_coords():
    """The 90/10 mix of mask points and uniform points equals JAX's
    ``_draw_coords`` at its own draws, bit for bit."""
    from stego_tpu.ops.correlation import CorrLossCfg as JaxCorrLossCfg

    s = 5
    mask = masks(2, B, 16, 16)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_draw_coords(key, B, s, jnp.asarray(mask),
                                      JaxCorrLossCfg(use_salience=True)))
    reg, u, mix = jax_salience_draws(key, mask, s)
    got = salience_coords(torch.from_numpy(mask), u, reg, mix)
    np.testing.assert_array_equal(got.numpy(), want)


def branch_draws(jseg, key, batch):
    """The JAX step's draws as the port's ``rand``: those of
    ``tests/test_torch_train_step.py``, the salience draw's, and the
    augmented view's head masks (``ks["head3"]``)."""
    cfg = jseg.cfg
    net = jseg.net
    rand = jax_step_draws(jseg, key, B)
    ks = _split_step_keys(key)
    if cfg.use_salience:
        k_c1, k_c2, _ = jax.random.split(ks["corr"], 3)
        for i, k, m in (("1", k_c1, "mask"), ("2", k_c2, "mask_pos")):
            reg, u, mix = jax_salience_draws(k, batch[m],
                                             cfg.feature_samples)
            rand[f"coords{i}"] = reg
            rand[f"salience_u{i}"] = u
            rand[f"salience_mix{i}"] = mix
    if cfg.aug_alignment_weight > 0:
        k1, k2 = jax.random.split(ks["head3"])
        for name, k in (("head3_keep1", k1), ("head3_keep2", k2)):
            rand[name] = torch.from_numpy(np.array(jax.random.bernoulli(
                k, 1.0 - net.dropout_p, (B, 1, 1, net.n_feats))))
    return rand


def branch_batch(cfg, seed):
    batch = make_batch(seed)
    if cfg.use_salience:
        batch["mask"] = masks(seed + 1, B, RES, RES)
        batch["mask_pos"] = masks(seed + 2, B, RES, RES)
    if cfg.aug_alignment_weight > 0:
        # the host route's view: JAX's device augmentation of img
        img_aug, coord_aug = jax.jit(
            __import__("stego_tpu.ops.augment", fromlist=["x"])
            .device_augment)(jax.random.PRNGKey(seed), batch["img"])
        batch["img_aug"] = np.asarray(img_aug)
        batch["coord_aug"] = np.asarray(coord_aug)
    return batch


def run_branch(cfg, n_steps=2):
    jseg, bb, jstate, seg = setup(cfg)
    jstep = jax.jit(jax_make_train_step(jseg, with_hist=False))
    step = make_train_step(seg, with_hist=False)
    batch = branch_batch(cfg, 3)
    tb = to_torch(batch)
    for i in range(n_steps):
        key = jax.random.PRNGKey(100 + i)
        rand = branch_draws(jseg, key, batch)
        jstate, jm = jstep(bb, jstate, batch, key)
        jstate = jax.tree.map(np.asarray, jstate)
        m = step(tb, rand)
        assert m.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       **METRIC_TOL, err_msg=k)
        assert_state_close(seg, jstate)
    return seg, m


@pytest.mark.parametrize("sampling", ["on", "off"])
def test_salience_train_step_matches_jax_two_steps(sampling):
    """use_salience, sampled through C1 (``fused_sampling="on"``) and
    grid-sampled into C2 (``"off"``): metrics, parameters and Adam moments
    after each of two steps, one mask empty and one full."""
    run_branch(make_cfg(use_salience=True, fused_sampling=sampling))


def test_aug_alignment_train_step_matches_jax_two_steps():
    """aug_alignment_weight > 0 on the host route (the batch's img_aug and
    coord_aug): the trunk over img ‖ img_pos ‖ img_aug, the augmented
    view's code against the resampled code."""
    seg, m = run_branch(make_cfg(aug_alignment_weight=0.5))
    assert "loss/aug_alignment" in m


def test_device_aug_step_equals_host_route_on_its_view():
    """The device route (``device_augs``, no img_aug in the batch) is the
    host route fed the view ``ops/augment.py`` makes from the same
    parameters."""
    cfg = torch_config(make_cfg(aug_alignment_weight=0.5))
    seg = setup(make_cfg(aug_alignment_weight=0.5))[3]
    seg_host = copy.deepcopy(seg)
    tb = to_torch(make_batch(6))
    rand = draw_step_randomness(seg, B, torch.Generator().manual_seed(2))
    assert rand["aug_geom"].top.shape == (B,) and cfg.device_augs
    img_aug, coord_aug = augment.device_augment(tb["img"], rand["aug_geom"],
                                                rand["aug_photo"])
    m_dev = make_train_step(seg)(tb, rand)
    m_host = make_train_step(seg_host)(
        dict(tb, img_aug=img_aug, coord_aug=coord_aug), rand)
    for k in m_dev:
        torch.testing.assert_close(m_dev[k], m_host[k], rtol=0, atol=0,
                                   msg=k)


def test_salience_full_field_raises():
    seg = setup(make_cfg(use_salience=True, full_field_loss=True,
                         fused_sampling="auto"))[3]
    tb = to_torch(branch_batch(seg.cfg, 0))
    with pytest.raises(ValueError, match="full_field_loss"):
        make_train_step(seg)(tb, draw_step_randomness(
            seg, B, torch.Generator().manual_seed(0)))


class _MaskedContrastive(_Contrastive):
    """The cache tests' items with a mask (label > 0) as third entry, as
    the datasets give it."""

    def __init__(self):
        super().__init__()
        base = self.dataset
        base.items = [(img, lbl, (lbl > 0).astype(np.float32))
                      for img, lbl in base.items]


def test_cached_salience_step_equals_image_step():
    """The cache keeps the masks as float16 (exact for 0 and 1) and the
    cached step takes them by index: on the same draws it is the image
    step on the same images and masks."""
    cfg = cache_cfg(fused_sampling="on", use_salience=True)
    seg = setup(cfg)[3]
    ds = _MaskedContrastive()
    cache = fc.build_feat_cache(seg, ds, torch_config(cfg))
    assert cache["mask"].dtype == torch.float16
    seg_img = copy.deepcopy(seg)
    rand = draw_step_randomness(seg, B, torch.Generator().manual_seed(3))
    base = ds.dataset

    def stack(sel, j):
        return torch.from_numpy(np.stack([base[int(i)][j] for i in sel]))

    img_batch = {"img": stack(IND, 0), "img_pos": stack(IND_POS, 0),
                 "label": stack(IND, 1), "label_pos": stack(IND_POS, 1),
                 "mask": stack(IND, 2), "mask_pos": stack(IND_POS, 2)}
    m_img = make_train_step(seg_img)(img_batch, rand)
    m_c = make_cached_train_step(seg)(cache, {"ind": IND, "ind_pos": IND_POS},
                                      rand)
    for k in m_img:
        torch.testing.assert_close(m_c[k], m_img[k], rtol=1e-5, atol=1e-6,
                                   msg=k)
    for (na, pa), (nb, pb) in zip(seg.named_parameters(),
                                  seg_img.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-6, msg=na)


def test_local_draws_slice_the_new_draws():
    """Over W ranks each rank takes its rows of the salience uniforms, the
    augmented view's head masks and every field of the augmentation's
    parameters."""
    seg = setup(make_cfg(use_salience=True, aug_alignment_weight=0.5))[3]
    rand = draw_step_randomness(seg, B, torch.Generator().manual_seed(5))
    for k in ("salience_u1", "salience_mix2", "head3_keep1", "aug_geom",
              "aug_photo"):
        assert k in rand and k in PER_IMAGE_DRAWS
    seg.world, seg.rank = 2, 1
    mine = local_draws(seg, rand, slice(2, 4))
    for k in ("salience_u1", "salience_u2", "salience_mix1",
              "salience_mix2", "head3_keep1", "head3_keep2"):
        assert torch.equal(mine[k], rand[k][2:4]), k
    for k in ("aug_geom", "aug_photo"):
        assert type(mine[k]) is type(rand[k])
        for a, b in zip(mine[k], rand[k]):
            assert torch.equal(a, b[2:4]), k
