"""stego_torch's KNN precompute (``stego_torch/train/knn.py``) and scene
renderer (``stego_torch/data/synthetic.py``) against the JAX package's:
the embedding, the chunked top-k at several chunk sizes, the ``.npz``
cache and its file name, and the renderer's copy, pinned equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.data import synthetic as jax_synthetic
from stego_tpu.data.contrastive import knn_cache_file as jax_knn_cache_file
from stego_tpu.train import knn as jax_knn
from stego_torch.data import synthetic
from stego_torch.train import knn

from tests.test_torch_train_step import setup
from tests.test_torch_feat_cache import make_cfg


def tie_free_feats(n, d, seed):
    """(n, d) l2-normalised rows whose cosine similarities are at least
    1e-4 apart within every row, so that no two orders of the sums can
    rank them differently."""
    rng = np.random.default_rng(seed)
    while True:
        x = rng.standard_normal((n, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        sims = np.sort(x.astype(np.float64) @ x.T.astype(np.float64), axis=1)
        if np.diff(sims, axis=1).min() > 1e-4:
            return x


@pytest.mark.parametrize("k,n_chunks,max_sims_bytes", [
    (5, 16, 1 << 30), (5, 1, 1 << 30), (7, 4, 4 * 37 * 3), (50, 3, 1 << 30),
])
def test_topk_neighbors_matches_jax(k, n_chunks, max_sims_bytes):
    """The same neighbours in the same order as the JAX package's, with
    chunks of N // n_chunks rows, capped by max_sims_bytes (3 rows), and k
    above N (capped at N)."""
    feats = tie_free_feats(37, 16, k)
    want = np.asarray(jax_knn.topk_neighbors(
        feats, k=k, n_chunks=n_chunks, max_sims_bytes=max_sims_bytes))
    got = knn.topk_neighbors(torch.from_numpy(feats), k=k, n_chunks=n_chunks,
                             max_sims_bytes=max_sims_bytes)
    assert got.dtype == np.int32 and got.shape == (37, min(k, 37))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], np.arange(37))


def test_embed_matches_jax():
    """The l2-normalised mean-pooled f32 trunk features, within rtol 1e-4,
    atol 1e-5."""
    jseg, bb, _, seg = setup(make_cfg())
    img = np.random.default_rng(0).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_knn.make_embed_fn(jseg.net, bb)(jnp.asarray(img)))
    embed = knn.make_embed_fn(seg.net)
    got = knn.embed_dataset(embed, [torch.from_numpy(img[:2]),
                                    {"img": torch.from_numpy(img[2:])}])
    assert got.shape == (3, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_build_knn_cache_npz_round_trip(tmp_path):
    """build_knn_cache saves the reference's compressed .npz (key nns,
    int32) under knn_cache_file's name; it loads back equal, every image
    first among its own neighbours, as the JAX package's build gives on the
    port's embeddings."""
    seg = setup(make_cfg())[3]
    imgs = [torch.from_numpy(synthetic.render_scene(
        np.random.default_rng(i), 32, 5)[0]) for i in range(12)]
    loader = [torch.stack(imgs[i:i + 4]) for i in range(0, 12, 4)]
    path = knn.knn_cache_file(str(tmp_path), "vit_small", "synth", "train",
                              None, 32)
    nns = knn.build_knn_cache(path, seg.net, loader, k=5)
    with np.load(path) as f:
        assert list(f.keys()) == ["nns"]
        np.testing.assert_array_equal(f["nns"], nns)
        assert f["nns"].dtype == np.int32
    assert nns.shape == (12, 5)
    np.testing.assert_array_equal(nns[:, 0], np.arange(12))
    embeds = knn.embed_dataset(knn.make_embed_fn(seg.net), loader).numpy()
    np.testing.assert_array_equal(
        nns, np.asarray(jax_knn.topk_neighbors(embeds, k=5)))


@pytest.mark.parametrize("args", [
    ("/data", "vit_small", "cocostuff27", "train", None, 224),
    ("d", "vit_base", "cityscapes", "val", "five", 320),
])
def test_knn_cache_file_matches_jax(args):
    assert knn.knn_cache_file(*args) == jax_knn_cache_file(*args)


@pytest.mark.parametrize("res,n_classes", [(224, 27), (40, 3)])
def test_render_scene_matches_jax(res, n_classes):
    """The port's copy of render_scene gives JAX's scene bit for bit from
    the same generator, and leaves the generator in the same state."""
    np.testing.assert_array_equal(synthetic.PALETTE, jax_synthetic.PALETTE)
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(2):
        img, label = synthetic.render_scene(a, res, n_classes)
        jimg, jlabel = jax_synthetic.render_scene(b, res, n_classes)
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(label, jlabel)
        assert img.dtype == jimg.dtype and label.dtype == jlabel.dtype
    assert a.integers(1 << 30) == b.integers(1 << 30)
