"""stego_torch.serve: the serving artifact (a batch-polymorphic torch.export
program whose trunk reaches kernels A and L through the registered ops
stego_torch::attention and stego_torch::layer_norm) against the JAX
package's ``_serve_fn`` on the same weights, one artifact against the eager
serving module at several batches, artifacts over n devices (on the CPU n
times over) against the one-device artifact shard by shard and against the
JAX package's SPMD artifact, the ops under ``torch.library.opcheck``, and
the packaging CLI's checks. On the CPU the ops run their plain
versions and the JAX package's Pallas kernels run in interpret mode."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.models.vit import ViTConfig as JaxViTConfig
from stego_tpu.serve import _serve_fn
from stego_tpu.train.segmenter import \
    UnsupervisedSegmenter as JaxUnsupervisedSegmenter
from stego_torch import serve
from stego_torch.models.convert import save_stego_checkpoint, to_jax_params
from stego_torch.models.vit import ViTConfig
from stego_torch.ops.flash_attention import attention_op, attention_plain
from stego_torch.ops.layer_norm import layer_norm_op
from stego_torch.train.segmenter import UnsupervisedSegmenter

from tests.test_torch_config import torch_config
from tests.test_torch_convert import make_cfg
from tests.test_torch_vit import SMALL, TINY
from tests._torch_cpu import one_intra_op_thread  # noqa: F401

OPS = ("stego_torch.attention.default", "stego_torch.layer_norm.default")


def images(seed, b, res):
    """Raw [0, 1] RGB images, the artifact's input."""
    return np.random.default_rng(seed).random((b, res, res, 3)) \
        .astype(np.float32)


def models(tiny, seed, **cfg_kw):
    """(JAX segmenter, backbone, params, the port's segmenter in eval mode)
    on the same seeded weights, LayerNorm scales and biases jittered off
    their ones and zeros; ``tiny``: ViT-T's geometry (3 heads, head-major),
    else 128 wide with 2 heads (token-major), both at depth 2."""
    cfg = make_cfg(**cfg_kw)
    geometry = TINY if tiny else SMALL
    g = torch.Generator().manual_seed(seed)
    seg = UnsupervisedSegmenter(5, torch_config(cfg),
                                vit_cfg=ViTConfig(**geometry), generator=g)
    with torch.no_grad():
        for name, p in seg.net.model.named_parameters():
            if "norm" in name:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    bb, params = to_jax_params(seg)
    jseg = JaxUnsupervisedSegmenter(5, cfg, vit_cfg=JaxViTConfig(**geometry))
    seg.eval()
    if seg.net.backbone_dtype == torch.bfloat16:
        seg.net.model.cast_blocks(torch.bfloat16)  # as load_model_for_eval
    return jseg, bb, params, seg


def jax_serve(jseg, bb, params, img01):
    sp = {k: params[k] for k in ("head", "linear_probe", "cluster_probe")}
    out = jax.jit(_serve_fn(jseg))(bb, sp, jnp.asarray(img01))
    return {k: np.asarray(v) for k, v in out.items()}


def eager(seg, img01):
    with torch.no_grad():
        out = serve.ServeFn(seg)(torch.from_numpy(img01))
    return {k: v.numpy() for k, v in out.items()}


def margin(log_probs):
    """Top-1 minus top-2 of the log-probs (the scores' own margin for the
    linear probe, alpha = 2 times the cosine margin for the cluster
    probe)."""
    top = np.sort(log_probs, axis=-1)
    return top[..., -1] - top[..., -2]


def op_counts(model):
    targets = [str(n.target) for n in model.module.graph.nodes
               if n.op == "call_function"]
    return {op: targets.count(op) for op in OPS}


# The artifacts (five exports in all), made once for the tests that read
# them: (segmenter, JAX parts, artifact directory, loaded ServingModel).
@functools.lru_cache(maxsize=None)
def artifact(name, tmp):
    res = 48
    if name == "f32_ckpt":  # f32, token-major, through package() and .ckpt
        jseg, bb, params, seg = models(False, 0)
        res = 32
        path = os.path.join(tmp, "f32.ckpt")
        save_stego_checkpoint(path, seg)
        out = serve.package(path, os.path.join(tmp, name), res=res,
                            batch_size=2, device="cpu")
    else:
        jseg, bb, params, seg = {
            "bf16": lambda: models(False, 1, backbone_dtype="bfloat16"),
            "bf16_plain": lambda: models(False, 1, backbone_dtype="bfloat16"),
            "bf16_tiny": lambda: models(True, 2, backbone_dtype="bfloat16"),
            "f32_tiny_flash": lambda: models(True, 3,
                                             use_flash_attention=True),
        }[name]()
        if name == "f32_tiny_flash":
            res = 32
        seg.net.model.use_kernels = name != "bf16_plain"
        out = serve.package_from_parts(seg, os.path.join(tmp, name), res,
                                       batch_size=4)
    return seg, (jseg, bb, params), res, serve.ServingModel.load(
        out, devices=["cpu"])


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("artifacts"))


def test_package_load_predict_keys_shapes_and_batches(tmp):
    """package() of a .ckpt on the CPU; the JAX predict's keys, shapes and
    dtypes; one artifact at batches 1, 3 and 5, each equal bit for bit to
    the eager serving module at that batch."""
    seg, _, res, model = artifact("f32_ckpt", tmp)
    with open(os.path.join(tmp, "f32_ckpt", "meta.json")) as f:
        meta = json.load(f)
    assert meta == model.meta
    assert {k: meta[k] for k in ("res", "batch_size", "in_chans", "n_devices",
                                 "n_classes", "batch_polymorphic")} == {
        "res": res, "batch_size": 2, "in_chans": 3, "n_devices": 1,
        "n_classes": 5, "batch_polymorphic": True}
    assert sorted(os.listdir(os.path.join(tmp, "f32_ckpt"))) == [
        "meta.json", "model.pt2"]
    img = images(5, 5, res)
    for b in (1, 3, 5):
        got = model.predict(img[:b])
        want = eager(seg, img[:b])
        assert list(got) == list(serve.OUTPUT_KEYS)
        for k in ("linear_probs", "cluster_probs"):
            assert got[k].shape == (b, res, res, 5)
            assert got[k].dtype == np.float32
        for k in ("linear_preds", "cluster_preds"):
            assert got[k].shape == (b, res, res)
            assert got[k].dtype == np.int32
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_f32_artifact_matches_jax_serve_fn(tmp):
    """f32: log-probs atol 1e-4; predictions equal where the top-two margin
    exceeds 1e-3 (the tolerances of tests/test_torch_eval.py)."""
    _, (jseg, bb, params), res, model = artifact("f32_ckpt", tmp)
    img = images(6, 2, res)
    got, want = model.predict(img), jax_serve(jseg, bb, params, img)
    assert got.keys() == want.keys()
    for probe in ("linear", "cluster"):
        lp = got[f"{probe}_probs"]
        np.testing.assert_allclose(lp, want[f"{probe}_probs"], atol=1e-4,
                                   rtol=0)
        assert want[f"{probe}_preds"].dtype == got[f"{probe}_preds"].dtype
        sure = margin(lp) > 1e-3
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(got[f"{probe}_preds"][sure],
                                      want[f"{probe}_preds"][sure])


@pytest.mark.parametrize("name", ["bf16", "bf16_tiny", "f32_tiny_flash"])
def test_kernel_trunk_artifact_matches_jax_serve_fn(tmp, name):
    """The trunks whose attention (and, bf16, LayerNorm) the JAX package
    runs through its Pallas kernels: the exported graph calls the ops twice
    a block per trunk call (LayerNorm also once for the final norm; none in
    an f32 trunk), and the outputs agree with JAX's _serve_fn. bf16: at
    least 99% of the predictions agree where the margin exceeds 5e-2; f32
    (A-f32's head-major path): as the f32 test above."""
    seg, (jseg, bb, params), res, model = artifact(name, tmp)
    depth = seg.vit_cfg.depth
    ln = 0 if name.startswith("f32") else 2 * (2 * depth + 1)
    assert op_counts(model) == dict(zip(OPS, (2 * depth, ln)))
    img = images(7, 3, res)
    got, want = model.predict(img), jax_serve(jseg, bb, params, img)
    for k, v in eager(seg, img).items():
        np.testing.assert_array_equal(got[k], v)
    for probe in ("linear", "cluster"):
        lp = got[f"{probe}_probs"]
        g, w = got[f"{probe}_preds"], want[f"{probe}_preds"]
        if name.startswith("f32"):
            np.testing.assert_allclose(lp, want[f"{probe}_probs"], atol=1e-4,
                                       rtol=0)
            sure = margin(lp) > 1e-3
            assert sure.mean() > 0.9
            np.testing.assert_array_equal(g[sure], w[sure])
        else:
            sure = margin(lp) > 5e-2
            assert sure.mean() > 0.5
            agree = (g == w)[sure].mean()
            assert agree >= 0.99, (probe, agree)


def test_plain_export_has_no_ops_and_same_outputs(tmp):
    """use_kernels=False exports the plain versions as aten ops: no custom
    op in the graph, and the same outputs bit for bit as the artifact
    whose ops run those plain versions on the CPU."""
    _, _, res, plain = artifact("bf16_plain", tmp)
    _, _, _, ops = artifact("bf16", tmp)
    assert op_counts(plain) == dict.fromkeys(OPS, 0)
    img = images(8, 2, res)
    got, want = plain.predict(img), ops.predict(img)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_move_to_device_rewrites_traced_devices(tmp):
    """The devices traced into the graph (the dtype casts' metadata checks)
    follow the move pass, with the weights; the input check refuses an
    image of another size; a load that asks for the card (the default)
    fails where there is none, and does not fall back to the CPU."""
    from torch.export.passes import move_to_device_pass

    def devices(module):
        return {str(n.kwargs["device"]) for n in module.graph.nodes
                if "device" in n.kwargs}

    _, _, res, model = artifact("f32_ckpt", tmp)
    assert devices(model.module) == {"cpu"}
    program = torch.export.load(os.path.join(tmp, "f32_ckpt", "model.pt2"))
    moved = move_to_device_pass(program, "meta")
    assert devices(moved.module()) == {"meta"}
    assert {t.device.type for t in moved.state_dict.values()} == {"meta"}
    with pytest.raises(Exception):
        model.predict(images(9, 1, res + 8))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            serve.ServingModel.load(os.path.join(tmp, "f32_ckpt"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [2, 3])
@pytest.mark.parametrize("layout", ["qkv columns", "contiguous"])
def test_attention_op_opcheck(dtype, heads, layout):
    """stego_torch::attention under opcheck (schema, fake tensor, autograd
    registration, AOT dispatch) with q, k, v the column blocks of one qkv
    (the trunk's strided views) or contiguous; 2 heads take the token-major
    entries, 3 the head-major ones."""
    g = torch.Generator().manual_seed(heads)
    d = 64 * heads
    qkv = torch.randn(2, 17, 3 * d, generator=g).to(dtype)
    q, k, v = qkv.split(d, dim=-1)
    if layout == "contiguous":
        q, k, v = (x.contiguous() for x in (q, k, v))
    torch.library.opcheck(attention_op, (q, k, v, heads, 0.125))
    np.testing.assert_array_equal(
        attention_op(q, k, v, heads, 0.125).float().numpy(),
        attention_plain(q, k, v, heads, 0.125).float().numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["rows", "strided"])
def test_layer_norm_op_opcheck(dtype, layout):
    """stego_torch::layer_norm under opcheck, on contiguous rows and on a
    strided view (a column block, as of a wider tensor)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 17, 384 * (2 if layout == "strided" else 1),
                    generator=g).to(dtype)
    if layout == "strided":
        x = x[..., :384]
    w, b = torch.randn(384, generator=g), torch.randn(384, generator=g)
    torch.library.opcheck(layer_norm_op, (x, w, b, 1e-6))


@functools.lru_cache(maxsize=None)
def n_device_artifact(n, tmp):
    """The f32_ckpt artifact's segmenter packaged with ``n_devices=n``,
    loaded on the CPU ``n`` times over."""
    seg = artifact("f32_ckpt", tmp)[0]
    out = serve.package_from_parts(seg, os.path.join(tmp, f"n{n}"), 32,
                                   batch_size=4, n_devices=n)
    return serve.ServingModel.load(out, devices=["cpu"] * n)


@pytest.mark.parametrize("n", [2, 4])
def test_n_device_artifact_serves_shards_bit_for_bit(tmp, n):
    """An n_devices=n artifact on ["cpu"] * n: each contiguous shard's
    outputs equal the one-device artifact's on that shard bit for bit, at
    one and at two images a shard; against the one-device artifact on the
    whole batch, the argmaxes are equal and the log-probs within the f32
    serving gate (atol 1e-4); a batch that is no positive multiple of n
    raises."""
    one = artifact("f32_ckpt", tmp)[3]
    model = n_device_artifact(n, tmp)
    assert model.meta["n_devices"] == n and model.meta["batch_size"] == 4
    assert model.devices == [torch.device("cpu")] * n
    img = images(10 + n, 2 * n, 32)
    for per in (1, 2):
        batch = img[:per * n]
        got = model.predict(batch)
        for s in range(n):
            want = one.predict(batch[s * per:(s + 1) * per])
            for k in serve.OUTPUT_KEYS:
                np.testing.assert_array_equal(
                    got[k][s * per:(s + 1) * per], want[k], err_msg=(s, k))
        whole = one.predict(batch)
        for probe in ("linear", "cluster"):
            np.testing.assert_array_equal(got[f"{probe}_preds"],
                                          whole[f"{probe}_preds"])
            np.testing.assert_allclose(got[f"{probe}_probs"],
                                       whole[f"{probe}_probs"], atol=1e-4,
                                       rtol=0)
    for b in (0, n - 1, n + 1):
        with pytest.raises(ValueError, match=f"divisible by {n}"):
            model.predict(img[:b])


def test_n_devices_must_divide_batch_and_default_load_needs_the_cards(
        tmp, tmp_path, monkeypatch):
    """n_devices must divide batch_size (nothing is written otherwise); a
    default-devices load of an n_devices=2 artifact raises with both counts
    where fewer CUDA devices are visible, and an explicit devices list must
    hold one device a shard: no load serves on fewer devices than the
    artifact's."""
    seg = artifact("f32_ckpt", tmp)[0]
    with pytest.raises(ValueError, match="must divide"):
        serve.package_from_parts(seg, str(tmp_path / "a"), 32, 3,
                                 n_devices=2)
    assert not os.listdir(tmp_path)
    path = os.path.join(tmp, "n2")
    n_device_artifact(2, tmp)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, have 1"):
        serve.ServingModel.load(path)
    for devices in (["cpu"], ["cpu"] * 3):
        with pytest.raises(ValueError, match="takes 2 devices"):
            serve.ServingModel.load(path, devices=devices)


def test_n_device_artifact_matches_jax_spmd_artifact(tmp_path):
    """The port's n_devices=2 artifact on ["cpu", "cpu"] against the JAX
    package's SPMD artifact of tests/test_serve.py (its tiny f32 ViT on a
    2-device mesh) on the same weights and batch of 4: log-probs within the
    f32 serving gate, predictions equal where the margin exceeds 1e-3."""
    from stego_tpu.serve import ServingModel as JaxServingModel
    from stego_tpu.serve import package_from_parts as jax_package
    from stego_torch.models.convert import from_jax_params
    from tests.test_serve import TINY as JAX_TINY
    from tests.test_serve import _parts

    jseg, bb, params = _parts()
    jdir = jax_package(jseg, bb, params, str(tmp_path / "jax"), res=16,
                       batch_size=4, n_devices=2)
    seg = from_jax_params(bb, params, torch_config(jseg.cfg),
                          vit_cfg=ViTConfig(**dataclasses.asdict(JAX_TINY)))
    seg.eval()
    out = serve.package_from_parts(seg, str(tmp_path / "port"), 16,
                                   batch_size=4, n_devices=2)
    img = images(11, 4, 16)
    want = JaxServingModel.load(jdir).predict(img)
    got = serve.ServingModel.load(out, devices=["cpu", "cpu"]).predict(img)
    for probe in ("linear", "cluster"):
        lp = got[f"{probe}_probs"]
        np.testing.assert_allclose(lp, want[f"{probe}_probs"], atol=1e-4,
                                   rtol=0)
        sure = margin(lp) > 1e-3
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(got[f"{probe}_preds"][sure],
                                      np.asarray(want[f"{probe}_preds"])[sure])


def test_main_rejects_unknown_args_and_needs_cuda(tmp_path):
    """Unknown args fail before anything is read or traced; without a CUDA
    device main exits with an error and packages nothing."""
    out = tmp_path / "art"
    args = [f"model_path={tmp_path / 'missing.ckpt'}", f"output_dir={out}"]
    with pytest.raises(ValueError, match="Unknown args: \\['bogus'\\]"):
        serve.main(args + ["bogus=1"])
    with pytest.raises(SystemExit, match="model_path"):
        serve.main(["res=32"])
    with pytest.raises(SystemExit, match="CUDA"):
        serve.main(args + ["res=32", "batch_size=2"])
    assert not out.exists()
