"""The port's frozen trunks against the JAX package's on the same seeded
torchvision-layout weights (``tests/test_fpn.py``'s and
``tests/test_zoo.py``'s synthetic state dicts): ResNet-50's taps and
DenseNet-121's pooled features within rtol 5e-3, atol 5e-4 (the JAX
package's own gate against torch, ``tests/test_fpn.py:103-106``,
``tests/test_zoo.py:137``), VGG-11's within rtol 1e-4, atol 1e-5
(``tests/test_zoo.py:61``), the PiCIE decoder's features, the checkpoint
loaders' key surgery, and the JAX parameters carried across by
``models/convert.py``. One JAX forward a trunk (module-scoped)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stego_tpu.models import picie as jax_picie
from stego_tpu.models import resnet as jax_resnet
from stego_tpu.models import zoo as jax_zoo
from stego_torch.models import convert, resnet, zoo
from stego_torch.models.picie import (PiCIE, picie_from_checkpoint,
                                      picie_state_dict)

from tests.test_fpn import make_torch_resnet50_sd
from tests.test_zoo import make_densenet_sd, make_vgg11_sd
from tests._torch_cpu import one_intra_op_thread  # noqa: F401

TRUNK_TOL = dict(rtol=5e-3, atol=5e-4)
VGG_TOL = dict(rtol=1e-4, atol=1e-5)


def image(seed, b=2, res=64):
    return np.random.default_rng(seed).standard_normal(
        (b, res, res, 3)).astype(np.float32)


def assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def resnet_case():
    """A torchvision-layout state dict, its JAX parameters and the JAX
    taps of a seeded image batch."""
    sd = make_torch_resnet50_sd(seed=3)
    params = jax_resnet.resnet50_params_from_torch(sd)
    img = image(0)
    taps = jax.tree.map(np.asarray,
                        jax_resnet.resnet50_features(params,
                                                     jnp.asarray(img)))
    return sd, params, img, taps


def test_resnet50_taps_match_jax(resnet_case):
    """Every tap of the port's ResNet-50, loaded from the torchvision state
    dict, against the JAX package's on the same image; the folded weights
    equal the JAX parameters carried across bit for bit."""
    sd, params, img, want = resnet_case
    folded = resnet.resnet50_state_dict_from_torchvision(sd)
    assert_sd_equal(folded, convert.resnet_state_dict(params))
    net = resnet.ResNet50()
    net.load_state_dict(folded)
    got = net(torch.from_numpy(img))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **TRUNK_TOL,
                                   err_msg=k)
    back = convert.resnet_params(net.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, params))


def test_resnet50_bf16_taps_follow_f32(resnet_case):
    """A bf16 trunk's taps (weights stored bf16, as the app stores them)
    stay within bf16's reach of the f32 trunk's, and come back f32."""
    sd, _, img, _ = resnet_case
    net = resnet.ResNet50()
    net.load_state_dict(resnet.resnet50_state_dict_from_torchvision(sd))
    want = net(torch.from_numpy(img), taps=("layer4",))["layer4"]
    net.cast_blocks(torch.bfloat16)
    got = net(torch.from_numpy(img), torch.bfloat16,
              taps=("layer4",))["layer4"]
    assert got.dtype == torch.float32
    rel = float((got - want).norm() / want.norm())
    assert rel < 0.05, rel


@pytest.mark.parametrize("model_type", ["resnet50", "mocov2",
                                        "robust_resnet50", "densecl"])
def test_load_resnet_backbone_variants(tmp_path, model_type):
    """Each checkpoint family's key surgery gives the JAX loader's weights,
    bit for bit (``resnet.py:182``)."""
    sd = make_torch_resnet50_sd(seed=1)
    if model_type == "mocov2":
        ckpt = {"state_dict": {**{f"module.encoder_q.{k}": v
                                  for k, v in sd.items()},
                               "module.encoder_q.fc.0.weight":
                                   torch.zeros(3, 2048),
                               "module.encoder_k.conv1.weight":
                                   torch.zeros(1)}}
    elif model_type == "robust_resnet50":
        ckpt = {"model": {**{f"module.model.{k}": v for k, v in sd.items()},
                          "module.normalizer.new_mean": torch.zeros(3)}}
    elif model_type == "densecl":
        ckpt = {"state_dict": sd}
    else:
        ckpt = sd
    path = str(tmp_path / "w.pth")
    torch.save(ckpt, path)
    got = resnet.load_resnet_backbone(model_type, path)
    assert_sd_equal(got, convert.resnet_state_dict(
        jax_resnet.load_resnet_backbone(model_type, path)))
    with pytest.raises(ValueError, match="No model"):
        resnet.load_resnet_backbone("resnet18", path)


def test_vgg11_matches_jax():
    sd = make_vgg11_sd()
    params = jax_zoo.vgg11_params_from_torch(sd)
    img = image(1, b=2, res=64)
    want = np.asarray(jax_zoo.vgg11_features(params, jnp.asarray(img)))
    loaded = zoo.vgg11_state_dict_from_torchvision(sd)
    assert_sd_equal(loaded, convert.vgg11_state_dict(params))
    net = zoo.VGG11()
    net.load_state_dict(loaded)
    got = net(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, **VGG_TOL)


def test_densenet121_matches_jax():
    sd = make_densenet_sd()
    params = jax_zoo.densenet121_params_from_torch(sd)
    img = image(2, b=2, res=64)
    want = np.asarray(jax_zoo.densenet121_features(params, jnp.asarray(img)))
    loaded = zoo.densenet121_state_dict_from_torchvision(sd)
    assert_sd_equal(loaded, convert.densenet121_state_dict(params))
    net = zoo.DenseNet121()
    net.load_state_dict(loaded)
    got = net(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(got, want, **TRUNK_TOL)


@pytest.mark.parametrize("model_type,dim", [("vgg11", 512),
                                            ("densenet121", 1024),
                                            ("resnet50", 2048),
                                            ("mocov2", 2048)])
def test_cut_backbone_embedder(model_type, dim):
    """The embedder's seeded init gives (B, 1, 1, D) f32, the same twice
    from one seed; an unknown model raises."""
    img = torch.from_numpy(image(3, b=1, res=32))
    out = [zoo.CutBackboneEmbedder(
        model_type, generator=torch.Generator().manual_seed(0))
        .backbone_features(img) for _ in range(2)]
    assert out[0].shape == (1, 1, 1, dim) and out[0].dtype == torch.float32
    assert torch.equal(out[0], out[1])
    with pytest.raises(ValueError, match="No model"):
        zoo.CutBackboneEmbedder("alexnet")


def picie_sd(seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {"backbone." + k: v for k, v in make_torch_resnet50_sd(seed).items()}
    for name, cin in jax_picie.DECODER_IN.items():
        sd[f"decoder.{name}.weight"] = torch.randn(256, cin, 1, 1,
                                                   generator=g) * 0.05
        sd[f"decoder.{name}.bias"] = torch.randn(256, generator=g) * 0.05
    return sd


def test_picie_features_and_checkpoint_match_jax(tmp_path):
    """PiCIE's decoder features against the JAX package's on the same state
    dict; the released file's layout (pickled modules, a cluster probe)
    read by both loaders gives the same weights and predictions; the JAX
    decoder carried across equals the file's."""
    sd = picie_sd()
    params = jax_picie.picie_params_from_state_dict(sd)
    img = image(4, b=2, res=64)
    want = np.asarray(jax_picie.picie_features(
        params["backbone"], params["decoder"], jnp.asarray(img)))
    net = PiCIE()
    missing, unexpected = net.load_state_dict(picie_state_dict(sd),
                                              strict=False)
    assert missing == ["clusters"] and not unexpected
    got = net.features(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 16, 16, 256)
    np.testing.assert_allclose(got, want, **TRUNK_TOL)
    dec = convert.picie_decoder_state_dict(params["decoder"])
    for k, v in dec.items():
        assert torch.equal(v, net.state_dict()[k]), k

    clusters = torch.randn(5, 256, generator=torch.Generator().manual_seed(9))
    probe = torch.nn.Module()
    probe.clusters = torch.nn.Parameter(clusters)
    path = str(tmp_path / "picie_and_probes.pth")
    torch.save({"model": sd, "cluster_probe": probe}, path)
    loaded, stats = picie_from_checkpoint(path)
    assert stats is None
    assert torch.equal(loaded.clusters, clusters)
    jstate = jax_picie.load_picie_checkpoint(path)
    np.testing.assert_array_equal(jstate["cluster_probe"]["clusters"],
                                  clusters.numpy())
    from stego_tpu.models.probes import cluster_lookup as jax_cluster_lookup

    _, probs = jax_cluster_lookup(jstate["cluster_probe"], jnp.asarray(want),
                                  alpha=None)
    jpred = np.asarray(jnp.argmax(probs, axis=-1))
    pred = loaded.predict(torch.from_numpy(img)).numpy()
    assert (pred == jpred).mean() > 0.99
