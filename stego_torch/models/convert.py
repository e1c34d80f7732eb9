"""Weights carried across: JAX parameter pytrees, JAX train states and
STEGO Lightning ``.ckpt`` files <-> the port's modules.

The port's modules use the reference's names, so its ``state_dict()`` is the
Lightning checkpoint's: ``net.model.*`` (the DINO ViT), ``net.cluster1.0.*``,
``net.cluster2.{0,2}.*``, ``linear_probe.*``, ``cluster_probe.clusters``,
``train_cluster_probe.clusters``, ``decoder.*``. The JAX package stacks the
ViT blocks on a leading axis and stores dense kernels as (in, out); the
mapping below is the one ``stego_tpu/models/export.py`` (:23-117) and
``convert.py`` (:47-242) use.

A JAX train state (``segmenter.py:init_state``) is params, three optax Adam
states (``count``, ``mu``, ``nu`` each) and ``step``;
:func:`load_jax_train_state` puts it into the port's modules and
``torch.optim.Adam`` states, :func:`jax_train_state` takes it back out.

The feature-pyramid arch (``models/fpn.py``) maps the same way: its
ResNet-50 under ``net.model.*`` (:func:`resnet_state_dict`, folded
BatchNorms as ``.w``/``.b``), its head's convolutions (HWIO <-> OIHW) and
BatchNorms, whose running statistics are the JAX head's ``ema_mean`` /
``ema_var`` leaves (zero-gradient leaves with zero Adam moments there,
buffers here). :func:`vgg11_state_dict`, :func:`densenet121_state_dict`
and :func:`picie_decoder_state_dict` carry the zoo's and PiCIE's JAX
parameters across.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from stego_torch.config import Config
from stego_torch.models.vit import ViTConfig
from stego_torch.models.zoo import VGG11_CONV_INDEX
from stego_torch.train.segmenter import UnsupervisedSegmenter

# torch name inside blocks.{i}. -> (JAX group, JAX leaf, dense kernel?)
_BLOCK_KEYS = (
    ("norm1.weight", "norm1", "scale", False),
    ("norm1.bias", "norm1", "bias", False),
    ("attn.qkv.weight", "attn", "qkv_kernel", True),
    ("attn.qkv.bias", "attn", "qkv_bias", False),
    ("attn.proj.weight", "attn", "proj_kernel", True),
    ("attn.proj.bias", "attn", "proj_bias", False),
    ("norm2.weight", "norm2", "scale", False),
    ("norm2.bias", "norm2", "bias", False),
    ("mlp.fc1.weight", "mlp", "fc1_kernel", True),
    ("mlp.fc1.bias", "mlp", "fc1_bias", False),
    ("mlp.fc2.weight", "mlp", "fc2_kernel", True),
    ("mlp.fc2.bias", "mlp", "fc2_bias", False),
)
# 1x1 convs of the head and probes: torch prefix -> (JAX path, kernel, bias)
_CONV_KEYS = (
    ("net.cluster1.0", ("head", "cluster1"), "kernel", "bias"),
    ("net.cluster2.0", ("head", "cluster2"), "fc1_kernel", "fc1_bias"),
    ("net.cluster2.2", ("head", "cluster2"), "fc2_kernel", "fc2_bias"),
    ("linear_probe", ("linear_probe",), "kernel", "bias"),
    ("decoder", ("decoder",), "kernel", "bias"),
)
# cluster centres: torch name -> JAX path (same layout on both sides)
_CLUSTER_KEYS = (
    ("cluster_probe.clusters", ("cluster_probe", "clusters")),
    ("train_cluster_probe.clusters", ("train_cluster_probe", "clusters")),
)
# the params root each optimizer's moments start from ("net" holds the
# head and the decoder under their own keys, the probes' are the subtree)
_OPT_ROOTS = {"net": None, "linear": "linear_probe", "cluster": "cluster_probe"}


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def vit_state_dict(backbone: Mapping[str, Any],
                   prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ViT pytree (stacked blocks) -> DINO-style state dict."""
    p = prefix
    sd = {
        p + "patch_embed.proj.weight":
            _t(np.asarray(backbone["patch_embed"]["kernel"])
               .transpose(3, 2, 0, 1)),  # HWIO -> OIHW
        p + "patch_embed.proj.bias": _t(backbone["patch_embed"]["bias"]),
        p + "cls_token": _t(backbone["cls_token"]),
        p + "pos_embed": _t(backbone["pos_embed"]),
        p + "norm.weight": _t(backbone["norm"]["scale"]),
        p + "norm.bias": _t(backbone["norm"]["bias"]),
    }
    blocks = backbone["blocks"]
    for i in range(np.asarray(blocks["norm1"]["scale"]).shape[0]):
        for name, grp, leaf, dense in _BLOCK_KEYS:
            a = np.asarray(blocks[grp][leaf][i])
            sd[f"{p}blocks.{i}.{name}"] = _t(a.T if dense else a)
    return sd


def vit_params_from_state_dict(sd: Mapping[str, torch.Tensor],
                               prefix: str = "") -> Dict[str, Any]:
    """DINO-style state dict -> JAX ViT pytree of numpy arrays."""
    p = prefix
    depth = 1 + max(int(k[len(p):].split(".")[1]) for k in sd
                    if k.startswith(p + "blocks."))
    blocks: Dict[str, Dict[str, np.ndarray]] = {}
    for name, grp, leaf, dense in _BLOCK_KEYS:
        arrs = [_np(sd[f"{p}blocks.{i}.{name}"]) for i in range(depth)]
        blocks.setdefault(grp, {})[leaf] = np.stack(
            [a.T for a in arrs] if dense else arrs)
    return {
        "patch_embed": {
            "kernel": _np(sd[p + "patch_embed.proj.weight"])
            .transpose(2, 3, 1, 0),  # OIHW -> HWIO
            "bias": _np(sd[p + "patch_embed.proj.bias"]),
        },
        "cls_token": _np(sd[p + "cls_token"]),
        "pos_embed": _np(sd[p + "pos_embed"]),
        "blocks": blocks,
        "norm": {"scale": _np(sd[p + "norm.weight"]),
                 "bias": _np(sd[p + "norm.bias"])},
    }


def stego_state_dict(backbone: Mapping[str, Any],
                     params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX (backbone, params) pytrees -> Lightning-layout state dict of the
    modules the port has (net, linear_probe, cluster_probe); a ResNet-50
    backbone (the FPN arch's, which has no ``patch_embed``) with its
    head."""
    if "patch_embed" not in backbone:
        sd = resnet_state_dict(backbone, prefix="net.model.")
        sd.update(fpn_head_state_dict(params["head"], prefix="net."))
        for prefix, path, kernel, bias in _CONV_KEYS:
            if path[0] == "head" or path[0] not in params:
                continue
            node = params[path[0]]
            sd[prefix + ".weight"] = _t(np.asarray(node[kernel])
                                        .T[:, :, None, None])
            sd[prefix + ".bias"] = _t(node[bias])
        for name, (root, leaf) in _CLUSTER_KEYS:
            if root in params:
                sd[name] = _t(params[root][leaf])
        return sd
    sd = vit_state_dict(backbone, prefix="net.model.")
    for prefix, path, kernel, bias in _CONV_KEYS:
        node = params
        for key in path:
            node = node.get(key) if node is not None else None
        if node is None:
            continue
        sd[prefix + ".weight"] = _t(np.asarray(node[kernel]).T[:, :, None,
                                                                None])
        sd[prefix + ".bias"] = _t(node[bias])
    for name, (root, leaf) in _CLUSTER_KEYS:
        if root in params:
            sd[name] = _t(params[root][leaf])
    return sd


def _hwio(a) -> torch.Tensor:
    return _t(np.asarray(a).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _oihw(t: torch.Tensor) -> np.ndarray:
    return _np(t).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def resnet_state_dict(params: Mapping[str, Any],
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ResNet-50 pytree (``stego_tpu/models/resnet.py``, folded) ->
    ``models/resnet.py:ResNet50``'s state dict."""
    sd = {prefix + "conv1.weight": _hwio(params["conv1"]["kernel"]),
          prefix + "bn1.w": _t(params["bn1"]["w"]),
          prefix + "bn1.b": _t(params["bn1"]["b"])}
    for stage in range(1, 5):
        for i, blk in enumerate(params[f"layer{stage}"]):
            pre = f"{prefix}layer{stage}.{i}."
            parts = [(f"conv{j}", blk[f"conv{j}"], f"bn{j}", blk[f"bn{j}"])
                     for j in (1, 2, 3)]
            if "downsample" in blk:
                parts.append(("downsample.0", blk["downsample"]["conv"],
                              "downsample.1", blk["downsample"]["bn"]))
            for conv_name, c, bn_name, bn in parts:
                sd[pre + conv_name + ".weight"] = _hwio(c["kernel"])
                sd[pre + bn_name + ".w"] = _t(bn["w"])
                sd[pre + bn_name + ".b"] = _t(bn["b"])
    return sd


def resnet_params(sd: Mapping[str, torch.Tensor],
                  prefix: str = "") -> Dict[str, Any]:
    """Inverse of :func:`resnet_state_dict`: the JAX pytree, numpy."""
    def bn(name):
        return {"w": _np(sd[prefix + name + ".w"]),
                "b": _np(sd[prefix + name + ".b"])}

    params: Dict[str, Any] = {
        "conv1": {"kernel": _oihw(sd[prefix + "conv1.weight"])},
        "bn1": bn("bn1")}
    for stage in range(1, 5):
        blocks, i = [], 0
        while f"{prefix}layer{stage}.{i}.conv1.weight" in sd:
            pre = f"layer{stage}.{i}."
            blk = {}
            for j in (1, 2, 3):
                blk[f"conv{j}"] = {
                    "kernel": _oihw(sd[f"{prefix}{pre}conv{j}.weight"])}
                blk[f"bn{j}"] = bn(f"{pre}bn{j}")
            if f"{prefix}{pre}downsample.0.weight" in sd:
                blk["downsample"] = {
                    "conv": {"kernel": _oihw(
                        sd[f"{prefix}{pre}downsample.0.weight"])},
                    "bn": bn(f"{pre}downsample.1")}
            blocks.append(blk)
            i += 1
        params[f"layer{stage}"] = blocks
    return params


def vgg11_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX VGG-11 pytree (``zoo.py``) -> ``models/zoo.py:VGG11``'s."""
    sd = {}
    for i, c in zip(VGG11_CONV_INDEX, params["convs"]):
        sd[f"features.{i}.weight"] = _hwio(c["kernel"])
        sd[f"features.{i}.bias"] = _t(c["bias"])
    return sd


def densenet121_state_dict(params: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """JAX DenseNet-121 pytree (``zoo.py``, folded) ->
    ``models/zoo.py:DenseNet121``'s."""
    def bn(name, p):
        return {f"features.{name}.w": _t(p["w"]),
                f"features.{name}.b": _t(p["b"])}

    sd = {"features.conv0.weight": _hwio(params["conv0"]["kernel"]),
          **bn("norm0", params["norm0"]), **bn("norm5", params["norm5"])}
    for bi, layers in enumerate(params["blocks"], start=1):
        for li, layer in enumerate(layers, start=1):
            pre = f"denseblock{bi}.denselayer{li}."
            for j in (1, 2):
                sd[f"features.{pre}conv{j}.weight"] = _hwio(
                    layer[f"conv{j}"]["kernel"])
                sd.update(bn(f"{pre}norm{j}", layer[f"norm{j}"]))
    for bi, t in enumerate(params["transitions"], start=1):
        sd[f"features.transition{bi}.conv.weight"] = _hwio(
            t["conv"]["kernel"])
        sd.update(bn(f"transition{bi}.norm", t["norm"]))
    return sd


def picie_decoder_state_dict(decoder: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX PiCIE decoder (``picie.py``: (in, out) kernels) ->
    ``models/picie.py:PiCIE``'s ``decoder.*``."""
    return {f"decoder.{name}.{leaf}": (
        _t(np.asarray(p["kernel"]).T[:, :, None, None]) if leaf == "weight"
        else _t(p["bias"]))
        for name, p in decoder.items() for leaf in ("weight", "bias")}


# the FPN head, torch suffix inside net.conv{k}.double_conv. -> JAX leaf
# inside head.conv{k} (kind: "hwio" kernel, None plain)
_DOUBLE_CONV_KEYS = (
    ("0.weight", ("conv1", "kernel"), "hwio"),
    ("0.bias", ("conv1", "bias"), None),
    ("1.weight", ("norm1", "scale"), None),
    ("1.bias", ("norm1", "bias"), None),
    ("3.weight", ("conv2", "kernel"), "hwio"),
    ("3.bias", ("conv2", "bias"), None),
    ("4.weight", ("norm2", "scale"), None),
    ("4.bias", ("norm2", "bias"), None),
)
# the head's BatchNorm buffers -> the JAX norm's running-statistic leaves
_BN_BUFFERS = (("running_mean", "ema_mean"), ("running_var", "ema_var"))


def _fpn_head_keys(granularity: int):
    """(torch parameter name, JAX params path, kind) of an FPN head."""
    out = []
    for k in range(1, granularity + 1):
        out += [(f"net.cluster{k}.0.weight", ("head", f"cluster{k}",
                                              "kernel"), "hwio"),
                (f"net.cluster{k}.0.bias", ("head", f"cluster{k}", "bias"),
                 None)]
        if k > 1:
            out += [(f"net.conv{k}.double_conv.{suffix}",
                     ("head", f"conv{k}") + leaf, kind)
                    for suffix, leaf, kind in _DOUBLE_CONV_KEYS]
    return out


def _fpn_head_buffers(granularity: int):
    """(torch buffer name, JAX params path) of an FPN head's running
    statistics."""
    return [(f"net.conv{k}.double_conv.{i}.{buf}",
             ("head", f"conv{k}", f"norm{j}", leaf))
            for k in range(2, granularity + 1)
            for i, j in ((1, 1), (4, 2)) for buf, leaf in _BN_BUFFERS]


def fpn_head_state_dict(head: Mapping[str, Any],
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX FPN head (``fpn.py:init_head``, with its ``ema_*`` leaves) ->
    ``models/fpn.py:FeaturePyramidNet``'s head entries (parameters and
    BatchNorm running statistics), under ``prefix``."""
    granularity = max(int(k[len("cluster"):]) for k in head
                      if k.startswith("cluster"))
    params = {"head": head}
    sd = {}
    for name, path, kind in _fpn_head_keys(granularity):
        a = _get(params, path)
        sd[prefix + name[len("net."):]] = _hwio(a) if kind == "hwio" \
            else _t(a)
    for name, path in _fpn_head_buffers(granularity):
        sd[prefix + name[len("net."):]] = _t(_get(params, path))
    return sd


def _is_fpn(cfg: Config) -> bool:
    return cfg.arch == "feature-pyramid"


def infer_vit_cfg(sd: Mapping[str, torch.Tensor],
                  prefix: str = "") -> ViTConfig:
    """ViT geometry from a state dict: patch and width from the patch conv,
    depth from the block count, heads by the head_dim = 64 rule, trained
    image size from the pos-embed length (``convert.py:infer_vit_cfg``)."""
    w = sd[prefix + "patch_embed.proj.weight"]
    embed_dim, in_chans, patch, _ = w.shape
    depth = 1 + max(int(k[len(prefix):].split(".")[1]) for k in sd
                    if k.startswith(prefix + "blocks."))
    side = int(round((sd[prefix + "pos_embed"].shape[1] - 1) ** 0.5))
    return ViTConfig(patch_size=patch, embed_dim=embed_dim, depth=depth,
                     num_heads=max(1, embed_dim // 64), img_size=side * patch,
                     in_chans=in_chans)


def _segmenter_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: Config,
                               vit_cfg: Optional[ViTConfig]
                               ) -> UnsupervisedSegmenter:
    if vit_cfg is None and not _is_fpn(cfg):
        vit_cfg = infer_vit_cfg(sd, prefix="net.model.")
    n_classes = sd["linear_probe.weight"].shape[0]
    seg = UnsupervisedSegmenter(n_classes, cfg, vit_cfg=vit_cfg)
    missing, unexpected = seg.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise ValueError(f"state dict does not fit the segmenter: missing "
                         f"{missing}, unexpected {unexpected}")
    return seg


def from_jax_params(backbone: Mapping[str, Any], params: Mapping[str, Any],
                    cfg: Config, vit_cfg: Optional[ViTConfig] = None
                    ) -> UnsupervisedSegmenter:
    """The port's segmenter (f32, on the CPU) holding the weights of the
    JAX pytrees ``backbone`` and ``params`` (numpy or jax arrays). The class
    count comes from the linear probe, the ViT geometry from the weights
    unless ``vit_cfg`` is given."""
    return _segmenter_from_state_dict(stego_state_dict(backbone, params), cfg,
                                      vit_cfg)


def to_jax_params(seg: UnsupervisedSegmenter
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of :func:`from_jax_params`: (backbone, params) numpy pytrees
    in the JAX package's layout."""
    sd = seg.state_dict()
    params: Dict[str, Any] = {"head": {}}
    if _is_fpn(seg.cfg):
        for name, (path, kind) in _trainable(seg).items():
            _set(params, path, _to_jax(sd[name], kind))
        for name, path in _fpn_head_buffers(seg.net.granularity):
            _set(params, path, _np(sd[name]))
        return resnet_params(sd, prefix="net.model."), params
    for prefix, path, kernel, bias in _CONV_KEYS:
        if prefix + ".weight" not in sd:
            continue
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[kernel] = _np(sd[prefix + ".weight"])[:, :, 0, 0].T
        node[bias] = _np(sd[prefix + ".bias"])
    for name, (root, leaf) in _CLUSTER_KEYS:
        params[root] = {leaf: _np(sd[name])}
    return vit_params_from_state_dict(sd, prefix="net.model."), params


def _trainable(seg: UnsupervisedSegmenter
               ) -> Dict[str, Tuple[Tuple[str, ...], Optional[str]]]:
    """Every head and probe parameter: torch name -> (JAX params path,
    kind: "dense" a 1x1-conv kernel stored (in, out), "hwio" a conv kernel
    stored HWIO, None as it is)."""
    names = dict(seg.named_parameters())
    out: Dict[str, Tuple[Tuple[str, ...], Optional[str]]] = {}
    if _is_fpn(seg.cfg):
        for name, path, kind in _fpn_head_keys(seg.net.granularity):
            out[name] = (path, kind)
    for prefix, path, kernel, bias in _CONV_KEYS:
        if _is_fpn(seg.cfg) and path[0] == "head":
            continue
        if prefix + ".weight" in names:
            out[prefix + ".weight"] = (path + (kernel,), "dense")
            out[prefix + ".bias"] = (path + (bias,), None)
    for name, path in _CLUSTER_KEYS:
        out[name] = (path, None)
    return out


def _get(tree: Mapping[str, Any], path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _from_jax(a, kind: Optional[str], like: torch.Tensor) -> torch.Tensor:
    t = _hwio(a) if kind == "hwio" else _t(a)
    if kind == "dense":
        t = t.T[:, :, None, None]
    return t.to(like.device)


def _to_jax(t: torch.Tensor, kind: Optional[str]) -> np.ndarray:
    if kind == "hwio":
        return _oihw(t)
    a = _np(t)
    return a[:, :, 0, 0].T if kind == "dense" else a


def _opt_path(opt_name: str, path: Tuple[str, ...]) -> Tuple[str, ...]:
    """A parameter's path inside its optimizer's moment trees."""
    return path if _OPT_ROOTS[opt_name] is None else path[1:]


def load_jax_train_state(seg: UnsupervisedSegmenter,
                         state: Mapping[str, Any]) -> None:
    """Put a JAX train state (``segmenter.py:init_state`` layout, numpy or
    jax arrays) into ``seg``: its head and probe weights, the Adam moments
    and step counts of ``seg.optimizers()``, and ``seg.step``. The ViT
    weights are not part of a train state."""
    params = state["params"]
    trainable = _trainable(seg)
    named = dict(seg.named_parameters())
    with torch.no_grad():
        for name, (path, kind) in trainable.items():
            named[name].copy_(_from_jax(_get(params, path), kind,
                                        named[name]))
        if _is_fpn(seg.cfg):
            buffers = dict(seg.named_buffers())
            for name, path in _fpn_head_buffers(seg.net.granularity):
                buffers[name].copy_(_from_jax(_get(params, path), None,
                                              buffers[name]))
    ids = {id(p): n for n, p in named.items()}
    for opt_name, opt in seg.optimizers().items():
        adam = state["opt"][opt_name][0]
        count = float(np.asarray(adam.count))
        for group in opt.param_groups:
            for p in group["params"]:
                path, kind = trainable[ids[id(p)]]
                sub = _opt_path(opt_name, path)
                opt.state[p] = {
                    "step": torch.tensor(count),
                    "exp_avg": _from_jax(_get(adam.mu, sub), kind, p),
                    "exp_avg_sq": _from_jax(_get(adam.nu, sub), kind, p),
                }
    seg.step = int(np.asarray(state["step"]))


def jax_train_state(seg: UnsupervisedSegmenter,
                    like: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`load_jax_train_state`: ``seg``'s train state as
    numpy, in the structure of the JAX train state ``like`` (its optax
    state tuples are rebuilt with ``_replace``, so no optax is needed)."""
    trainable = _trainable(seg)
    named = dict(seg.named_parameters())
    params: Dict[str, Any] = {}
    for name, (path, kind) in trainable.items():
        _set(params, path, _to_jax(named[name], kind))
    # the FPN's running statistics: params leaves in JAX, with zero
    # gradients and so zero Adam moments in the net optimizer
    stats = (_fpn_head_buffers(seg.net.granularity) if _is_fpn(seg.cfg)
             else [])
    buffers = dict(seg.named_buffers())
    for name, path in stats:
        _set(params, path, _np(buffers[name]))
    ids = {id(p): n for n, p in named.items()}
    opt_states = {}
    for opt_name, opt in seg.optimizers().items():
        mu: Dict[str, Any] = {}
        nu: Dict[str, Any] = {}
        count = 0.0
        for group in opt.param_groups:
            for p in group["params"]:
                path, kind = trainable[ids[id(p)]]
                st = opt.state.get(p)
                zeros = torch.zeros_like(p)
                if st:
                    count = float(st["step"])
                _set(mu, _opt_path(opt_name, path),
                     _to_jax(st["exp_avg"] if st else zeros, kind))
                _set(nu, _opt_path(opt_name, path),
                     _to_jax(st["exp_avg_sq"] if st else zeros, kind))
        if opt_name == "net":
            for name, path in stats:
                _set(mu, path, np.zeros_like(_np(buffers[name])))
                _set(nu, path, np.zeros_like(_np(buffers[name])))
        like_opt = like["opt"][opt_name]
        adam = like_opt[0]
        count_dtype = np.asarray(adam.count).dtype
        opt_states[opt_name] = (adam._replace(
            count=np.asarray(count, dtype=count_dtype), mu=mu, nu=nu),
        ) + tuple(like_opt[1:])
    return {"params": params, "opt": opt_states,
            "step": np.asarray(seg.step,
                               dtype=np.asarray(like["step"]).dtype)}


def load_stego_checkpoint(path: str, vit_cfg: Optional[ViTConfig] = None
                          ) -> UnsupervisedSegmenter:
    """Read a Lightning ``.ckpt`` (the layout of
    ``stego_tpu/models/export.py:export_stego_checkpoint``) into an f32
    segmenter on the CPU, with the ``Config`` stored in
    ``hyper_parameters.cfg``. Loads tensors and plain containers only
    (``weights_only=True``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    hp = ckpt.get("hyper_parameters", {})
    cfg = Config.from_dict(dict(hp.get("cfg", hp)))
    return _segmenter_from_state_dict(ckpt["state_dict"], cfg, vit_cfg)


def save_stego_checkpoint(path: str, seg: UnsupervisedSegmenter,
                          step: int = 0,
                          backbone_sd: Optional[Mapping[str, torch.Tensor]]
                          = None) -> None:
    """Write ``seg`` as a Lightning ``.ckpt`` with f32 weights, readable by
    :func:`load_stego_checkpoint` and by the JAX package's loader.
    ``backbone_sd`` (the trunk's own state dict, every key of
    ``seg.net.model``: the ViT, or the FPN's ResNet-50) replaces the
    trunk's weights, so that a bf16 trunk's checkpoint keeps its f32
    source weights."""
    sd = {k: v.detach().float().cpu().clone()
          for k, v in seg.state_dict().items()}
    if backbone_sd is not None:
        want = {f"net.model.{k}" for k in backbone_sd}
        have = {k for k in sd if k.startswith("net.model.")}
        if want != have:
            raise ValueError(f"backbone_sd does not fit the segmenter's trunk: "
                             f"{sorted(want ^ have)[:4]}")
        sd.update({f"net.model.{k}": v.detach().float().cpu().clone()
                   for k, v in backbone_sd.items()})
    torch.save({
        "state_dict": sd,
        "hyper_parameters": {"cfg": seg.cfg.to_dict()},
        "global_step": int(step),
        "epoch": 0,
        "pytorch-lightning_version": "1.1.8",
    }, path)
