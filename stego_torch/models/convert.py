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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from stego_torch.config import Config
from stego_torch.models.vit import ViTConfig
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
    modules the port has (net, linear_probe, cluster_probe)."""
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
    if vit_cfg is None:
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
               ) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """Every head and probe parameter: torch name -> (JAX params path,
    dense 1x1-conv kernel?)."""
    names = dict(seg.named_parameters())
    out: Dict[str, Tuple[Tuple[str, ...], bool]] = {}
    for prefix, path, kernel, bias in _CONV_KEYS:
        if prefix + ".weight" in names:
            out[prefix + ".weight"] = (path + (kernel,), True)
            out[prefix + ".bias"] = (path + (bias,), False)
    for name, path in _CLUSTER_KEYS:
        out[name] = (path, False)
    return out


def _get(tree: Mapping[str, Any], path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _from_jax(a, dense: bool, like: torch.Tensor) -> torch.Tensor:
    t = _t(a)
    if dense:
        t = t.T[:, :, None, None]
    return t.to(like.device)


def _to_jax(t: torch.Tensor, dense: bool) -> np.ndarray:
    a = _np(t)
    return a[:, :, 0, 0].T if dense else a


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
        for name, (path, dense) in trainable.items():
            named[name].copy_(_from_jax(_get(params, path), dense,
                                        named[name]))
    ids = {id(p): n for n, p in named.items()}
    for opt_name, opt in seg.optimizers().items():
        adam = state["opt"][opt_name][0]
        count = float(np.asarray(adam.count))
        for group in opt.param_groups:
            for p in group["params"]:
                path, dense = trainable[ids[id(p)]]
                sub = _opt_path(opt_name, path)
                opt.state[p] = {
                    "step": torch.tensor(count),
                    "exp_avg": _from_jax(_get(adam.mu, sub), dense, p),
                    "exp_avg_sq": _from_jax(_get(adam.nu, sub), dense, p),
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
    for name, (path, dense) in trainable.items():
        _set(params, path, _to_jax(named[name], dense))
    ids = {id(p): n for n, p in named.items()}
    opt_states = {}
    for opt_name, opt in seg.optimizers().items():
        mu: Dict[str, Any] = {}
        nu: Dict[str, Any] = {}
        count = 0.0
        for group in opt.param_groups:
            for p in group["params"]:
                path, dense = trainable[ids[id(p)]]
                st = opt.state.get(p)
                zeros = torch.zeros_like(p)
                if st:
                    count = float(st["step"])
                _set(mu, _opt_path(opt_name, path),
                     _to_jax(st["exp_avg"] if st else zeros, dense))
                _set(nu, _opt_path(opt_name, path),
                     _to_jax(st["exp_avg_sq"] if st else zeros, dense))
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
    ``backbone_sd`` (the ViT's own state dict, every key of
    ``seg.net.model``) replaces the ViT's weights, so that a bf16 trunk's
    checkpoint keeps its f32 source weights."""
    sd = {k: v.detach().float().cpu().clone()
          for k, v in seg.state_dict().items()}
    if backbone_sd is not None:
        want = {f"net.model.{k}" for k in backbone_sd}
        have = {k for k in sd if k.startswith("net.model.")}
        if want != have:
            raise ValueError(f"backbone_sd does not fit the segmenter's ViT: "
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
