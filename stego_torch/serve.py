"""Model packaging for serving: a self-contained deployable artifact;
counterpart of ``stego_tpu/serve.py``.

    python -m stego_torch.serve model_path=<.ckpt> output_dir=<dir>
        [res=320] [batch_size=8] [n_devices=1]

then, in any process: ``ServingModel.load(dir).predict(batch)``.

The artifact is a ``torch.export`` program of the flip-TTA inference
function (normalise, two trunk calls, bilinear upsampling of the code, the
probes' log-probs, their argmaxes), batch-polymorphic (the batch is a
symbolic dimension; the resolution is fixed). A feature-pyramid
checkpoint's program is its ResNet-50 and head, with no custom ops (the
path has no attention and no LayerNorm). Inside a ViT's the trunk reaches
kernels A and L through the registered ops ``stego_torch::attention`` and
``stego_torch::layer_norm`` (``ops/flash_attention.py``,
``ops/layer_norm.py``). Each op has a CPU implementation, its plain version,
so one artifact runs on the CPU and on the card; on the card the op
launches the kernel. The JAX artifact swaps its Pallas kernels for the
einsum path (``stego_tpu/serve.py:140-154``), since a Mosaic call would pin
it to a TPU; the port has no such reason.

Artifact layout (a directory):
    model.pt2   the ``torch.export.save`` archive: graph and weights
    meta.json   input spec (res, batch, channels), class count, device

The weights live only inside ``model.pt2``: an ``ExportedProgram`` carries
its parameters and buffers, and ``torch.export.load`` restores them with
the graph, so a file beside it (the JAX layout's ``weights.npz``, which
``jax.export`` needs because its programs hold no weights) would be a
second copy.

The loading side (:class:`ServingModel`) imports this module and the two op
modules only: no model, train, eval, data or config code. It runs on
``cuda:0`` unless the caller asks for another device, and never falls back
to the CPU or to the plain versions when the card was asked for.

Over several devices (``n_devices > 1``, the JAX package's SPMD artifact,
``stego_tpu/serve.py:120-190``): the artifact is the same one-device,
batch-polymorphic program with ``n_devices`` recorded in ``meta.json``.
The loading side puts one copy of it on each of ``n_devices`` devices
(``cuda:0`` .. ``cuda:n-1`` unless the caller names them, and it raises
where fewer are visible), and ``predict`` splits a batch of any positive
multiple of ``n_devices`` into that many contiguous shards, launches every
shard's program before it reads a result back, so that separate cards
overlap, and concatenates the outputs in shard order: the JAX artifact's
batch split over its ``data`` mesh with the weights replicated.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

# the ops the artifact's graph calls: registered at import, before a load
from stego_torch.kernels import build
from stego_torch.ops import flash_attention as _attention  # noqa: F401
from stego_torch.ops import layer_norm as _layer_norm  # noqa: F401
from stego_torch.utils.precision import full_f32_for

MODEL_FILE = "model.pt2"
META_FILE = "meta.json"
OUTPUT_KEYS = ("linear_probs", "cluster_probs", "linear_preds",
               "cluster_preds")


def in_chans(seg) -> int:
    """The image channels ``seg`` takes: its ViT's, or 3 without one (the
    feature-pyramid arch's ResNet-50; ``serve.py:131``)."""
    return seg.vit_cfg.in_chans if seg.vit_cfg is not None else 3


class ServeFn(nn.Module):
    """Flip-TTA inference on a [0, 1] RGB(A) NHWC f32 batch
    (``serve.py:_serve_fn``): the channel statistics are buffers of the
    module, so the artifact takes raw images (reference
    eval_segmentation.py:124-131 math). Returns the probes' log-probs
    (B, H, W, n) f32 and their argmaxes (B, H, W) int32 at input size."""

    def __init__(self, seg):
        super().__init__()
        from stego_torch.data.transforms import channel_stats

        self.net = seg.net
        self.linear_probe = seg.linear_probe
        self.cluster_probe = seg.cluster_probe
        dev = seg.linear_probe.weight.device
        mean, std = (torch.as_tensor(s, device=dev)
                     for s in channel_stats(in_chans(seg)))
        self.register_buffer("mean", mean)
        self.register_buffer("std", std)

    def forward(self, img01: torch.Tensor) -> Dict[str, torch.Tensor]:
        # imported here: the loading side imports this module without them
        from stego_torch.eval.evaluate import flip_tta_code
        from stego_torch.models.probes import (cluster_lookup,
                                               linear_probe_logits)
        from stego_torch.ops.interp import interpolate

        img = (img01.float() - self.mean) / self.std
        code = flip_tta_code(self, img)
        code = interpolate(code, img.shape[1:3], "bilinear",
                           align_corners=False)
        linear_probs = torch.log_softmax(
            linear_probe_logits(self.linear_probe, code), dim=-1)
        cluster_probs = cluster_lookup(self.cluster_probe.clusters, code,
                                       alpha=2.0, log_probs=True)
        return {
            "linear_probs": linear_probs,
            "cluster_probs": cluster_probs,
            "linear_preds": linear_probs.argmax(-1).to(torch.int32),
            "cluster_preds": cluster_probs.argmax(-1).to(torch.int32),
        }


def package_from_parts(seg, out_dir: str, res: int, batch_size: int,
                       n_devices: int = 1) -> str:
    """Export the segmenter ``seg`` (in eval mode, on the device it is on)
    as a serving artifact directory. ``batch_size`` is recorded and sizes
    the example the export traces (at least 2: export specialises a
    dimension of size 1); the artifact serves any batch of at least 1, or,
    with ``n_devices`` (which must divide ``batch_size``), any positive
    multiple of ``n_devices`` split over that many devices. The program is
    the one-device program either way."""
    if n_devices < 1 or batch_size % n_devices:
        raise ValueError(f"n_devices={n_devices} must divide "
                         f"batch_size={batch_size}")
    os.makedirs(out_dir, exist_ok=True)
    fn = ServeFn(seg).eval()
    channels = in_chans(seg)
    example = torch.zeros(max(batch_size, 2), res, res, channels,
                          device=fn.mean.device)
    batch = torch.export.Dim("batch", min=1)
    with torch.no_grad():
        program = torch.export.export(fn, (example,),
                                      dynamic_shapes=({0: batch},),
                                      strict=False)
    torch.export.save(program, os.path.join(out_dir, MODEL_FILE))
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump({
            "res": res, "batch_size": batch_size, "in_chans": channels,
            "n_devices": n_devices, "n_classes": seg.n_classes,
            "extra_clusters": seg.cfg.extra_clusters,
            "batch_polymorphic": True,
            "input": "float32 [0,1] RGB(A), NHWC",
            "device": str(example.device),
            "backbone_dtype": seg.cfg.backbone_dtype,
        }, f, indent=2)
    return out_dir


def package(model_path: str, out_dir: str, res: int = 320,
            batch_size: int = 8, n_devices: int = 1,
            device: Optional[Union[str, torch.device]] = None) -> str:
    """Package a trained Lightning ``.ckpt`` (``load_model_for_eval``) on
    ``device`` (default ``cuda:0``)."""
    from stego_torch.eval.evaluate import load_model_for_eval

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    seg = load_model_for_eval(model_path, dev)
    return package_from_parts(seg, out_dir, res, batch_size,
                              n_devices=n_devices)


class ServingModel:
    """A packaged artifact, loaded: ``modules`` holds the program on each
    of its ``devices`` (one a shard; ``module`` and ``device`` are the
    first), each a ``torch.nn.Module`` taking a tensor on its device;
    ``predict`` takes and returns host arrays. No model code, no config, no
    checkpoint reader."""

    def __init__(self, modules: Sequence[nn.Module], meta: Dict[str, Any],
                 devices: Sequence[torch.device]):
        self.modules = list(modules)
        self.meta = meta
        self.devices = list(devices)
        self.module, self.device = self.modules[0], self.devices[0]

    @classmethod
    def load(cls, path: str,
             devices: Optional[Sequence[Union[str, torch.device]]] = None
             ) -> "ServingModel":
        """Load one copy of the program onto each of ``devices``: one entry
        a shard, the artifact's ``n_devices`` of them (a device may repeat,
        and a device named twice shares one copy), by default ``cuda:0`` ..
        ``cuda:n-1``, which raises where fewer CUDA devices are visible
        (``stego_tpu/serve.py:_mesh``). An artifact packaged on another
        device is moved by ``move_to_device_pass``, which rewrites the
        devices traced into its graph with its weights. On a CUDA device
        the kernel library is built (or found) here, so a failed build
        fails the load. An f32 trunk's artifact turns TF32 off for the
        process (``utils/precision.py``)."""
        from torch.export.passes import move_to_device_pass

        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        n = int(meta.get("n_devices", 1))
        if devices is None:
            have = torch.cuda.device_count()
            if have < n:
                raise RuntimeError(
                    f"artifact needs {n} CUDA device{'s' * (n > 1)}, have "
                    f"{have} (pass devices= to serve its shards on others)")
            devices = range(n)
        devices = [torch.device("cuda", d) if isinstance(d, int)
                   else torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"artifact of n_devices={n} takes {n} devices, "
                             f"got {len(devices)}: {devices}")
        full_f32_for(meta.get("backbone_dtype", "float32"))
        copies = {}
        for dev in devices:
            if dev in copies:
                continue
            # the pass moves the program in place: one load a device
            program = torch.export.load(os.path.join(path, MODEL_FILE))
            if torch.device(meta["device"]) != dev:
                program = move_to_device_pass(program, dev)
            copies[dev] = program.module()
        if any(dev.type == "cuda" for dev in devices):
            build.library()
        return cls([copies[dev] for dev in devices], meta, devices)

    def predict(self, img01: Union[np.ndarray, torch.Tensor]
                ) -> Dict[str, np.ndarray]:
        """img01: (B, res, res, C) in [0, 1] as f32, B any positive multiple
        of the artifact's device count (any B >= 1 on one device). Splits it
        into one contiguous shard a device, in order, launches every shard
        before it reads any result back, and returns the four outputs of
        :class:`ServeFn` as numpy arrays, the shards' in order."""
        n = len(self.devices)
        if len(img01) == 0 or len(img01) % n:
            raise ValueError(
                f"artifact of n_devices={n} needs a batch divisible by {n}, "
                f"got {len(img01)} (pad the final batch)")
        img = torch.as_tensor(img01, dtype=torch.float32)
        outs = []
        with torch.no_grad():
            for module, dev, shard in zip(self.modules, self.devices,
                                          img.split(len(img) // n)):
                outs.append(module(shard.to(dev)))
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
                for k in OUTPUT_KEYS}


def main(argv: Optional[Sequence[str]] = None):
    """CLI: package a ``.ckpt`` on the first CUDA device; then from the
    serving side ``ServingModel.load(dir).predict(batch)``."""
    from stego_torch.config import prep_args

    args = prep_args(argv)
    model_path = args.pop("model_path", None)
    output_dir = args.pop("output_dir", None)
    res = int(args.pop("res", 320))
    batch_size = int(args.pop("batch_size", 8))
    n_devices = int(args.pop("n_devices", 1))
    if args:  # fail on typos BEFORE the export trace
        raise ValueError(f"Unknown args: {sorted(args)}")
    if model_path is None or output_dir is None:
        raise SystemExit("pass model_path=<.ckpt file> output_dir=<dir>")
    if not torch.cuda.is_available():
        raise SystemExit("stego_torch.serve packages on a CUDA device and "
                         "found none; nothing was packaged")
    out = package(model_path, output_dir, res=res, batch_size=batch_size,
                  n_devices=n_devices)
    print(f"packaged serving artifact at {out}")


if __name__ == "__main__":
    main()
