"""``python -m stego_torch.tools.ab_negatives_scope [images_per_shard=2]
[num_devices=4] [steps=40] [device=cuda] [output_root=...]``:
the negatives-scope A/B, the counterpart of ``scripts/ab_negatives_scope.py``.

It trains the sensitive accuracy proxy (``data/synthetic.py:
tiny_benchmark_setup``: the res-64 mosaic, the tiny ViT, 40 steps) twice
on ``num_devices`` ranks, each with ``images_per_shard`` images of the
global batch, once with ``negatives_scope=global`` (the negatives drawn
over the global batch, kernel C2 over the gathered maps) and once with
``negatives_scope=local`` (each rank deranges its own images, the
reference's per-process semantics, kernel C1 on each rank), and prints
both arms' ``test/`` metrics as one JSON line,
``{"ab_negatives_scope": {"global": {...}, "local": {...}}}``. Both arms
read the same data and the same KNN files, built once by one process.

The ranks run on ``cuda:0`` .. ``cuda:W-1`` over NCCL (one card a rank),
or with ``device=cpu`` over gloo on the CPU (the kernels' plain versions).
Without ``output_root`` it writes under a new temporary directory.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import torch

SCOPES = ("global", "local")


def arm(cfg, vit_cfg, device: Optional[str], out_path: str) -> None:
    """One rank of one arm: the app to ``cfg.max_steps``; rank 0 writes the
    final ``test/`` metrics to ``out_path``."""
    from stego_torch.parallel import dist
    from stego_torch.train.app import train

    metrics = train(cfg, vit_cfg=vit_cfg, device=device)
    if dist.is_primary():
        with open(out_path, "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()
                       if k.startswith("test/")}, f)


def run(root: str, images_per_shard: int = 2, num_devices: int = 4,
        steps: int = 40, device: str = "cuda"
        ) -> Dict[str, Dict[str, float]]:
    """Both arms under ``root``: {scope: test metrics}."""
    from stego_torch.data.synthetic import tiny_benchmark_setup
    from stego_torch.kernels import build
    from stego_torch.parallel import dist
    from stego_torch.train.knn_app import precompute_knns

    on_cpu = torch.device(device).type == "cpu"
    if not on_cpu and torch.cuda.device_count() < num_devices:
        raise SystemExit(
            f"stego_torch.tools.ab_negatives_scope runs {num_devices} ranks "
            f"on a CUDA device each and found {torch.cuda.device_count()} "
            f"(device=cpu runs them over gloo on the CPU)")
    rank_device = "cpu" if on_cpu else None  # else cuda:LOCAL_RANK
    batch = images_per_shard * num_devices
    results = {}
    for scope in SCOPES:
        cfg, vit = tiny_benchmark_setup(
            root, experiment_name=f"ab_{scope}",
            output_root=os.path.join(root, f"out_{scope}"),
            num_devices=num_devices, negatives_scope=scope,
            batch_size=batch, val_batch_size=batch, max_steps=steps,
            val_freq=steps, checkpoint_freq=steps)
        if scope == SCOPES[0]:  # the data and the KNN files, shared
            precompute_knns(cfg, dataset_names=["directory"],
                            crop_types=[None], vit_cfg=vit, res=cfg.res,
                            batch_size=8, device=torch.device(
                                rank_device or "cuda"))
        out = os.path.join(root, f"metrics_{scope}.json")
        dist.launch(arm, num_devices, cfg, vit, rank_device, out,
                    prepare=None if on_cpu else build.build,
                    device=rank_device)
        with open(out) as f:
            results[scope] = json.load(f)
        print(scope, json.dumps(results[scope]), flush=True)
    return results


def main(argv=None):
    from stego_torch.config import prep_args

    args = prep_args(argv)
    root = args.pop("output_root", None) or tempfile.mkdtemp(
        prefix="ab_negscope_")
    kw = dict(images_per_shard=int(args.pop("images_per_shard", 2)),
              num_devices=int(args.pop("num_devices", 4)),
              steps=int(args.pop("steps", 40)),
              device=str(args.pop("device", "cuda")))
    if args:
        raise SystemExit(f"unknown args: {sorted(args)}")
    print(f"writing under {root}", flush=True)
    results = run(root, **kw)
    print(json.dumps({"ab_negatives_scope": results}))


if __name__ == "__main__":
    main()
