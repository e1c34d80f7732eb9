"""``python -m stego_torch.tools.accuracy_bench [output_root=...]
[rows=default,sensitive,trunks] [steps=300] [res=96] [device=cuda]``: the
accuracy proxy on the synthetic mosaic, the counterpart of
``scripts/accuracy_bench.py``.

No released checkpoint or real dataset is reachable offline, so accuracy
is tracked on a generated task hard enough that cluster mIoU stays below
100: the textured mosaic (``data/synthetic.py``), KNN caches from the
trunk, and the training app to the end of its steps with a random trunk
(no DINO weights), then the final Hungarian-matched metrics as JSON lines.
The rows, in ``rows``' order:

* ``default``: ViT-S/8, bf16, res 96, 300 steps, batch 16, decode cache
  on (:func:`default_row`); gated by bands at that footprint only;
* ``sensitive``: the tiny net of ``tiny_benchmark_setup`` (2 blocks,
  width 32, 4 heads of 8), bf16 so that its attention and LayerNorms run
  kernels A and L, 40 steps at res 64 (:func:`sensitive`); it moves when
  the numerics move;
* ``trunks``: the sensitive row on each of the port's seeded trunks
  TRUNK_SEEDS (:func:`sensitive_trunks`). One random trunk is one draw:
  its cluster probe lands anywhere from ~15 to ~45 mIoU, so a band on one
  trunk gates the draw as much as the numerics. Every trunk must pass the
  linear bands and at least TRUNKS_PASSING of them every band
  (:func:`trunks_missed`).

The bands are the JAX package's (``scripts/accuracy_bench.py``), set about
15% below its measurements on a TPU (BASELINE.md): the port is held to the
same floor, not to those measurements. Each JSON line names the device it
ran on. It runs on the first CUDA device and exits with an error without
one; ``device=cpu`` runs the kernels' plain versions. Without
``output_root`` it writes under a new temporary directory.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import torch

# ~15% below the JAX package's measurements on a TPU (v5e, seed 0:
# BASELINE.md; scripts/accuracy_bench.py:102-108 and :153-158)
DEFAULT_BANDS = {
    "test/linear/mIoU": 8.9,
    "test/linear/Accuracy": 24.9,
    "test/cluster/mIoU": 6.4,
    "test/cluster/Accuracy": 25.7,
}
SENSITIVE_BANDS = {
    "test/linear/mIoU": 61.5,
    "test/linear/Accuracy": 73.5,
    "test/cluster/mIoU": 18.9,
    "test/cluster/Accuracy": 39.0,
}
# the port's seeded trunks of the trunks row, and how many of them must
# pass every band: on the CPU the kernels' plain versions pass every band
# on 7 of the 8 (PERF.md section 6); a numerics fault moves most
# of them
TRUNK_SEEDS = (1, 2, 3, 4, 5, 6, 7, 8)
TRUNKS_PASSING = 6
LINEAR_BANDS = ("test/linear/mIoU", "test/linear/Accuracy")
ROWS = ("default", "sensitive", "trunks")


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def missed(metrics: Dict[str, float], bands: Dict[str, float]
           ) -> Dict[str, tuple]:
    """The band entries ``metrics`` falls below, as (value, band)."""
    return {k: (round(float(metrics[k]), 2), v) for k, v in bands.items()
            if float(metrics[k]) < v}


def _row_line(name: str, steps: int, res: int, metrics, device) -> str:
    return json.dumps({
        "benchmark": name, "steps": steps, "res": res,
        "device": device_name(device),
        **{k: round(float(v), 2) for k, v in metrics.items()},
    })


def default_row(out_root: str, steps: int = 300, res: int = 96,
                device: Optional[torch.device] = None) -> Dict[str, float]:
    """The default row: write the mosaic (64 train, 16 val at ``res``),
    build its KNN caches and train ViT-S/8 in bf16; returns the final
    metrics."""
    from stego_torch.config import Config
    from stego_torch.data.synthetic import write_synthetic_benchmark
    from stego_torch.train.app import train
    from stego_torch.train.knn_app import precompute_knns

    device = torch.device("cuda") if device is None else device
    data_root = os.path.join(out_root, "data")
    write_synthetic_benchmark(data_root, res=res)
    cfg = Config(
        output_root=os.path.join(out_root, "out"),
        pytorch_data_dir=data_root,
        dataset_name="directory", dir_dataset_name="synthbench",
        dir_dataset_n_classes=4, experiment_name="acc_bench",
        model_type="vit_small", dino_patch_size=8,
        res=res, val_res=res, batch_size=16, val_batch_size=16,
        max_steps=steps, val_freq=steps, checkpoint_freq=steps,
        num_neighbors=4, crop_type=None, loader_crop_type="center",
        backbone_dtype="bfloat16", cache_dataset=True, seed=0,
    )
    precompute_knns(cfg, dataset_names=["directory"], crop_types=[None],
                    res=res, batch_size=16, device=device)
    return train(cfg, device=device)


def sensitive(out_root: str, device: Optional[torch.device] = None,
              trunk_seed: Optional[int] = None) -> Dict[str, float]:
    """The sensitive row: ``tiny_benchmark_setup`` under
    ``<out_root>/sensitive`` with a bf16 trunk, its KNN caches at res 64
    and 40 steps of the app; returns the final metrics. With
    ``trunk_seed`` (under ``<out_root>/trunk<seed>``) the trunk is a
    ``VisionTransformer`` seeded with it, given to both as
    ``pretrained_weights``; everything else is the row's."""
    from stego_torch.data.synthetic import tiny_benchmark_setup
    from stego_torch.models.vit import VisionTransformer
    from stego_torch.train.app import train
    from stego_torch.train.knn_app import precompute_knns

    device = torch.device("cuda") if device is None else device
    root = os.path.join(out_root, "sensitive" if trunk_seed is None
                        else f"trunk{trunk_seed}")
    cfg, vit = tiny_benchmark_setup(
        root, experiment_name="acc_sensitive", backbone_dtype="bfloat16")
    if trunk_seed is not None:
        weights = os.path.join(root, "trunk.pth")
        torch.save(VisionTransformer(
            vit, torch.Generator().manual_seed(trunk_seed)).state_dict(),
            weights)
        cfg = cfg.replace(pretrained_weights=weights)
    precompute_knns(cfg, dataset_names=["directory"], crop_types=[None],
                    vit_cfg=vit, res=64, batch_size=8, device=device)
    return train(cfg, vit_cfg=vit, device=device)


def sensitive_trunks(out_root: str, device: Optional[torch.device] = None
                     ) -> Dict[int, Dict[str, float]]:
    """The sensitive row on each trunk of TRUNK_SEEDS: {seed: metrics}."""
    return {s: sensitive(out_root, device, s) for s in TRUNK_SEEDS}


def trunks_missed(rows: Dict[int, Dict[str, float]]) -> Optional[str]:
    """What the trunks row misses: a trunk below a linear band, or fewer
    than TRUNKS_PASSING trunks that pass every band; None if nothing."""
    linear = {s: missed(m, {k: SENSITIVE_BANDS[k] for k in LINEAR_BANDS})
              for s, m in rows.items()}
    linear = {s: f for s, f in linear.items() if f}
    passing = sum(not missed(m, SENSITIVE_BANDS) for m in rows.values())
    if linear or passing < TRUNKS_PASSING:
        return (f"{passing} of {len(rows)} trunks pass every band (at "
                f"least {TRUNKS_PASSING}); below a linear band: {linear}")
    return None


def main(argv=None):
    from stego_torch.config import prep_args

    args = prep_args(argv)
    out_root = args.pop("output_root", None) or tempfile.mkdtemp(
        prefix="acc_bench_")
    rows = str(args.pop("rows", ",".join(ROWS))).split(",")
    steps = int(args.pop("steps", 300))
    res = int(args.pop("res", 96))
    device = torch.device(args.pop("device", "cuda"))
    if args:
        raise SystemExit(f"unknown args: {sorted(args)}")
    if set(rows) - set(ROWS):
        raise SystemExit(f"rows must be among {ROWS}, not {rows}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("stego_torch.tools.accuracy_bench runs on a CUDA "
                         "device and found none (device=cpu runs the "
                         "kernels' plain versions)")
    print(f"writing under {out_root}", flush=True)
    for row in rows:
        if row == "default":
            metrics = default_row(out_root, steps, res, device)
            print(_row_line("synthetic-mosaic accuracy (random ViT-S/8 "
                            "backbone)", steps, res, metrics, device))
            if steps != 300 or res != 96:  # other footprints print only
                continue
            failed = missed(metrics, DEFAULT_BANDS)
            if failed:
                raise SystemExit(f"ACCURACY REGRESSION vs the JAX "
                                 f"package's bands: {failed}")
            print(json.dumps({"accuracy_gate": "pass",
                              "bands": DEFAULT_BANDS}))
        elif row == "sensitive":
            metrics = sensitive(out_root, device)
            print(_row_line("synthetic-mosaic accuracy (SENSITIVE 2-block "
                            "net, bf16 trunk through kernels A and L)", 40,
                            64, metrics, device))
            failed = missed(metrics, SENSITIVE_BANDS)
            if failed:
                raise SystemExit(f"SENSITIVE ACCURACY REGRESSION vs the JAX "
                                 f"package's bands: {failed}")
            print(json.dumps({"sensitive_accuracy_gate": "pass",
                              "bands": SENSITIVE_BANDS}))
        else:
            trunks = sensitive_trunks(out_root, device)
            for seed, metrics in trunks.items():
                print(_row_line(f"synthetic-mosaic accuracy (SENSITIVE "
                                f"2-block net, trunk seed {seed})", 40, 64,
                                metrics, device))
            failed = trunks_missed(trunks)
            if failed:
                raise SystemExit(f"SENSITIVE ACCURACY REGRESSION over "
                                 f"{len(trunks)} trunks: {failed}")
            print(json.dumps({"trunks_accuracy_gate": "pass",
                              "trunks": len(trunks),
                              "passing_at_least": TRUNKS_PASSING,
                              "bands": SENSITIVE_BANDS}))


if __name__ == "__main__":
    main()
