"""``python -m stego_torch.tools.ab_negatives_scope`` on the CPU: both arms
of the negatives-scope A/B (the sensitive proxy's mosaic and tiny ViT, a
few steps, 2 images a shard on 2 gloo ranks) from one KNN build, and the
one JSON line with both arms' ``test/`` metrics."""

import json
import math
import os
import subprocess
import sys

from tests._torch_cpu import child_env, one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = {f"test/{probe}/{m}" for probe in ("linear", "cluster")
           for m in ("mIoU", "Accuracy")}


def test_ab_tool_runs_both_arms_on_two_gloo_ranks(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "stego_torch.tools.ab_negatives_scope",
         "device=cpu", "num_devices=2", "images_per_shard=2", "steps=2",
         f"output_root={tmp_path}"],
        cwd=REPO, env=child_env(), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    arms = last["ab_negatives_scope"]
    assert set(arms) == {"global", "local"}
    for scope, metrics in arms.items():
        assert set(metrics) == METRICS, scope
        assert all(math.isfinite(v) and 0 <= v <= 100
                   for v in metrics.values()), (scope, metrics)
        assert os.path.isdir(tmp_path / f"out_{scope}" / "logs"
                             / f"directory_ab_{scope}")
    nns = os.listdir(tmp_path / "data" / "nns")
    assert len(nns) == 2 and all(n.endswith(".npz") for n in nns), nns
