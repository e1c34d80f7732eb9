"""stego_torch runs where there is no JAX and no PIL: a fresh interpreter in
which both imports fail imports every module of the port and runs one eval
step, and another runs one train step and one val step, on the CPU."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax raises ImportError
sys.modules["PIL"] = None
import importlib
import torch
MODULES = [
    "stego_torch", "stego_torch.kernels.build", "stego_torch.ops.layer_norm",
    "stego_torch.ops.flash_attention", "stego_torch.ops.math",
    "stego_torch.ops.interp", "stego_torch.ops.probe_ce",
    "stego_torch.models.vit", "stego_torch.models.featurizer",
    "stego_torch.models.probes", "stego_torch.models.convert",
    "stego_torch.data.transforms", "stego_torch.train.segmenter",
    "stego_torch.eval.evaluate", "stego_torch.eval.demo",
    "stego_torch.ops.sampling", "stego_torch.ops.correlation",
    "stego_torch.ops.corr_stream", "stego_torch.ops.corr_fused_sampling",
    "stego_torch.utils.metrics",
]
for name in MODULES:
    importlib.import_module(name)
from stego_tpu.config import Config
from stego_torch.eval.evaluate import make_eval_step
from stego_torch.models.vit import ViTConfig
from stego_torch.train.segmenter import UnsupervisedSegmenter
cfg = Config(dataset_name="directory", dim=6, res=32)  # bf16 trunk
vit = ViTConfig(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                img_size=32)
seg = UnsupervisedSegmenter(5, cfg, vit_cfg=vit).eval()
img = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
linear, cluster = make_eval_step(seg)(img, img[..., 0])
assert linear.shape == cluster.shape == (2, 32, 32)
assert int(linear.max()) < 5 and int(cluster.min()) >= 0
print("OK", sorted(m for m in sys.modules if m.split(".")[0] == "stego_tpu"))
"""


TRAIN_SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax raises ImportError
sys.modules["PIL"] = None
import torch
from stego_tpu.config import Config
from stego_torch.models.vit import ViTConfig
from stego_torch.train.segmenter import (UnsupervisedSegmenter,
                                         draw_step_randomness,
                                         make_train_step, make_val_step)
cfg = Config(dataset_name="directory", dim=6, res=32, feature_samples=3,
             neg_samples=2)  # bf16 trunk, fused sampling, dropout
vit = ViTConfig(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                img_size=32)
seg = UnsupervisedSegmenter(5, cfg, vit_cfg=vit)
g = torch.Generator().manual_seed(0)
img = torch.rand(2, 32, 32, 3, generator=g)
batch = {"img": img, "img_pos": img.flip(2),
         "label": torch.randint(-1, 5, (2, 32, 32), generator=g)}
m = make_train_step(seg)(batch, draw_step_randomness(seg, 2, g))
assert torch.isfinite(m["loss/total"]) and seg.step == 1
assert int(m["hist/neg_inter"].sum()) == 2 * 2 * 81
out = make_val_step(seg)(batch)
assert int(out["conf_linear"].sum()) == int((batch["label"] >= 0).sum())
print("OK", sorted(m for m in sys.modules if m.split(".")[0] == "stego_tpu"))
"""


def run_without_jax(script):
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_slice_imports_and_runs_without_jax_or_pil():
    proc = run_without_jax(SCRIPT)
    # only the stdlib-only config module comes from the JAX package
    assert proc.stdout.strip().endswith(
        "['stego_tpu', 'stego_tpu.config']"), proc.stdout


def test_train_and_val_step_run_without_jax_or_pil():
    proc = run_without_jax(TRAIN_SCRIPT)
    assert proc.stdout.strip().endswith(
        "['stego_tpu', 'stego_tpu.config']"), proc.stdout
