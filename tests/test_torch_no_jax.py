"""stego_torch runs where there is no JAX, no PIL and no JAX package: a
fresh interpreter in which those imports fail imports every module of the
port and runs one eval step, another runs train steps (the sampled loss
through C1's plain version, full-field and grid-sampled through C2's) and
one val step, a third builds a KNN cache and a feature cache and runs a
cached train step and a cached val epoch, and a fourth runs the train app
on in-memory datasets (two steps, a validation and a checkpoint, then a
resumed step), on the CPU."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax raises ImportError
sys.modules["PIL"] = None
sys.modules["stego_tpu"] = None  # nor anything of the JAX package
import importlib
import torch
MODULES = [
    "stego_torch", "stego_torch.config", "stego_torch.kernels.build",
    "stego_torch.ops.layer_norm",
    "stego_torch.ops.flash_attention", "stego_torch.ops.math",
    "stego_torch.ops.interp", "stego_torch.ops.probe_ce",
    "stego_torch.models.vit", "stego_torch.models.featurizer",
    "stego_torch.models.probes", "stego_torch.models.convert",
    "stego_torch.data.transforms", "stego_torch.train.segmenter",
    "stego_torch.eval.evaluate", "stego_torch.eval.demo",
    "stego_torch.ops.sampling", "stego_torch.ops.correlation",
    "stego_torch.ops.corr_stream", "stego_torch.ops.corr_fused_sampling",
    "stego_torch.utils.metrics", "stego_torch.data.synthetic",
    "stego_torch.train.knn", "stego_torch.train.feat_cache",
    "stego_torch.tools.attention_layouts",
    "stego_torch.tools.attention_consumers",
    "stego_torch.tools.loss_kernels_diff",
    "stego_torch.data.datasets", "stego_torch.data.contrastive",
    "stego_torch.data.loader", "stego_torch.data.crop",
    "stego_torch.data.native_io", "stego_torch.utils.logging",
    "stego_torch.train.checkpoint", "stego_torch.train.knn_app",
    "stego_torch.train.app", "stego_torch.train.__main__",
]
for name in MODULES:
    importlib.import_module(name)
from stego_torch.config import Config
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
# ViT-T's 3 heads take the head-major path (trunk_attention)
tiny = UnsupervisedSegmenter(5, cfg, vit_cfg=ViTConfig(
    patch_size=8, embed_dim=192, depth=2, num_heads=3, img_size=32)).eval()
linear, _ = make_eval_step(tiny)(img, img[..., 0])
assert linear.shape == (2, 32, 32)
from stego_torch.tools.attention_layouts import (ladder_errors, main,
                                                run_ladder)
cpu = torch.device("cpu")
rows = run_ladder("vit_small", batch=1, tokens=9, iters=1, device=cpu)
assert len(rows) == 10 and all(r["launches"] == {} for r in rows)
errors = ladder_errors("vit_small", batch=1, tokens=9, device=cpu)
assert all(e["max_abs_err_plain"] in (None, 0.0) for e in errors.values())
assert main(["--device", "cpu", "--models", "vit_tiny", "--batch", "1",
             "--tokens", "9", "--iters", "1"]) == 0
print("OK", sorted(m for m, mod in sys.modules.items()
                   if mod is not None and m.split(".")[0] == "stego_tpu"))
"""


TRAIN_SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax raises ImportError
sys.modules["PIL"] = None
sys.modules["stego_tpu"] = None  # nor anything of the JAX package
import torch
from stego_torch.config import Config
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
for kw in (dict(full_field_loss=True), dict(fused_sampling="off")):
    seg.cfg = cfg.replace(**kw)
    m = make_train_step(seg)(batch, draw_step_randomness(seg, 2, g))
    assert torch.isfinite(m["loss/total"])
    assert ("hist/neg_inter" in m) == ("fused_sampling" in kw)
assert seg.step == 3
out = make_val_step(seg)(batch)
assert int(out["conf_linear"].sum()) == int((batch["label"] >= 0).sum())
print("OK", sorted(m for m, mod in sys.modules.items()
                   if mod is not None and m.split(".")[0] == "stego_tpu"))
"""


CACHED_SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax raises ImportError
sys.modules["PIL"] = None
sys.modules["stego_tpu"] = None  # nor anything of the JAX package
import os
import tempfile
import numpy as np
import torch
from stego_torch.config import Config
from stego_torch.data.synthetic import render_scene
from stego_torch.models.vit import ViTConfig
from stego_torch.train.feat_cache import FeatCacheSampler, build_feat_cache
from stego_torch.train.knn import build_knn_cache, knn_cache_file
from stego_torch.train.segmenter import (UnsupervisedSegmenter,
                                         draw_step_randomness,
                                         make_cached_train_step,
                                         make_cached_val_epoch)
cfg = Config(dataset_name="directory", dim=6, res=32, feature_samples=3,
             neg_samples=2, batch_size=4, num_neighbors=3,
             cache_backbone_feats=True)  # bf16 trunk, fused sampling
vit = ViTConfig(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                img_size=32)
seg = UnsupervisedSegmenter(5, cfg, vit_cfg=vit)
rng = np.random.default_rng(0)
items = [render_scene(rng, 32, 5) for _ in range(10)]

class Contrastive:
    dataset = items
    seed, epoch, num_neighbors = 0, 0, 3
    pos_images = pos_labels = True

ds = Contrastive()
with tempfile.TemporaryDirectory() as tmp:
    path = knn_cache_file(tmp, "vit_small", "synth", "train", None, 32)
    loader = [torch.from_numpy(np.stack([it[0] for it in items[i:i + 4]]))
              for i in range(0, 10, 4)]
    ds.nns = build_knn_cache(path, seg.net, loader, k=4)
    assert os.path.exists(path) and ds.nns.shape == (10, 4)
cache = build_feat_cache(seg, ds, cfg)
assert cache["feats"].dtype == torch.bfloat16
sampler = FeatCacheSampler(ds)
draws = [sampler[i] for i in (3, 0, 9, 5)]
batch = {k: np.array([d[k] for d in draws]) for k in ("ind", "ind_pos")}
g = torch.Generator().manual_seed(0)
m = make_cached_train_step(seg)(cache, batch, draw_step_randomness(seg, 4, g))
assert torch.isfinite(m["loss/total"]) and seg.step == 1
out = make_cached_val_epoch(seg)(cache, [[0, 1, 2, 3], [4, 5, -1, -1]])
n_valid = sum(int((items[i][1] >= 0).sum()) for i in range(6))
assert int(out["conf_linear"].sum()) == n_valid
print("OK", sorted(m for m, mod in sys.modules.items()
                   if mod is not None and m.split(".")[0] == "stego_tpu"))
"""


APP_SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax raises ImportError
sys.modules["PIL"] = None
sys.modules["stego_tpu"] = None  # nor anything of the JAX package
import math
import tempfile
import numpy as np
import torch
from stego_torch.config import Config
from stego_torch.data.contrastive import ContrastiveSegDataset
from stego_torch.data.synthetic import render_scene
from stego_torch.models.vit import ViTConfig
from stego_torch.train.app import Trainer
rng = np.random.default_rng(0)

def items(n):
    out = []
    for _ in range(n):
        img, label = render_scene(rng, 32, 5)
        label = label.astype(np.int64)
        out.append((img, label, (label > 0).astype(np.float32)))
    return out

nns = np.stack([(np.arange(8) + k) % 8 for k in range(4)], axis=1)
train_ds = ContrastiveSegDataset.from_items(items(8), 5, nns=nns,
                                            num_neighbors=3)
val_ds = ContrastiveSegDataset.from_items(items(4), 5)
vit = ViTConfig(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                img_size=32)
cpu = torch.device("cpu")
with tempfile.TemporaryDirectory() as tmp:
    cfg = Config(dataset_name="directory", dim=6, res=32, val_res=32,
                 feature_samples=3, neg_samples=2, batch_size=4,
                 max_steps=2, val_freq=2, checkpoint_freq=2,
                 scalar_log_freq=1, num_neighbors=3,
                 output_root=tmp)  # bf16 trunk
    first = Trainer(cfg, vit_cfg=vit, train_dataset=train_ds,
                    val_dataset=val_ds, device=cpu)
    metrics = first.run()
    assert len(metrics) == 4 and all(math.isfinite(v)
                                     for v in metrics.values())
    assert first.mgr.all_steps() == [2] and len(first.val_seconds) == 1
    resumed = Trainer(cfg.replace(max_steps=3, resume=True), vit_cfg=vit,
                      train_dataset=train_ds, val_dataset=val_ds,
                      device=cpu)
    resumed.run()
    assert resumed.start_step == 2 and resumed.seg.step == 3
    assert resumed.mgr.all_steps() == [2, 3]
print("OK", sorted(m for m, mod in sys.modules.items()
                   if mod is not None and m.split(".")[0] == "stego_tpu"))
"""


def run_without_jax(script):
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_slice_imports_and_runs_without_jax_or_pil():
    proc = run_without_jax(SCRIPT)
    # nothing of the JAX package is loaded, not even a stdlib-only module
    assert proc.stdout.strip().endswith("OK []"), proc.stdout


def test_train_and_val_step_run_without_jax_or_pil():
    proc = run_without_jax(TRAIN_SCRIPT)
    assert proc.stdout.strip().endswith("OK []"), proc.stdout


def test_knn_cache_and_cached_steps_run_without_jax_or_pil():
    proc = run_without_jax(CACHED_SCRIPT)
    assert proc.stdout.strip().endswith("OK []"), proc.stdout


def test_train_app_runs_and_resumes_without_jax_or_pil():
    proc = run_without_jax(APP_SCRIPT)
    assert proc.stdout.strip().endswith("OK []"), proc.stdout
