"""Demo inference on an unlabeled image folder; counterpart of
``stego_tpu/eval/demo.py``.

    python -m stego_torch.eval.demo model_path=<.ckpt> image_dir=<dir> run_crf=false

Writes ``results/predictions/<experiment_name>/{linear,cluster}/<name>.png``
(uint8 label maps), the trees the JAX demo writes. Runs on the first CUDA
device, or on the CPU (the kernels' plain versions) when there is none.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Optional, Union

import numpy as np
import torch

from stego_torch.config import Config
from stego_torch.data.transforms import channel_stats
from stego_torch.eval.evaluate import load_model_for_eval, make_eval_step
from stego_torch.models.vit import ViTConfig


def load_image(path: str, res: int) -> np.ndarray:
    """(res, res, 3) ImageNet-normalized f32 image, as
    ``stego_tpu.data.transforms.get_transform(res, False, "center")`` makes
    it: RGB, short side resized to ``res`` with NEAREST, centre crop."""
    from PIL import Image

    with Image.open(path) as im:
        img = im.convert("RGB")
    w, h = img.size
    if not ((w <= h and w == res) or (h <= w and h == res)):
        size = (res, int(res * h / w)) if w < h else (int(res * w / h), res)
        img = img.resize(size, Image.NEAREST)
    arr = np.asarray(img).astype(np.float32) / 255.0
    h, w = arr.shape[:2]
    if h < res or w < res:
        ph, pw = max(res - h, 0), max(res - w, 0)
        arr = np.pad(arr, ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2),
                           (0, 0)))
        h, w = arr.shape[:2]
    top, left = (h - res) // 2, (w - res) // 2
    arr = arr[top:top + res, left:left + res]
    mean, std = channel_stats(3)
    return (arr - mean) / std


def demo(cfg: Config, model_path: str, image_dir: str, result_dir: str,
         device: Union[str, torch.device],
         vit_cfg: Optional[ViTConfig] = None) -> int:
    """Predict every image of ``image_dir``; returns the count."""
    from PIL import Image

    eval_step = make_eval_step(load_model_for_eval(model_path, device,
                                                   vit_cfg=vit_cfg),
                               run_crf=cfg.run_crf)
    for tree in ("cluster", "linear"):
        os.makedirs(join(result_dir, tree), exist_ok=True)
    names = sorted(os.listdir(image_dir))
    batch_size = min(cfg.batch_size * 2, max(1, len(names)))
    for i in range(0, len(names), batch_size):
        batch = names[i:i + batch_size]
        img = torch.from_numpy(np.stack(
            [load_image(join(image_dir, n), cfg.res) for n in batch])
        ).to(device)
        # no labels: the image's (B, H, W) sets the prediction size
        linear_preds, cluster_preds = (
            p.cpu().numpy().astype(np.uint8)
            for p in eval_step(img, img[..., 0]))
        for j, name in enumerate(batch):
            png = ".".join(name.split(".")[:-1]) + ".png"
            Image.fromarray(linear_preds[j]).save(join(result_dir, "linear",
                                                       png))
            Image.fromarray(cluster_preds[j]).save(join(result_dir, "cluster",
                                                        png))
    return len(names)


def main(argv=None):
    from stego_torch.config import prep_args

    overrides = prep_args(argv)
    base = overrides.pop("config", None)
    cfg = (Config.from_yaml(base, **overrides) if base
           else Config.from_dict(overrides, strict=True))
    if not cfg.model_path or not cfg.image_dir:
        raise SystemExit("pass model_path=... image_dir=...")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    result_dir = join("results", "predictions", cfg.experiment_name)
    n = demo(cfg, cfg.model_path, cfg.image_dir, result_dir, device)
    print(f"wrote {n} predictions to {result_dir}")


if __name__ == "__main__":
    main()
