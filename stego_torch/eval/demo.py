"""Demo inference on an unlabeled image folder; counterpart of
``stego_tpu/eval/demo.py``.

    python -m stego_torch.eval.demo model_path=<.ckpt> image_dir=<dir> run_crf=false

Writes ``results/predictions/<experiment_name>/{linear,cluster}/<name>.png``
(uint8 label maps), the trees the JAX demo writes. ``main`` runs on the
first CUDA device and exits with an error when there is none; only a
caller of :func:`demo` can ask for the CPU, by passing a CPU device (the
kernels' plain versions then run).
"""

from __future__ import annotations

import os
from os.path import join
from typing import Optional, Union

import numpy as np
import torch

from stego_torch.config import Config
from stego_torch.data.transforms import get_transform
from stego_torch.eval.evaluate import load_model_for_eval, make_eval_step
from stego_torch.models.vit import ViTConfig


def load_image(path: str, res: int) -> np.ndarray:
    """(res, res, 3) ImageNet-normalized f32 image: ``get_transform(res,
    False, "center")`` on the file as RGB (short side resized to ``res``
    with NEAREST, centre crop), as the JAX demo's folder dataset reads
    it."""
    return get_transform(res, False, "center")(path, force_rgb=True)


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
    if not torch.cuda.is_available():
        raise SystemExit("stego_torch.eval.demo runs on a CUDA device and "
                         "found none; nothing was written")
    device = torch.device("cuda", 0)
    result_dir = join("results", "predictions", cfg.experiment_name)
    n = demo(cfg, cfg.model_path, cfg.image_dir, result_dir, device)
    print(f"wrote {n} predictions to {result_dir}")


if __name__ == "__main__":
    main()
