"""Standalone CRF-loss experiment: optimise a code table for a few images
against the CRF loss plus entropy regularisers; counterpart of
``stego_tpu/train/crf_app.py``.

    python -m stego_torch.train.crf_app pytorch_data_dir=... \
        dataset_name=... res=... dim=... [epochs=1000] [n_images_crf=7]

Behavioral reference: src/train_crf.py, as the JAX package's working
version of that stale script: a code table of shape (n_images, h, w, dim),
Adam(1e-2), the CRF loss over rgb or lab guidance, global and local
entropy regularisation for discrete codes, and PCA or boundary figures
(which need matplotlib: without it, one line names each figure not
written). ``main`` runs on the first CUDA device and exits with an error
when there is none; :func:`train_crf_codes` takes any device.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from stego_torch.config import Config
from stego_torch.ops.crf_loss import CRFLossCfg, contrastive_crf_loss
from stego_torch.ops.math import l2_normalize

_RGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
               (0.212671, 0.715160, 0.072169),
               (0.019334, 0.119193, 0.950227))
_WHITE = (0.950456, 1.0, 1.088754)


def rgb_to_normed_lab(img01: torch.Tensor) -> torch.Tensor:
    """sRGB [0, 1] (..., 3) -> CIELAB divided by (100, 256, 256)
    (reference to_normed_lab, train_crf.py:103-106, kornia's formula)."""
    rgb = torch.clamp(img01, 0.0, 1.0)
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                         rgb / 12.92)
    m = torch.tensor(_RGB_TO_XYZ, dtype=torch.float32, device=rgb.device)
    xyz = linear @ m.T
    xyz = xyz / torch.tensor(_WHITE, dtype=torch.float32, device=rgb.device)
    f = torch.where(xyz > 0.008856, torch.pow(xyz, 1.0 / 3.0),
                    7.787 * xyz + 16.0 / 116.0)
    l_ = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    lab = torch.stack([l_, a, b], dim=-1)
    return lab / torch.tensor([100.0, 256.0, 256.0], device=rgb.device)


def entropy(p: torch.Tensor) -> torch.Tensor:
    p = torch.clamp_min(p, 1e-7)
    return -torch.sum(p * torch.log(p), dim=-1)


def train_crf_codes(
    cfg: Config,
    imgs: np.ndarray,
    epochs: int = 1000,
    lr: float = 1e-2,
    global_ent_weight: float = 0.1,
    local_ent_weight: float = 0.1,
    log_every: int = 100,
    out_dir: Optional[str] = None,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    init_codes: Optional[np.ndarray] = None,
    draw_coords: Optional[Callable[[int], Tuple[torch.Tensor,
                                                torch.Tensor]]] = None,
) -> Dict[str, np.ndarray]:
    """Optimise per-image codes; returns {'codes', 'losses'} (the loss of
    every ``log_every``-th epoch, before that epoch's update).

    imgs: (N, H, W, 3) ImageNet-normalized images. ``init_codes``: the
    initial (N, H, W, dim) table (default 0.1 N(0, 1) from ``seed``);
    ``draw_coords(epoch)``: that epoch's (ys, xs) CRF samples (default:
    ``crf_samples`` uniform draws from a generator seeded by ``seed``).
    """
    from stego_torch.data.transforms import unnormalize

    dev = torch.device(device)
    n, h, w, _ = imgs.shape
    continuous = cfg.continuous
    gen = torch.Generator(device=dev).manual_seed(seed)
    if init_codes is None:
        code_space = 0.1 * torch.randn((n, h, w, cfg.dim), generator=gen,
                                       device=dev)
    else:
        code_space = torch.tensor(np.asarray(init_codes),
                                  dtype=torch.float32, device=dev)
    code_space.requires_grad_(True)
    opt = torch.optim.Adam([code_space], lr=lr)

    if cfg.color_space == "rgb":
        guidance = torch.as_tensor(imgs, dtype=torch.float32, device=dev)
    elif cfg.color_space == "lab":
        guidance = rgb_to_normed_lab(torch.as_tensor(
            unnormalize(np.asarray(imgs)), dtype=torch.float32, device=dev))
    else:
        raise ValueError(f"unknown color space: {cfg.color_space}")
    crf_cfg = CRFLossCfg.from_config(cfg)
    if draw_coords is None:
        def draw_coords(_):
            return (torch.randint(0, h, (crf_cfg.n_samples,), generator=gen,
                                  device=dev),
                    torch.randint(0, w, (crf_cfg.n_samples,), generator=gen,
                                  device=dev))

    losses = []
    for i in range(epochs):
        coords = tuple(torch.as_tensor(c, device=dev).long()
                       for c in draw_coords(i))
        if continuous:
            prepped = l2_normalize(code_space, dim=-1)
        else:
            log_probs = torch.log_softmax(code_space, dim=-1)
            prepped = torch.exp(log_probs)
        loss = torch.mean(contrastive_crf_loss(crf_cfg, guidance, prepped,
                                               coords))
        if not continuous:
            probs = torch.exp(log_probs)
            ent_global = torch.mean(entropy(torch.mean(probs, dim=0)))
            ent_local = torch.mean(entropy(probs))
            loss = (loss - global_ent_weight * ent_global
                    - local_ent_weight * ent_local)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if i % log_every == 0:
            losses.append(float(loss.detach()))
        opt.step()
        if i % log_every == 0 and out_dir:
            _save_code_figure(out_dir, i, np.asarray(imgs),
                              code_space.detach().cpu().numpy(), continuous)
    return {"codes": code_space.detach().cpu().numpy(),
            "losses": np.asarray(losses)}


def _save_code_figure(out_dir: str, step: int, imgs: np.ndarray,
                      codes: np.ndarray, continuous: bool) -> None:
    """Image row + PCA-projected code (continuous) or argmax segment
    boundaries (discrete), reference train_crf.py:135-155; one line instead
    when matplotlib does not import."""
    from stego_torch.utils.viz import write_figures

    def draw(path):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from stego_torch.utils.viz import prep_for_plot

        n = imgs.shape[0]
        fig, ax = plt.subplots(2, n, figsize=(n * 3, 6), squeeze=False)
        for idx in range(n):
            ax[0, idx].imshow(prep_for_plot(imgs[idx]))
            if continuous:
                flat = codes[idx].reshape(-1, codes.shape[-1])
                flat = flat - flat.mean(0)
                # PCA via SVD to 3 components
                _, _, vt = np.linalg.svd(flat, full_matrices=False)
                proj = (flat @ vt[:3].T).reshape(*codes.shape[1:3], 3)
                proj = (proj - proj.min()) / max(proj.max() - proj.min(),
                                                 1e-9)
                ax[1, idx].imshow(proj)
            else:
                seg = codes[idx].argmax(-1)
                boundaries = np.zeros_like(seg, bool)
                boundaries[1:] |= seg[1:] != seg[:-1]
                boundaries[:, 1:] |= seg[:, 1:] != seg[:, :-1]
                img = prep_for_plot(imgs[idx]).copy()
                img[boundaries] = [1.0, 1.0, 0.0]
                ax[1, idx].imshow(img)
            ax[0, idx].axis("off")
            ax[1, idx].axis("off")
        plt.tight_layout()
        fig.savefig(path)
        plt.close(fig)

    os.makedirs(out_dir, exist_ok=True)
    write_figures([(join(out_dir, f"codes_{step}.png"), draw)])


def main(argv=None):
    from stego_torch.config import prep_args
    from stego_torch.data.contrastive import ContrastiveSegDataset
    from stego_torch.data.transforms import get_transform

    overrides = prep_args(argv)
    base = overrides.pop("config", None)
    epochs = int(overrides.pop("epochs", 1000))
    n_images = int(overrides.pop("n_images_crf", 7))
    cfg = (Config.from_yaml(base, **overrides) if base
           else Config.from_dict(overrides, strict=True))
    if not torch.cuda.is_available():
        raise SystemExit("stego_torch.train.crf_app runs on a CUDA device and "
                         "found none; nothing was trained")

    small = cfg.res // 2
    dataset = ContrastiveSegDataset(
        pytorch_data_dir=cfg.pytorch_data_dir,
        dataset_name=cfg.dataset_name,
        crop_type=None,
        image_set="train",
        transform=get_transform(small, False, None),
        target_transform=get_transform(small, True, None),
        cfg=cfg,
    )
    imgs = np.stack([dataset[i]["img"] for i in range(n_images)])
    out_dir = join(cfg.output_root, "crf_experiment")
    result = train_crf_codes(cfg, imgs, epochs=epochs, out_dir=out_dir,
                             global_ent_weight=0.1, local_ent_weight=0.1,
                             device=torch.device("cuda", 0))
    print("final loss:",
          result["losses"][-1] if len(result["losses"]) else None)


if __name__ == "__main__":
    main()
