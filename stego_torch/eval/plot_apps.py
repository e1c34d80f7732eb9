"""The figure apps (reference plot_dino_correspondence.py, plot_potsdam.py,
plot_pr_curves.py), assembling datasets and models around
:mod:`stego_torch.eval.analysis`; counterpart of
``stego_tpu/eval/plot_apps.py``.

    python -m stego_torch.eval.plot_apps correspondence key=value ...
        [img_num=6] [plot_movie=true]
    python -m stego_torch.eval.plot_apps potsdam model_path=<.ckpt>
        [img_num=6]
    python -m stego_torch.eval.plot_apps pr_curves model_path=<.ckpt>
        [model_path_stego=<.ckpt>]

Each main takes the Config's keys (``config=<yaml>`` loads a base file
first) and the JAX CLI's extra keys, runs on the first CUDA device and exits
with an error where there is none; a caller asks for the CPU by passing
``device="cpu"`` (the kernels' plain versions then run). Each returns what
it computed.

Where the JAX package differs:

* ``correspondence`` runs its trunk in the Config's ``backbone_dtype`` with
  its ``use_flash_attention`` (bf16 and the kernels by default, as every
  other entry point of the port); the JAX main runs an f32 trunk whatever
  the Config says, which ``backbone_dtype=float32`` gives here;
* ``pr_curves`` draws its sample coordinates from a ``torch.Generator``
  seeded with the Config's ``seed`` (the JAX main from
  ``jax.random.PRNGKey(0)``, a stream torch cannot reproduce); a caller
  may give the coordinates instead (``coords``).
"""

from __future__ import annotations

import sys
from os.path import join
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from stego_torch.config import Config, prep_args
from stego_torch.data.contrastive import ContrastiveSegDataset
from stego_torch.data.transforms import get_transform
from stego_torch.eval.analysis import (
    correspondence_heatmaps,
    crf_kernel_fd,
    crf_module_apply,
    crf_pair_diffs,
    interpolated_query_path,
    label_agreement_fd,
    plot_correspondence_figure,
    plot_pr_curves,
    potsdam_mosaic,
    save_correspondence_gif,
    train_crf_recalibrator,
)
from stego_torch.eval.evaluate import load_model_for_eval
from stego_torch.models.vit import VIT_CONFIGS

# the JAX CLI's keys that are not Config fields
EXTRA_KEYS = ("img_num", "plot_movie", "model_path_stego")
# the reference's three query points (plot_dino_correspondence.py:119-125)
# and the movie's path through them (:156-170)
QUERY_POINTS = [[-0.1, 0.0], [0.5, 0.8], [-0.7, -0.7]]
MOVIE_KEY_POINTS = [[-0.7, -0.7], [-0.1, 0.0], [0.5, 0.8]]
PR_RES = 320  # the PR curves' image size (plot_pr_curves.py:178-180)
PR_MAX_BATCHES = 8

# (batch index, batch size) -> (coords1, coords2), each (B, S, S, 2)
CoordsFn = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]


def _cfg_from_cli(argv) -> Tuple[Config, Dict]:
    overrides = prep_args(argv)
    base = overrides.pop("config", None)
    extra = {k: overrides.pop(k) for k in list(overrides) if k in EXTRA_KEYS}
    cfg = (Config.from_yaml(base, **overrides) if base
           else Config.from_dict(overrides, strict=True))
    return cfg, extra


def _device(device: Optional[Union[str, torch.device]], app: str
            ) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise SystemExit(f"stego_torch.eval.plot_apps {app} runs on a CUDA "
                         f"device and found none; nothing was run")
    return torch.device("cuda", 0)


def correspondence_main(argv=None,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Dict:
    """Query-point correspondence figure (and with ``plot_movie`` a GIF) of
    image ``img_num`` of the train set and its first KNN neighbour, at res
    512 when ``res`` >= 512, else at ``res``. Returns {"heatmaps": (intra,
    inter), "movie": (intra, inter) or None, "written": paths}."""
    from stego_torch.train.app import build_backbone
    from stego_torch.train.segmenter import UnsupervisedSegmenter
    from stego_torch.utils.precision import full_f32_for

    cfg, extra = _cfg_from_cli(argv)
    dev = _device(device, "correspondence")
    high_res = 512 if cfg.res >= 512 else cfg.res
    dataset = ContrastiveSegDataset(
        pytorch_data_dir=cfg.pytorch_data_dir,
        dataset_name=cfg.dataset_name,
        crop_type=None,
        image_set="train",
        transform=get_transform(high_res, False, "center"),
        target_transform=get_transform(high_res, True, "center"),
        cfg=cfg, num_neighbors=2, mask=True, pos_images=True, pos_labels=True,
    )
    full_f32_for(cfg.backbone_dtype)
    vit_cfg = VIT_CONFIGS[cfg.model_type][cfg.dino_patch_size]
    gen = torch.Generator().manual_seed(cfg.seed)
    seg = UnsupervisedSegmenter(dataset.n_classes, cfg, vit_cfg=vit_cfg,
                                generator=gen)
    build_backbone(cfg, seg)
    seg.to(dev).eval()
    if seg.net.backbone_dtype == torch.bfloat16:
        seg.net.model.cast_blocks(torch.bfloat16)

    item = dataset[int(extra.get("img_num", 6)) % len(dataset)]
    img = torch.from_numpy(item["img"])[None].to(dev)
    img_pos = torch.from_numpy(item["img_pos"])[None].to(dev)
    with torch.inference_mode():
        feats1, _ = seg.net(img)
        feats2, _ = seg.net(img_pos)
    img_np, pos_np = img[0].cpu().numpy(), img_pos[0].cpu().numpy()

    result_dir = join(cfg.output_root, "results", "correspondence")
    query = np.asarray(QUERY_POINTS, np.float32).reshape(1, 3, 1, 2)
    heatmaps = correspondence_heatmaps(feats1, feats2,
                                       torch.from_numpy(query).to(dev),
                                       (high_res, high_res))
    written = plot_correspondence_figure(
        join(result_dir, "correspondence.png"), img_np, pos_np,
        *(h.cpu().numpy() for h in heatmaps), query)
    movie = None
    if extra.get("plot_movie"):
        path_pts = interpolated_query_path(MOVIE_KEY_POINTS)
        movie = correspondence_heatmaps(feats1, feats2,
                                        torch.from_numpy(path_pts).to(dev),
                                        (high_res, high_res))
        written += save_correspondence_gif(
            join(result_dir, "attention_interp.gif"), img_np, pos_np,
            *(h.cpu().numpy() for h in movie), path_pts)
    for path in written:
        print("wrote", path)
    return {"heatmaps": heatmaps, "movie": movie, "written": written}


def potsdam_main(argv=None,
                 device: Optional[Union[str, torch.device]] = None) -> Dict:
    """The Potsdam mosaic of scene ``img_num`` (``analysis.potsdam_mosaic``)
    from ``model_path``; returns its arrays."""
    cfg, extra = _cfg_from_cli(argv)
    dev = _device(device, "potsdam")
    model_path = cfg.model_path or "./saved_models/potsdam_test.ckpt"
    out = potsdam_mosaic(cfg, model_path, dev,
                         img_num=int(extra.get("img_num", 6)))
    print("wrote results/predictions/potsdam/")
    return out


def pr_curves_main(argv=None,
                   device: Optional[Union[str, torch.device]] = None,
                   coords: Optional[CoordsFn] = None) -> Dict:
    """Label-agreement PR curves: STEGO code vs the trunk's features vs the
    analytic CRF kernel and the CRF kernel trained against label agreement
    (reference plot_pr_curves.py:160-218; the MoCo row needs a converted
    ResNet checkpoint). Up to PR_MAX_BATCHES batches of ``batch_size`` val
    images at res 320, ``feature_samples`` x ``feature_samples`` points
    each side. Returns {"aps", "crf_params", "curves", "targets"}."""
    cfg, extra = _cfg_from_cli(argv)
    dev = _device(device, "pr_curves")
    dataset = ContrastiveSegDataset(
        pytorch_data_dir=cfg.pytorch_data_dir,
        dataset_name=cfg.dataset_name,
        crop_type=None,
        image_set="val",
        transform=get_transform(PR_RES, False, "center"),
        target_transform=get_transform(PR_RES, True, "center"),
        cfg=cfg, mask=True,
    )
    seg = load_model_for_eval(extra.get("model_path_stego") or cfg.model_path,
                              dev)
    s = cfg.feature_samples
    if coords is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        def coords(b, n):
            return tuple(torch.rand((n, s, s, 2), generator=gen, device=dev)
                         * 2 - 1 for _ in range(2))

    bs = max(cfg.batch_size, 1)
    n_batches = min(PR_MAX_BATCHES, len(dataset) // bs)
    names = ("stego_fd", "dino_fd", "crf_fd", "ld", "coord_diff", "img_diff")
    outs = {k: [] for k in names}
    for b in range(max(n_batches, 1)):
        items = [dataset[i] for i in range(b * bs,
                                           min((b + 1) * bs, len(dataset)))]
        img = torch.from_numpy(np.stack([it["img"] for it in items])).to(dev)
        label = torch.from_numpy(np.stack([it["label"] for it in items])) \
            .to(dev)
        c1, c2 = (c.to(dev) for c in coords(b, img.shape[0]))
        with torch.no_grad():  # the recalibrator trains on these
            feats, code = seg.net(img)
            ld, stego_fd = label_agreement_fd(code, label, seg.n_classes,
                                              c1, c2)
            _, dino_fd = label_agreement_fd(feats, label, seg.n_classes,
                                            c1, c2)
            crf = crf_kernel_fd(img, c1, c2)
            coord_diff, img_diff = crf_pair_diffs(img, c1, c2)
        for k, v in zip(names, (stego_fd, dino_fd, crf, ld, coord_diff,
                                img_diff)):
            outs[k].append(v.reshape(-1))
    cat = {k: torch.cat(v) for k, v in outs.items()}
    # the CRF kernel's six scalars trained against label agreement
    # (reference LitRecalibrator/CRFModule, plot_pr_curves.py:53-67)
    crf_params = train_crf_recalibrator(cat["coord_diff"], cat["img_diff"],
                                        cat["ld"])
    with torch.no_grad():
        learned = crf_module_apply(crf_params, cat["coord_diff"],
                                   cat["img_diff"])
    curves = {"STEGO (Ours)": cat["stego_fd"], "DINO": cat["dino_fd"],
              "CRF": cat["crf_fd"], "CRF (learned)": learned}
    curves = {k: v.cpu().numpy() for k, v in curves.items()}
    targets = cat["ld"].cpu().numpy()
    path = join(cfg.output_root, "results", "pr_curves.png")
    aps = plot_pr_curves(path, curves, targets)
    print(f"{path}: APs {aps}")
    return {"aps": aps, "crf_params": crf_params, "curves": curves,
            "targets": targets}


APPS = {"correspondence": correspondence_main, "potsdam": potsdam_main,
        "pr_curves": pr_curves_main}


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] not in APPS:
        raise SystemExit(f"usage: python -m stego_torch.eval.plot_apps "
                         f"{{{','.join(APPS)}}} key=value ...")
    APPS[args[0]](args[1:])


if __name__ == "__main__":
    main()
