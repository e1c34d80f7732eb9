"""Host-side image and label transforms; counterpart of
``stego_tpu/data/transforms.py``.

Reference semantics (src/utils.py:128-183):
* ``get_transform`` resizes with **NEAREST even for images**, a quirk the
  reference's parity depends on, reproduced through PIL;
* an int ``res`` resizes the short side keeping the aspect (PIL and
  torchvision semantics); ``crop_type=None`` resizes to the exact (res, res)
  square;
* images become f32 HWC in [0, 1], then ImageNet-normalized; labels int64
  HW.

The paired geometric and photometric augmentations (reference
train_segmentation.py:408-416) draw their parameters from explicit numpy
Generators: one parameter set applied to the image and to its coordinate
grid alike. Photometric jitter works on unnormalized [0, 1] RGB.

PIL is imported inside the functions that decode, resize or blur, never at
module import, so that the port imports where PIL is missing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np

from stego_torch.ops.interp import _weight_matrix

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
# 4th (near-IR, potsdam_ir=true) channel: the red channel's statistics
CHANNEL_MEAN4 = np.concatenate([IMAGENET_MEAN, IMAGENET_MEAN[:1]])
CHANNEL_STD4 = np.concatenate([IMAGENET_STD, IMAGENET_STD[:1]])


def channel_stats(c: int):
    """(mean, std) for a C-channel image (C == 3 or 4)."""
    return CHANNEL_MEAN4[:c], CHANNEL_STD4[:c]


def normalize(img: np.ndarray) -> np.ndarray:
    """[0,1] HWC float -> ImageNet-normalized (3- or 4-channel)."""
    mean, std = channel_stats(img.shape[-1])
    return (img - mean) / std


def unnormalize(img: np.ndarray) -> np.ndarray:
    mean, std = channel_stats(img.shape[-1])
    return img * std + mean


def _resize_short_side(img, res: Union[int, Tuple[int, int]], resample):
    """PIL image resized to ``res``: a (h, w) tuple exactly, an int on its
    short side."""
    if isinstance(res, tuple):
        return img.resize((res[1], res[0]), resample)  # PIL takes (w, h)
    w, h = img.size
    if (w <= h and w == res) or (h <= w and h == res):
        return img
    if w < h:
        ow = res
        oh = int(res * h / w)
    else:
        oh = res
        ow = int(res * w / h)
    return img.resize((ow, oh), resample)


def _center_crop(arr: np.ndarray, res: int, fill) -> np.ndarray:
    """Crop (or zero-pad) to (res, res) around the center, torch CenterCrop
    semantics."""
    h, w = arr.shape[:2]
    if h < res or w < res:
        pad_h, pad_w = max(res - h, 0), max(res - w, 0)
        pads = [(pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2)]
        if arr.ndim == 3:
            pads.append((0, 0))
        arr = np.pad(arr, pads, constant_values=fill)
        h, w = arr.shape[:2]
    top = (h - res) // 2
    left = (w - res) // 2
    return arr[top:top + res, left:left + res]


def _random_crop(arr: np.ndarray, res: int, fill, rng: np.random.Generator
                 ) -> np.ndarray:
    h, w = arr.shape[:2]
    if h < res or w < res:
        return _center_crop(arr, res, fill)
    top = int(rng.integers(0, h - res + 1))
    left = int(rng.integers(0, w - res + 1))
    return arr[top:top + res, left:left + res]


@dataclass
class Transform:
    """get_transform parity (src/utils.py:165-183).

    Takes a PIL Image or a file *path*. A path goes through the native
    fused decoder (``data/native_io.py``: only the scanlines the NEAREST
    resize keeps are decoded, crop and normalization fused, the GIL
    released) and falls back to the PIL pipeline below for anything the
    decoder does not take; both give the same arrays. ``force_rgb`` is the
    dataset-level ``Image.open(...).convert("RGB")`` of the reference
    (data.py:264 etc.).
    """

    res: int
    is_label: bool
    crop_type: Optional[str]  # "center" | "random" | None
    # fast_decode=True (config key): allow DCT-scaled JPEG decode in the
    # native path: faster, not PIL's values (never applies to labels)
    fast_decode: bool = False

    def __call__(self, img, rng: Optional[np.random.Generator] = None,
                 force_rgb: bool = False) -> np.ndarray:
        from PIL import Image

        if isinstance(img, str):
            from stego_torch.data.native_io import decode_transform_path

            arr = decode_transform_path(
                img, self.res, self.crop_type, self.is_label, rng, force_rgb,
                fast=self.fast_decode,
            )
            if arr is not None:
                return arr
            img = Image.open(img)
        if force_rgb and img.mode != "RGB":
            img = img.convert("RGB")
        size: Union[int, Tuple[int, int]] = (
            (self.res, self.res) if self.crop_type is None else self.res
        )
        img = _resize_short_side(img, size, Image.NEAREST)
        if self.is_label:
            arr = np.asarray(img).astype(np.int64)
            if arr.ndim == 3:
                arr = arr[..., 0]
            fill = 0
        else:
            if img.mode not in ("RGB", "RGBA"):  # RGBA carries Potsdam IR
                img = img.convert("RGB")
            arr = np.asarray(img).astype(np.float32) / 255.0
            fill = 0.0
        if self.crop_type == "center":
            arr = _center_crop(arr, self.res, fill)
        elif self.crop_type == "random":
            arr = _random_crop(arr, self.res, fill,
                               rng or np.random.default_rng())
        elif self.crop_type is not None:
            raise ValueError(f"Unknown Cropper {self.crop_type}")
        if not self.is_label:
            arr = normalize(arr)
        return arr


def get_transform(res: int, is_label: bool, crop_type: Optional[str],
                  fast_decode: bool = False) -> Transform:
    return Transform(res=res, is_label=is_label, crop_type=crop_type,
                     fast_decode=fast_decode and not is_label)


# ----------------------------------------------------------------------
# Paired geometric + photometric augmentation


@dataclass
class GeometricParams:
    flip: bool
    crop_box: Tuple[int, int, int, int]  # top, left, h, w
    out_res: int


def sample_geometric_params(
    rng: np.random.Generator, h: int, w: int, out_res: int,
    scale: Tuple[float, float] = (0.8, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> GeometricParams:
    """RandomHorizontalFlip + RandomResizedCrop parameter sampling
    (torchvision semantics: 10 tries then center fallback)."""
    flip = bool(rng.random() < 0.5)
    area = h * w
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = float(np.exp(rng.uniform(*log_ratio)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return GeometricParams(flip, (top, left, ch, cw), out_res)
    # fallback: largest center crop within ratio bounds
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    top, left = (h - ch) // 2, (w - cw) // 2
    return GeometricParams(flip, (top, left, ch, cw), out_res)


def resize_bilinear_np(arr: np.ndarray, out_hw) -> np.ndarray:
    """Host-side bilinear resize (torch align_corners=False semantics) as two
    numpy matmuls; augmentation crops vary in shape sample to sample."""
    h, w = arr.shape[:2]
    wh = _weight_matrix(out_hw[0], h, "bilinear", False)
    ww = _weight_matrix(out_hw[1], w, "bilinear", False)
    squeeze = arr.ndim == 2
    a = arr[..., None] if squeeze else arr
    out = np.einsum("ih,hwc->iwc", wh, a.astype(np.float32))
    out = np.einsum("jw,iwc->ijc", ww, out)
    return out[..., 0] if squeeze else out


def apply_geometric(arr: np.ndarray, p: GeometricParams) -> np.ndarray:
    """Apply flip + resized-crop to an HWC float array (bilinear resize)."""
    if p.flip:
        arr = arr[:, ::-1]
    top, left, ch, cw = p.crop_box
    crop = np.ascontiguousarray(arr[top:top + ch, left:left + cw])
    return resize_bilinear_np(crop, (p.out_res, p.out_res))


def _rgb_to_grayscale(img: np.ndarray) -> np.ndarray:
    g = 0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return np.repeat(g[..., None], 3, axis=-1)


def _adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """Shift hue by ``factor`` (in turns) via a vectorized HSV round-trip on
    [0,1] RGB."""
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    rc = np.where(delta > 0, (maxc - img[..., 0]) / np.maximum(delta, 1e-12), 0)
    gc = np.where(delta > 0, (maxc - img[..., 1]) / np.maximum(delta, 1e-12), 0)
    bc = np.where(delta > 0, (maxc - img[..., 2]) / np.maximum(delta, 1e-12), 0)
    h = np.where(
        img[..., 0] == maxc, bc - gc,
        np.where(img[..., 1] == maxc, 2.0 + rc - bc, 4.0 + gc - rc),
    )
    h = (h / 6.0) % 1.0
    h = (h + factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(np.int32) % 6
    choices = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1),
    ], 0)
    return np.take_along_axis(
        choices, i[None, ..., None].repeat(3, -1), axis=0
    )[0]


@dataclass
class PhotometricParams:
    order: np.ndarray
    brightness: Optional[float]
    contrast: Optional[float]
    saturation: Optional[float]
    hue: Optional[float]
    grayscale: bool
    blur_sigma: Optional[float]


def sample_photometric_params(
    rng: np.random.Generator,
    brightness: float = 0.3, contrast: float = 0.3, saturation: float = 0.3,
    hue: float = 0.1, p_gray: float = 0.2, p_blur: float = 0.5,
) -> PhotometricParams:
    """ColorJitter(.3,.3,.3,.1) + RandomGrayscale(.2) + RandomApply(GaussianBlur)
    parameters (reference train_segmentation.py:412-416)."""
    return PhotometricParams(
        order=rng.permutation(4),
        brightness=float(rng.uniform(1 - brightness, 1 + brightness)),
        contrast=float(rng.uniform(1 - contrast, 1 + contrast)),
        saturation=float(rng.uniform(1 - saturation, 1 + saturation)),
        hue=float(rng.uniform(-hue, hue)),
        grayscale=bool(rng.random() < p_gray),
        blur_sigma=float(rng.uniform(0.1, 2.0)) if rng.random() < p_blur else None,
    )


def apply_photometric(img01: np.ndarray, p: PhotometricParams) -> np.ndarray:
    """Apply jitter to an HWC [0,1] image. 4-channel (Potsdam IR) inputs:
    color ops apply to the RGB slice, blur to all channels."""
    img, extra = img01, None
    if img.shape[-1] > 3:
        img, extra = img01[..., :3], img01[..., 3:]
    for op in p.order:
        if op == 0 and p.brightness is not None:
            img = np.clip(img * p.brightness, 0, 1)
        elif op == 1 and p.contrast is not None:
            mean = _rgb_to_grayscale(img).mean()
            img = np.clip(mean + p.contrast * (img - mean), 0, 1)
        elif op == 2 and p.saturation is not None:
            gray = _rgb_to_grayscale(img)
            img = np.clip(gray + p.saturation * (img - gray), 0, 1)
        elif op == 3 and p.hue is not None:
            img = np.clip(_adjust_hue(img, p.hue), 0, 1)
    if p.grayscale:
        img = _rgb_to_grayscale(img)
    if extra is not None:
        img = np.concatenate([img, extra], axis=-1)
    if p.blur_sigma is not None:
        from PIL import Image, ImageFilter

        mode = "RGBA" if img.shape[-1] == 4 else None
        pil = Image.fromarray((img * 255).astype(np.uint8), mode=mode)
        pil = pil.filter(ImageFilter.GaussianBlur(radius=p.blur_sigma))
        img = np.asarray(pil).astype(np.float32) / 255.0
    return img


def make_coord_grid(h: int, w: int) -> np.ndarray:
    """(H, W, 2) grid with channels (y, x) in [-1, 1], matching the reference's
    meshgrid construction (data.py:530-532)."""
    ys = np.linspace(-1, 1, h, dtype=np.float32)
    xs = np.linspace(-1, 1, w, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gy, gx], axis=-1)
