"""The augmented view of the aug-alignment loss, made on the device;
counterpart of ``stego_tpu/ops/augment.py``.

The reference makes its augmented view on the host: torchvision
RandomHorizontalFlip + RandomResizedCrop on the image and on its coordinate
grid, then ColorJitter(.3, .3, .3, .1), RandomGrayscale(.2) and a Gaussian
blur on the image (reference src/train_segmentation.py:408-416,
src/data.py:557-563). The port's host route is ``data/contrastive.py``
(``device_augs=False``); this module is the device route, the JAX
package's redesign in plain PyTorch (the JAX package runs it in XLA, and
no hand kernel is owed for it):

* the flip + crop + resize is separable: per-image bilinear interpolation
  matrices with the crop box as data, applied as two batched matrix
  products;
* the coordinate grid needs no resampling: bilinear interpolation of a
  linear ramp is the ramp at the (edge-clamped) source coordinate, so
  ``coord_aug`` is written in closed form from the crop box;
* the 13-tap Gaussian blur with a per-image sigma is two banded matrices
  built from one-hot shift bands (edge-extend boundary), applied the same
  way;
* the photometric ops run on [0, 1] RGB in a per-image random order, each
  image picking its op of every slot from the four candidates.

Every random parameter is an input (:class:`GeomParams`,
:class:`PhotoParams`): :func:`sample_geometric` and
:func:`sample_photometric` draw them from a ``torch.Generator`` (the train
step's ``draw_step_randomness``), and the tests hand in the JAX package's.
The f32 matrix products must not run in TF32, whatever the caller's
settings: :func:`device_augment` turns TF32 off for its own products.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stego_torch.data.transforms import channel_stats

BLUR_HALF = 6  # 13 taps cover 3 sigma for the sampled sigma <= 2.0


class GeomParams(NamedTuple):
    flip: torch.Tensor  # (B,) bool
    top: torch.Tensor   # (B,) f32, integer-valued
    left: torch.Tensor  # (B,) f32
    ch: torch.Tensor    # (B,) f32 crop height
    cw: torch.Tensor    # (B,) f32 crop width


class PhotoParams(NamedTuple):
    order: torch.Tensor       # (B, 4) int64, a permutation of the ops
    brightness: torch.Tensor  # (B,) f32
    contrast: torch.Tensor    # (B,) f32
    saturation: torch.Tensor  # (B,) f32
    hue: torch.Tensor         # (B,) f32, in turns
    grayscale: torch.Tensor   # (B,) bool
    blur: torch.Tensor        # (B,) bool
    blur_sigma: torch.Tensor  # (B,) f32


def take_rows(p, rows: slice):
    """Rows ``rows`` of every field of a parameter tuple (a rank's part of
    the global batch's draws)."""
    return type(p)(*(f[rows] for f in p))


# ----------------------------------------------------------------------
# parameter draws (the distributions of ``augment.py:73-143``)


def _uniform(generator, shape, lo, hi):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def sample_geometric(generator: torch.Generator, b: int, h: int, w: int,
                     scale: Tuple[float, float] = (0.8, 1.0),
                     ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                     ) -> GeomParams:
    """RandomHorizontalFlip(0.5) + RandomResizedCrop's parameters, as
    torchvision draws them: 10 candidate (scale, aspect) draws, the first
    that fits wins, else the largest ratio-clamped centre crop."""
    flip = torch.rand((b,), generator=generator,
                      device=generator.device) < 0.5
    target = float(h * w) * _uniform(generator, (b, 10), scale[0], scale[1])
    aspect = torch.exp(_uniform(generator, (b, 10), math.log(ratio[0]),
                                math.log(ratio[1])))
    cw = torch.round(torch.sqrt(target * aspect))
    ch = torch.round(torch.sqrt(target / aspect))
    valid = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    first = valid.to(torch.int32).argmax(1, keepdim=True)
    any_valid = valid.any(1)

    def pick(a):
        return a.gather(1, first)[:, 0]

    cw_c, ch_c = pick(cw), pick(ch)
    u_top = pick(torch.rand((b, 10), generator=generator,
                            device=generator.device))
    u_left = pick(torch.rand((b, 10), generator=generator,
                             device=generator.device))
    top_c = torch.floor(u_top * (h - ch_c + 1))
    left_c = torch.floor(u_left * (w - cw_c + 1))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        fw, fh = float(w), float(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        fh, fw = float(h), float(round(h * ratio[1]))
    else:
        fw, fh = float(w), float(h)
    f_top, f_left = (h - fh) // 2, (w - fw) // 2

    def sel(c, f):
        return torch.where(any_valid, c, torch.full_like(c, f)).float()

    return GeomParams(flip=flip, top=sel(top_c, f_top),
                      left=sel(left_c, f_left), ch=sel(ch_c, fh),
                      cw=sel(cw_c, fw))


def sample_photometric(generator: torch.Generator, b: int,
                       brightness: float = 0.3, contrast: float = 0.3,
                       saturation: float = 0.3, hue: float = 0.1,
                       p_gray: float = 0.2, p_blur: float = 0.5
                       ) -> PhotoParams:
    """ColorJitter(.3, .3, .3, .1) + RandomGrayscale(.2) + a blur applied
    with probability one half, sigma in [0.1, 2.0]."""
    dev = generator.device

    def rand(shape):
        return torch.rand(shape, generator=generator, device=dev)

    return PhotoParams(
        order=torch.argsort(rand((b, 4)), dim=1),
        brightness=_uniform(generator, (b,), 1 - brightness, 1 + brightness),
        contrast=_uniform(generator, (b,), 1 - contrast, 1 + contrast),
        saturation=_uniform(generator, (b,), 1 - saturation, 1 + saturation),
        hue=_uniform(generator, (b,), -hue, hue),
        grayscale=rand((b,)) < p_gray,
        blur=rand((b,)) < p_blur,
        blur_sigma=_uniform(generator, (b,), 0.1, 2.0),
    )


# ----------------------------------------------------------------------
# the geometric transform


def _crop_coords(start: torch.Tensor, clen: torch.Tensor,
                 out: int) -> torch.Tensor:
    """Absolute source coordinates (B, out) of an integer crop resized with
    bilinear, ``align_corners=False`` semantics: clamped at 0 and at the
    crop's last pixel."""
    i = torch.arange(out, dtype=torch.float32, device=start.device) + 0.5
    src = i[None, :] * (clen[:, None] / out) - 0.5
    src = torch.clamp_min(src, 0.0)
    src = torch.minimum(src, clen[:, None] - 1.0)
    return start[:, None] + src


def _interp_matrix(coords: torch.Tensor, n: int) -> torch.Tensor:
    """(B, out, n) bilinear interpolation matrix of absolute coords."""
    x0 = torch.clamp(torch.floor(coords), 0, n - 1)
    x1 = torch.clamp_max(x0 + 1, n - 1)
    t = torch.clamp(coords - x0, 0.0, 1.0)
    oh0 = F.one_hot(x0.long(), n).float()
    oh1 = F.one_hot(x1.long(), n).float()
    return oh0 * (1.0 - t)[..., None] + oh1 * t[..., None]


def _apply_separable(wy: torch.Tensor, wx: torch.Tensor,
                     img: torch.Tensor) -> torch.Tensor:
    """out[b, i, j, c] = sum_h,w wy[b, i, h] wx[b, j, w] img[b, h, w, c]:
    the rows first, then the columns, as ``einsum("bih,bhwc->biwc")`` and
    ``einsum("bjw,biwc->bijc")``."""
    b, h, w, c = img.shape
    rows = torch.bmm(wy, img.reshape(b, h, w * c)).reshape(b, -1, w, c)
    return torch.matmul(wx[:, None], rows)


def apply_geometric_device(img: torch.Tensor, p: GeomParams, out_res: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip + crop-resize of a (B, H, W, C) image, and the matching
    coordinate grid (B, out, out, 2) in closed form: channels (y, x) in
    [-1, 1], the reference's grid convention (data.py:530-532)."""
    b, h, w = img.shape[:3]
    ys = _crop_coords(p.top, p.ch, out_res)
    xs = _crop_coords(p.left, p.cw, out_res)
    # the host flips, then crops: the crop indexes the flipped image, so
    # the image is read at mirrored columns
    x_img = torch.where(p.flip[:, None], (w - 1.0) - xs, xs)
    out = _apply_separable(_interp_matrix(ys, h), _interp_matrix(x_img, w),
                           img.float())
    # the grid: linear ramps at the source coordinates, the x ramp of a
    # flipped grid mirrored
    cy = -1.0 + 2.0 * ys / (h - 1.0)
    cx_plain = -1.0 + 2.0 * xs / (w - 1.0)
    cx = torch.where(p.flip[:, None], 1.0 - 2.0 * xs / (w - 1.0), cx_plain)
    coord = torch.stack([cy[:, :, None].expand(b, out_res, out_res),
                         cx[:, None, :].expand(b, out_res, out_res)], dim=-1)
    return out, coord


# ----------------------------------------------------------------------
# the photometric transforms


def grayscale(img: torch.Tensor) -> torch.Tensor:
    g = 0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return g[..., None].expand(img.shape[:-1] + (3,))


def adjust_hue(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """A hue shift of ``factor`` turns (broadcast against (B, H, W)) by an
    HSV round trip (``augment.py:_adjust_hue``)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(-1)
    minc = img.amin(-1)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros((), device=img.device)
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), zero)
    safe = torch.clamp_min(delta, 1e-12)
    rc = torch.where(delta > 0, (maxc - r) / safe, zero)
    gc = torch.where(delta > 0, (maxc - g) / safe, zero)
    bc = torch.where(delta > 0, (maxc - b) / safe, zero)
    hch = torch.where(r == maxc, bc - gc,
                      torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    hch = (hch / 6.0) % 1.0
    hch = (hch + factor) % 1.0
    i = torch.floor(hch * 6.0)
    f = hch * 6.0 - i
    pp = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.long() % 6
    choices = torch.stack([
        torch.stack([v, t, pp], -1), torch.stack([q, v, pp], -1),
        torch.stack([pp, v, t], -1), torch.stack([pp, q, v], -1),
        torch.stack([t, pp, v], -1), torch.stack([v, pp, q], -1),
    ], 0)
    index = i[None, ..., None].expand((1,) + i.shape + (3,))
    return choices.gather(0, index)[0]


@functools.lru_cache(maxsize=8)
def _shift_bands_np(n: int) -> np.ndarray:
    """(2 BLUR_HALF + 1, n, n) one-hot shift matrices, edge-extended (taps
    past an edge land on the edge pixel)."""
    bands = np.zeros((2 * BLUR_HALF + 1, n, n), dtype=np.float32)
    rows = np.arange(n)
    for d in range(-BLUR_HALF, BLUR_HALF + 1):
        np.add.at(bands[d + BLUR_HALF], (rows, np.clip(rows + d, 0, n - 1)),
                  1.0)
    return bands


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 13-tap Gaussian blur with a per-image sigma, as two banded
    matrices (edge-extended)."""
    b, h, w = img.shape[:3]
    d = torch.arange(-BLUR_HALF, BLUR_HALF + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-0.5 * (d[None, :] / torch.clamp_min(sigma[:, None], 1e-6))
                  ** 2)
    k = k / k.sum(1, keepdim=True)  # (B, 13)

    def band(n):
        bands = torch.from_numpy(_shift_bands_np(n)).to(img.device)
        return (k @ bands.reshape(len(d), n * n)).reshape(b, n, n)

    return _apply_separable(band(h), band(w), img)


def apply_photometric_device(img: torch.Tensor,
                             p: PhotoParams) -> torch.Tensor:
    """ColorJitter in a per-image random order, grayscale and blur on a
    (B, H, W, C) [0, 1] image (``augment.py:250-285``). A fourth channel
    (Potsdam's IR) skips the colour ops and is blurred with the rest."""
    def bb(a):
        return a[:, None, None, None]

    extra = None
    if img.shape[-1] > 3:
        img, extra = img[..., :3], img[..., 3:]

    def bright(x):
        return torch.clamp(x * bb(p.brightness), 0, 1)

    def contrast(x):
        mean = grayscale(x).mean(dim=(1, 2, 3), keepdim=True)
        return torch.clamp(mean + bb(p.contrast) * (x - mean), 0, 1)

    def saturate(x):
        g = grayscale(x)
        return torch.clamp(g + bb(p.saturation) * (x - g), 0, 1)

    def hue(x):
        return torch.clamp(adjust_hue(x, p.hue[:, None, None]), 0, 1)

    for slot in range(4):
        cands = torch.stack([f(img) for f in (bright, contrast, saturate,
                                              hue)], 0)
        index = p.order[:, slot].long()[None, :, None, None, None]
        img = cands.gather(0, index.expand((1,) + img.shape))[0]
    img = torch.where(bb(p.grayscale), grayscale(img), img)
    if extra is not None:
        img = torch.cat([img, extra], dim=-1)
    return torch.where(bb(p.blur), gaussian_blur(img, p.blur_sigma), img)


@contextlib.contextmanager
def _full_f32():
    """The block's f32 matrix products in full f32 on the card: TF32 off
    for them, the caller's setting restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def device_augment(img_normalized: torch.Tensor, geom: GeomParams,
                   photo: PhotoParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """(img_aug, coord_aug) of an ImageNet-normalised (B, H, W, C) batch at
    the given parameters (``augment.py:312``): unnormalise and clip to
    [0, 1], flip + crop-resize to H, the photometric ops on the clipped
    result, normalise again."""
    h = img_normalized.shape[1]
    mean, std = (torch.as_tensor(s, device=img_normalized.device)
                 for s in channel_stats(img_normalized.shape[-1]))
    with _full_f32():
        img01 = torch.clamp(img_normalized.float() * std + mean, 0, 1)
        img_aug, coord_aug = apply_geometric_device(img01, geom, out_res=h)
        img_aug = apply_photometric_device(torch.clamp(img_aug, 0, 1), photo)
    return (img_aug - mean) / std, coord_aug
