"""Dense-CRF mean-field refinement on a grid; counterpart of
``stego_tpu/ops/crf.py`` (replaces pydensecrf).

Behavioral reference: src/crf.py — unary from bilinear-upsampled softmax
logits, a Gaussian pairwise term (sxy=1, compat=3) and a bilateral term
(sxy=67, srgb=3, compat=4) on the unnormalized image, 10 mean-field
iterations. The JAX package's design, kept here with its constants and
rounding points:

* the Gaussian term (sigma 1) is a separable filter, two banded matrix
  products over a channel-major (B, C, H, W) belief, its self-interaction
  removed;
* the bilateral term (sigma_xy 67, sigma_rgb 3) is a dense M x M product on
  a grid pooled by ``BILATERAL_STRIDE`` (M = 1600 at res 320): belief and
  guidance are pooled by an antialiased bilinear resize (a triangle filter
  as wide as the stride, which is what ``jax.image.resize(..., "linear")``
  does when it shrinks; a 2 x 2 bilinear tap or an average pool is not the
  same function, and the sharp sigma_rgb makes the difference show), and
  the messages come back by plain bilinear upsampling.

f32 throughout. The products are ``torch.einsum`` in f32; TF32 stays as
torch's matmul default leaves it (off), and nothing here changes it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# Parameter parity with reference src/crf.py:13-19
MAX_ITER = 10
POS_W = 3.0
POS_XY_STD = 1.0
BI_W = 4.0
BI_XY_STD = 67.0
BI_RGB_STD = 3.0

BILATERAL_STRIDE = 8


def _gaussian_kernel_1d(std: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2 * std**2))
    return k.astype(np.float32)


def _banded_gaussian_matrix(n: int, std: float) -> np.ndarray:
    """(n, n) banded Gaussian convolution matrix (zero boundary, SAME conv)."""
    radius = max(1, int(2 * std + 0.5))
    k = _gaussian_kernel_1d(std, radius)
    m = np.zeros((n, n), dtype=np.float32)
    rows = np.arange(n)
    for d in range(-radius, radius + 1):
        cols = rows + d
        ok = (cols >= 0) & (cols < n)
        m[rows[ok], cols[ok]] = k[d + radius]
    return m


def _spatial_filter_cm(q: torch.Tensor, std: float) -> torch.Tensor:
    """Separable Gaussian over channel-major (B, C, H, W) as two banded
    matrix products, self-interaction removed."""
    h, w = q.shape[-2:]
    mh = torch.from_numpy(_banded_gaussian_matrix(h, std)).to(q)
    mw = torch.from_numpy(_banded_gaussian_matrix(w, std)).to(q)
    out = torch.einsum("ih,bchw->bciw", mh, q)
    out = torch.einsum("jw,bciw->bcij", mw, out)
    return out - q  # remove self-interaction (k(0,0) = 1)


def pool(x: torch.Tensor, hw) -> torch.Tensor:
    """Shrink channel-major (B, C, H, W) ``x`` to ``hw`` as
    ``jax.image.resize(..., "linear")`` does: bilinear with the antialiasing
    triangle filter."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)


def bilateral_kernel(image01: torch.Tensor,
                     stride: int = BILATERAL_STRIDE) -> torch.Tensor:
    """(B, M, M) dense bilateral kernel on the stride-pooled grid of the
    (B, H, W, 3) image in [0, 1]. It depends only on the image: the
    mean-field loop, and every logit set refined over the same image,
    share it."""
    b, h, w, _ = image01.shape
    hc, wc = h // stride, w // stride
    image = image01 * 255.0
    img_c = pool(image.permute(0, 3, 1, 2), (hc, wc))

    dev, dt = image.device, image.dtype
    ys = (torch.arange(hc, dtype=dt, device=dev) + 0.5) * stride
    xs = (torch.arange(wc, dtype=dt, device=dev) + 0.5) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pos = torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=-1)  # (M, 2)

    feat = img_c.permute(0, 2, 3, 1).reshape(b, hc * wc, 3)
    d_pos = torch.sum(torch.square(pos[:, None, :] - pos[None, :, :]), dim=-1)
    d_rgb = torch.sum(
        torch.square(feat[:, :, None, :] - feat[:, None, :, :]), dim=-1)
    kern = torch.exp(
        -d_pos[None] / (2 * BI_XY_STD**2) - d_rgb / (2 * BI_RGB_STD**2))
    # remove (coarse) self-interaction
    return kern * (1.0 - torch.eye(hc * wc, dtype=dt, device=dev)[None])


def _bilateral_filter_coarse_cm(q: torch.Tensor, kern: torch.Tensor,
                                stride: int) -> torch.Tensor:
    """Dense bilateral message on a stride-pooled grid, channel-major:
    q (B, C, H, W) beliefs, kern (B, M, M) from :func:`bilateral_kernel`;
    returns (B, C, H, W) messages."""
    b, c, h, w = q.shape
    hc, wc = h // stride, w // stride
    q_c = pool(q, (hc, wc)) * (stride * stride)
    qf = q_c.reshape(b, c, hc * wc)
    msg = torch.einsum("bmn,bcn->bcm", kern, qf)
    msg = msg.reshape(b, c, hc, wc)
    return F.interpolate(msg, size=(h, w), mode="bilinear",
                         align_corners=False)


def dense_crf(image01: torch.Tensor, logits: torch.Tensor,
              n_iter: int = MAX_ITER,
              kern: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-field dense CRF.

    Args:
      image01: (B, H, W, 3) unnormalized RGB in [0, 1] (scaled by 255, the
        reference's pydensecrf input scale; the kernel is isotropic in
        colour, so RGB and BGR give the same result).
      logits: (B, h, w, C) class logits at any resolution (bilinearly
        upsampled to the image size, as reference crf.py:27-29).
      kern: :func:`bilateral_kernel` of ``image01``, when the caller
        refines several logit sets over one image.
    Returns:
      (B, H, W, C) refined class probabilities, f32 (f64 for f64
      logits).
    """
    b, h, w, _ = image01.shape
    # f32 (f64 inputs stay f64, as a reference for the tests)
    dtype = torch.float64 if logits.dtype == torch.float64 else torch.float32
    image01 = image01.to(dtype)
    # channel-major (B, C, H, W) throughout the loop
    lc = logits.to(dtype).permute(0, 3, 1, 2)
    if tuple(lc.shape[2:]) != (h, w):
        lc = F.interpolate(lc, size=(h, w), mode="bilinear",
                           align_corners=False)
    unary = torch.log_softmax(lc, dim=1)

    q = torch.softmax(unary, dim=1)
    if kern is None:
        kern = bilateral_kernel(image01, BILATERAL_STRIDE)
    for _ in range(n_iter):
        sp = _spatial_filter_cm(q, POS_XY_STD)
        bi = _bilateral_filter_coarse_cm(q, kern, BILATERAL_STRIDE)
        # Potts model: higher agreement with neighbors -> higher logit
        pairwise = POS_W * sp + BI_W * bi
        q = torch.softmax(unary + pairwise, dim=1)
    return q.permute(0, 2, 3, 1)
