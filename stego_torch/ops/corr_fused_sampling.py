"""Sampled contrastive-correlation loss with the sampling fused into the
kernel (kernel C1, forward and backward); counterpart of
``stego_tpu/ops/pallas_corr_fused_sampling.py``.

Per step the loss bilinearly samples the feature and code maps at S random
points per image, l2-normalizes the samples and correlates them over
G = 2 + neg pair slots per image: the image with itself, with its KNN
positive, and with ``neg`` other images of the batch (``perms``). Each slot
contributes the row sums of ``ops/corr_stream.py:finalize``; there is one
group (one pointwise fd mean) per slot type.

* :func:`sampled_corr_plain` is the plain PyTorch version: the (S, H*W)
  bilinear weight matrices (``ops/sampling.py``), with the kernel's rounding
  points: weights cast to ``feat_dtype`` for the features, f32
  accumulation, the sampled features rounded to ``feat_dtype`` before the
  f32 normalize, fd from ``feat_dtype`` values with f32 accumulation; the
  code side f32 throughout. Autograd gives its backward.
* :func:`sampled_corr_fused` dispatches by device: CPU tensors go to the
  plain version, CUDA tensors to ``csrc/corr_sampled.cu`` through a
  ``torch.autograd.Function`` whose forward and backward are the kernel's
  two entries, or raise. Gradients flow to the code maps only; the features
  are detached, as on the TPU (:377-379).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from stego_torch.kernels import build
from stego_torch.ops.corr_stream import (clamp_bounds, device_vector,
                                         finalize)
from stego_torch.ops.math import l2_normalize
from stego_torch.ops.sampling import bilinear_sample_weights

# What the CUDA kernel is built for (csrc/corr_sampled.cu): feature
# channels up to ViT-B's 768; any number of code channels (in chunks of 96)
# and samples (in tiles of SAMPLE_TILE on both sides).
MAX_FEAT_CHANNELS = 768
SAMPLE_TILE = 128
# Launches of the CUDA kernel's two entries in this process (plain-version
# calls do not count). Read and reset by chip_smoke.py to show the main path
# used them.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def _check_groups(b: int, neg: int, n_shifts: int) -> None:
    if neg and b < 2:
        raise ValueError(
            f"a negative pair needs another image of the batch to draw from; "
            f"got batch {b} with {neg} negative samples (a 1-image batch's "
            f"only derangement is itself)")
    if n_shifts != 2 + neg:
        raise ValueError(f"{n_shifts} shifts for {2 + neg} groups")


def _grid(coords: torch.Tensor) -> torch.Tensor:
    """(B, S1, S2, 2) coords -> the reference's transposed sampling grid
    (B, S2, S1, 2) (src/modules.py:287, ``pallas_corr_fused_sampling.py:
    439-441``)."""
    return coords.transpose(1, 2)


def sampled_products_plain(
    orig_feats: torch.Tensor,
    orig_feats_pos: torch.Tensor,
    orig_code: torch.Tensor,
    orig_code_pos: torch.Tensor,
    coords1: torch.Tensor,
    coords2: torch.Tensor,
    perms: Sequence[torch.Tensor],
    feat_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version's products of every slot: (fd, cd), each
    (G*B, S, S) f32, group-major (slot g * B + b), differentiable in the
    code maps; the kernel's forward leaves the same fd, slot-major, for its
    backward."""
    b, h, w, cf = orig_feats.shape
    cc = orig_code.shape[-1]
    g = 2 + len(perms)
    hw = h * w
    w1 = bilinear_sample_weights((h, w), _grid(coords1))   # (B, S, HW) f32
    w2 = bilinear_sample_weights((h, w), _grid(coords2))
    f = torch.cat([orig_feats, orig_feats_pos]).detach() \
        .reshape(2 * b, hw, cf).to(feat_dtype)
    c = torch.cat([orig_code, orig_code_pos]).reshape(2 * b, hw, cc).float()
    bf16 = feat_dtype == torch.bfloat16

    def sample_feats(wm, ft):
        z = torch.bmm(wm.to(feat_dtype).float(), ft.float())
        if bf16:
            z = z.to(feat_dtype).float()
        return l2_normalize(z).to(feat_dtype)

    # side 2 of every slot, group-major (g, b): self, positive, negatives
    ar = torch.arange(b, device=c.device)
    src = torch.cat([ar, ar + b] + [p.to(c.device).long() for p in perms])
    w_side2 = torch.cat([w1] + [w2] * (g - 1))
    z1f = sample_feats(w1, f[:b])                              # (B, S, cf)
    z1cn = l2_normalize(torch.bmm(w1, c[:b]))                  # (B, S, cc)
    z2fn = sample_feats(w_side2, f[src])                       # (G*B, S, cf)
    z2cn = l2_normalize(torch.bmm(w_side2, c[src]))            # (G*B, S, cc)
    fd = torch.bmm(z1f.float().repeat(g, 1, 1), z2fn.float().transpose(1, 2))
    cd = torch.bmm(z1cn.repeat(g, 1, 1), z2cn.transpose(1, 2))
    return fd, cd


def sampled_corr_plain(
    orig_feats: torch.Tensor,
    orig_feats_pos: torch.Tensor,
    orig_code: torch.Tensor,
    orig_code_pos: torch.Tensor,
    coords1: torch.Tensor,
    coords2: torch.Tensor,
    perms: Sequence[torch.Tensor],
    shifts: Sequence[float],
    pointwise: bool = True,
    zero_clamp: bool = True,
    stabalize: bool = False,
    feat_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (losses (G,), cd_means (G,)), differentiable in
    the code maps."""
    b, g = orig_feats.shape[0], 2 + len(perms)
    _check_groups(b, len(perms), len(shifts))
    fd, cd = sampled_products_plain(orig_feats, orig_feats_pos, orig_code,
                                    orig_code_pos, coords1, coords2, perms,
                                    feat_dtype)
    s = fd.shape[-1]
    lo, hi = clamp_bounds(zero_clamp, stabalize)
    cdc = torch.clamp(cd, lo, hi)

    def rows(t):
        return t.sum(-1).reshape(g, b, s)

    losses, cd_means, _ = finalize(rows(cdc * fd), rows(cdc), rows(fd),
                                   rows(cd), shifts, pointwise)
    return losses, cd_means


def sampled_corr_fused(
    orig_feats: torch.Tensor,
    orig_feats_pos: torch.Tensor,
    orig_code: torch.Tensor,
    orig_code_pos: torch.Tensor,
    coords1: torch.Tensor,
    coords2: torch.Tensor,
    perms: Sequence[torch.Tensor],
    shifts: Sequence[float],
    pointwise: bool = True,
    zero_clamp: bool = True,
    stabalize: bool = False,
    feat_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Three-pair sampled correlation loss.

    NHWC maps (B, H, W, C), ``coords*`` (B, S1, S2, 2) in [-1, 1] in torch
    (x, y) order, ``perms`` the negatives' batch permutations (each (B,)
    int), ``shifts`` one per group (2 + len(perms)). Returns
    (losses (G,), cd_means (G,)), each the mean over its group's
    B * S * S elements, as ``pallas_corr_fused_sampling.py:sampled_corr_fused``.
    On a CUDA device ``feat_dtype`` is bf16 (a bf16 trunk) or f32 (an f32
    trunk): the kernel has an instantiation for each."""
    if orig_code.device.type == "cpu":
        return sampled_corr_plain(orig_feats, orig_feats_pos, orig_code,
                                  orig_code_pos, coords1, coords2, perms,
                                  shifts, pointwise, zero_clamp, stabalize,
                                  feat_dtype)
    _check_groups(orig_feats.shape[0], len(perms), len(shifts))
    return _SampledCorr.apply(orig_code, orig_code_pos, orig_feats,
                              orig_feats_pos, coords1, coords2, tuple(perms),
                              tuple(float(x) for x in shifts),
                              bool(pointwise), bool(zero_clamp),
                              bool(stabalize), feat_dtype)


def kernel_fd(losses: torch.Tensor) -> torch.Tensor:
    """The fd that the kernel's forward computed for ``losses`` (kept on
    their autograd node for the backward), group-major (G*B, S, S) as
    :func:`sampled_products_plain` gives it."""
    fd = losses.grad_fn.saved_tensors[4]
    b, g, s = losses.grad_fn.static[0], losses.grad_fn.static[5], \
        fd.shape[-1]
    return fd.reshape(b, g, s, s).transpose(0, 1).reshape(g * b, s, s)


def _flat(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, h, w, c = t.shape
    return t.detach().to(dtype).reshape(b, h * w, c).contiguous()


class _SampledCorr(torch.autograd.Function):
    """Kernel C1 as an autograd function of the two code maps."""

    @staticmethod
    def forward(ctx, code, code_pos, feats, feats_pos, coords1, coords2,
                perms, shifts, pointwise, zero_clamp, stabalize, feat_dtype):
        dev = code.device
        b, h, w, cf = feats.shape
        cc = code.shape[-1]
        s = coords1.shape[1] * coords1.shape[2]
        g = 2 + len(perms)
        if feat_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(
                f"kernel C1 samples bf16 or f32 features (the trunk's "
                f"feat_dtype); got feat_dtype {feat_dtype}")
        tensors = {"code": code, "code_pos": code_pos, "feats": feats,
                   "feats_pos": feats_pos, "coords1": coords1,
                   "coords2": coords2}
        for name, t in tensors.items():
            if t.device != dev:
                raise ValueError(f"kernel C1 needs {name} on {dev}, got "
                                 f"{t.device}")
        for name in ("feats", "feats_pos"):
            if tensors[name].shape != (b, h, w, cf):
                raise ValueError(f"{name} shape {tuple(tensors[name].shape)}"
                                 f" != {(b, h, w, cf)}")
        for name in ("code", "code_pos"):
            if tensors[name].shape != (b, h, w, cc):
                raise ValueError(f"{name} shape {tuple(tensors[name].shape)}"
                                 f" != {(b, h, w, cc)}")
        for name in ("coords1", "coords2"):
            if tensors[name].shape != coords1.shape \
                    or coords1.shape[0] != b or coords1.shape[-1] != 2:
                raise ValueError(f"{name} must be (B, S1, S2, 2) with B={b}; "
                                 f"got {tuple(tensors[name].shape)}")
        if cf > MAX_FEAT_CHANNELS:
            raise ValueError(f"kernel C1 takes <= {MAX_FEAT_CHANNELS} "
                             f"feature channels; got {cf}")
        f1, f2 = _flat(feats, feat_dtype), _flat(feats_pos, feat_dtype)
        c1, c2 = _flat(code, torch.float32), _flat(code_pos, torch.float32)
        grid1 = _grid(coords1).float().reshape(b, s, 2).contiguous()
        grid2 = _grid(coords2).float().reshape(b, s, 2).contiguous()
        if perms:
            perm = torch.stack([p.to(device=dev, dtype=torch.int32).reshape(b)
                                for p in perms]).contiguous()
        else:
            perm = torch.zeros(1, dtype=torch.int32, device=dev)
        tiles = -(-s // SAMPLE_TILE)
        acc = torch.empty((b * g, tiles, 5, s), dtype=torch.float32,
                          device=dev)
        z2cn = torch.empty((b * g, s, cc), dtype=torch.float32, device=dev)
        fd = torch.empty((b * g, s, s), dtype=torch.float32, device=dev)
        lo, hi = clamp_bounds(zero_clamp, stabalize)
        err = build.library().stego_corr_sampled_fwd(
            f1.data_ptr(), f2.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            grid1.data_ptr(), grid2.data_ptr(), perm.data_ptr(),
            acc.data_ptr(), z2cn.data_ptr(), fd.data_ptr(), b, h, w, cf, cc,
            s, g, int(feat_dtype == torch.float32), lo, hi, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "corr_sampled forward kernel")
        global FWD_LAUNCHES
        FWD_LAUNCHES += 1
        # each row's sums over the sample tiles of side 2 (in tile order);
        # the side-2 code norms are in tile 0
        if tiles == 1:
            acc = acc[:, 0]
        else:
            acc = torch.cat([acc[:, :, :4].sum(1), acc[:, 0, 4:]], 1)
        # slot-major (b, g) rows -> group-major (g, b)
        accg = acc.reshape(b, g, 5, s).transpose(0, 1)
        losses, cd_means, gm = finalize(accg[:, :, 0], accg[:, :, 1],
                                        accg[:, :, 2], accg[:, :, 3],
                                        shifts, pointwise)
        ctx.save_for_backward(grid1, grid2, perm, z2cn, fd, acc, gm)
        ctx.static = (b, h, w, cc, s, g, shifts, pointwise, lo, hi)
        return losses, cd_means

    @staticmethod
    def backward(ctx, g_losses, g_cdms):
        grid1, grid2, perm, z2cn, fd, acc, gm = ctx.saved_tensors
        b, h, w, cc, s, g, shifts, pointwise, lo, hi = ctx.static
        dev = z2cn.device
        inv_m = torch.full((g,), 1.0 / (b * s * s), dtype=torch.float32,
                           device=dev)
        shift = device_vector(shifts, dev)
        scal = torch.stack([g_losses.float(), g_cdms.float(), gm, shift,
                            inv_m], dim=1).contiguous()          # (G, 5)
        tiles = -(-s // SAMPLE_TILE)
        dz = torch.empty((b * g, tiles, 2, s, cc), dtype=torch.float32,
                         device=dev)
        dcode = torch.zeros((b, h * w, cc), dtype=torch.float32, device=dev)
        dcode_pos = torch.zeros_like(dcode)
        err = build.library().stego_corr_sampled_bwd(
            grid1.data_ptr(), grid2.data_ptr(), perm.data_ptr(),
            z2cn.data_ptr(), fd.data_ptr(), acc.data_ptr(), scal.data_ptr(),
            dz.data_ptr(), dcode.data_ptr(), dcode_pos.data_ptr(), b, h, w,
            cc, s, g, lo, hi, int(pointwise), 1.0 / s, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "corr_sampled backward kernel")
        global BWD_LAUNCHES
        BWD_LAUNCHES += 1
        return (dcode.reshape(b, h, w, cc), dcode_pos.reshape(b, h, w, cc),
                None, None, None, None, None, None, None, None, None, None)
