"""Sampled contrastive-correlation loss with the sampling on the card
(kernel C1, forward and backward); counterpart of
``stego_tpu/ops/pallas_corr_fused_sampling.py``.

Per step the loss bilinearly samples the feature and code maps at S random
points per image, l2-normalizes the samples and correlates them over
G = 2 + neg pair slots per image: the image with itself, with its KNN
positive, and with ``neg`` other images of the batch (``perms``). Each slot
contributes the row sums of ``ops/corr_stream.py:finalize``; there is one
group (one pointwise fd mean) per slot type.

The feature and code maps may lie on two grids (the feature-pyramid arch:
ResNet-50's layer4 at 7 x 7 beside 56 x 56 code): each is sampled on its
own grid at the same points, as the JAX package's gather form samples each
tensor (``pallas_corr.py:649-660``); on one grid this is the single-grid
loss exactly.

A slot (g, b) is pair row g * B + b, group-major. There are G * B distinct
sets of S samples: set b is image b at its coordinates ``coords1`` (side 1
of every row), set B + b its KNN positive at ``coords2``, set (2 + k) B + b
image perm_k(b) at ``coords2``; row g * B + b pairs set b with set b (g = 0)
or with set g * B + b. Once sampled, the products are kernel C2's
(``ops/corr_stream.py``) at N = S.

* :func:`sampled_corr_plain` is the plain PyTorch version: the (S, H*W)
  bilinear weight matrices of each grid (``ops/sampling.py``), with the
  kernel's rounding
  points: weights cast to ``feat_dtype`` for the features, f32
  accumulation, the sampled features rounded to ``feat_dtype`` before the
  f32 normalize, fd from ``feat_dtype`` values with f32 accumulation; the
  code side f32 throughout. Autograd gives its backward.
* :func:`sample_sets_plain` is the plain version of the gather kernel
  (every set sampled once), :func:`unsample_plain` that of the adjoint
  kernel (the code gradient of the sets back through the normalisation and
  the taps to the code maps).
* :func:`sampled_corr_fused` dispatches by device: CPU tensors go to the
  plain version, CUDA tensors through a ``torch.autograd.Function`` whose
  forward is the gather (``csrc/corr_sampled.cu``) and C2's forward, and
  whose backward is C2's backward and the adjoint, or raise. Gradients flow
  to the code maps only; the features are detached, as on the TPU
  (:377-379).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from stego_torch.kernels import build
from stego_torch.ops import corr_stream
from stego_torch.ops.corr_stream import clamp_bounds, finalize
from stego_torch.ops.math import l2_normalize
from stego_torch.ops.sampling import bilinear_sample_weights

# What the CUDA kernels take (csrc/corr_sampled.cu, csrc/corr_stream.cu):
# feature channels up to ResNet-50's 2048; any number of code channels and
# samples.
MAX_FEAT_CHANNELS = 2048
EPS = 1e-10  # the l2 normalisation's (src/modules.py:275-276)
# Calls of C1's forward (the gather and C2's forward) and backward (C2's
# backward and the adjoint) in this process; plain-version calls do not
# count, and C2's own counters (ops/corr_stream.py) do not count them.
# Read and reset by chip_smoke.py to show the main path used them.
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


def pair_rows(b: int, g: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx1, idx2) (G*B,) int64: the sets of each pair row g * B + b, set
    b and set b (g = 0) or set g * B + b."""
    ar = torch.arange(b, device=device)
    return ar.repeat(g), torch.cat([ar, torch.arange(b, g * b,
                                                     device=device)])


def _sets(b: int, perms: Sequence[torch.Tensor], device):
    """(source map (G*B,) into the maps [x; x_pos], valid (G*B,) bool) of
    every set: an out-of-range permutation entry reads map 0 and is not
    valid."""
    ar = torch.arange(b, device=device)
    neg = [p.to(device).long() for p in perms]
    src = torch.cat([ar, ar + b] + neg)
    valid = torch.cat([torch.ones(2 * b, dtype=torch.bool, device=device)]
                      + [(p >= 0) & (p < b) for p in neg])
    return torch.where(valid, src, 0), valid


def _set_weights(hw, coords1, coords2, g: int) -> torch.Tensor:
    """(G*B, S, H*W) f32 bilinear weights of every set: coords1 for set b,
    coords2 for the others."""
    w1 = bilinear_sample_weights(hw, _grid(coords1))
    w2 = bilinear_sample_weights(hw, _grid(coords2))
    return torch.cat([w1] + [w2] * (g - 1))


def sample_sets_plain(
    orig_feats: torch.Tensor,
    orig_feats_pos: torch.Tensor,
    orig_code: torch.Tensor,
    orig_code_pos: torch.Tensor,
    coords1: torch.Tensor,
    coords2: torch.Tensor,
    perms: Sequence[torch.Tensor],
    feat_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gather kernel's plain version: every set sampled once,
    group-major. Returns the l2-normalised feature sets (G*B, S, CF) in
    ``feat_dtype``, the l2-normalised code sets (G*B, S, CC) f32 and the raw
    code norms (G*B, S) f32, differentiable in the code maps. A set whose
    permutation entry is out of range is zeros."""
    b, h, w, cf = orig_feats.shape
    hc, wc, cc = orig_code.shape[1:]
    g = 2 + len(perms)
    wm = _set_weights((h, w), coords1, coords2, g)
    wmc = wm if (hc, wc) == (h, w) else _set_weights((hc, wc), coords1,
                                                     coords2, g)
    src, valid = _sets(b, perms, orig_code.device)
    f = torch.cat([orig_feats, orig_feats_pos]).detach() \
        .reshape(2 * b, h * w, cf).to(feat_dtype)
    c = torch.cat([orig_code, orig_code_pos]).reshape(2 * b, hc * wc,
                                                      cc).float()
    z = torch.bmm(wm.to(feat_dtype).float(), f[src].float())
    if feat_dtype == torch.bfloat16:
        z = z.to(feat_dtype).float()
    keep = valid[:, None, None]
    fsets = torch.where(keep, l2_normalize(z), 0.0).to(feat_dtype)
    zc = torch.bmm(wmc, c[src])
    norms = torch.sqrt(torch.sum(zc * zc, dim=-1))
    csets = torch.where(keep, l2_normalize(zc), 0.0)
    return fsets, csets, torch.where(valid[:, None], norms, 0.0)


def unsample_plain(
    dsets: torch.Tensor,
    csets: torch.Tensor,
    norms: torch.Tensor,
    coords1: torch.Tensor,
    coords2: torch.Tensor,
    perms: Sequence[torch.Tensor],
    hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adjoint kernel's plain version: the code sets' gradient
    ``dsets`` (G*B, S, CC) through the l2-normalise Jacobian
    (``pallas_corr_fused_sampling.py:_norm_jac``, :69-76; the projection is
    dropped below eps) of the normalised sets ``csets`` and their raw norms
    ``norms`` (:func:`sample_sets_plain`), then back through each sample's
    bilinear weights on the code's grid ``hw`` into the code maps: set b
    into code[b], set B + b into
    code_pos[b], set (2 + k) B + b into code[perm_k(b)]. Returns (dcode,
    dcode_pos), each (B, H, W, CC) f32. A set whose permutation entry is out
    of range adds nothing."""
    gb, _, cc = dsets.shape
    b = coords1.shape[0]
    g = gb // b
    n = norms[..., None]
    proj = csets * torch.sum(csets * dsets, dim=-1, keepdim=True)
    gv = (dsets - torch.where(n > EPS, proj, 0.0)) / torch.clamp_min(n, EPS)
    wm = _set_weights(hw, coords1, coords2, g)
    src, valid = _sets(b, perms, dsets.device)
    dmaps = torch.bmm(wm.transpose(1, 2), gv) * valid[:, None, None]
    out = torch.zeros((2 * b, hw[0] * hw[1], cc), dtype=torch.float32,
                      device=dsets.device).index_add_(0, src, dmaps)
    out = out.reshape(2 * b, hw[0], hw[1], cc)
    return out[:b], out[b:]


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
    code maps; the kernel's forward keeps the same fd for its backward."""
    fsets, csets, _ = sample_sets_plain(orig_feats, orig_feats_pos,
                                        orig_code, orig_code_pos, coords1,
                                        coords2, perms, feat_dtype)
    i1, i2 = pair_rows(orig_feats.shape[0], 2 + len(perms),
                       csets.device)
    fd = torch.bmm(fsets[i1].float(), fsets[i2].float().transpose(1, 2))
    cd = torch.bmm(csets[i1], csets[i2].transpose(1, 2))
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

    NHWC maps (B, H, W, C), the features on one grid and the code on the
    same or another, ``coords*`` (B, S1, S2, 2) in [-1, 1] in torch
    (x, y) order, ``perms`` the negatives' batch permutations (each (B,)
    int), ``shifts`` one per group (2 + len(perms)). Returns
    (losses (G,), cd_means (G,)), each the mean over its group's
    B * S * S elements, as ``pallas_corr_fused_sampling.py:sampled_corr_fused``.
    On a CUDA device ``feat_dtype`` is bf16 (a bf16 trunk) or f32 (an f32
    trunk): the kernels have an instantiation for each. A negative whose
    permutation entry is out of range gives its group NaN and adds nothing
    to the gradient."""
    if orig_code.device.type == "cpu":
        return sampled_corr_plain(orig_feats, orig_feats_pos, orig_code,
                                  orig_code_pos, coords1, coords2, perms,
                                  shifts, pointwise, zero_clamp, stabalize,
                                  feat_dtype)
    _check_groups(orig_feats.shape[0], len(perms), len(shifts))
    keep = torch.is_grad_enabled() and (orig_code.requires_grad
                                        or orig_code_pos.requires_grad)
    return _SampledCorr.apply(orig_code, orig_code_pos, orig_feats,
                              orig_feats_pos, coords1, coords2, tuple(perms),
                              tuple(float(x) for x in shifts),
                              bool(pointwise), bool(zero_clamp),
                              bool(stabalize), feat_dtype, keep)


def kernel_fd(losses: torch.Tensor) -> torch.Tensor:
    """The fd that the kernel's forward computed for ``losses`` (kept on
    their autograd node for the backward when a gradient can be taken),
    group-major (G*B, S, S) as :func:`sampled_products_plain` gives it."""
    fd = losses.grad_fn.saved_tensors[1]
    return fd[..., :fd.shape[1]]


def _flat(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, h, w, c = t.shape
    return t.detach().to(dtype).reshape(b, h * w, c).contiguous()


def gather_inputs(feats, feats_pos, code, code_pos, coords1, coords2,
                  perms, feat_dtype: torch.dtype):
    """The gather's inputs as the kernel reads them: the maps (B, H*W, C)
    contiguous (features in ``feat_dtype``, code f32), the coordinates
    (B, S1, S2, 2) f32 contiguous (the kernel reads them in the reference's
    transposed order) and the permutations (G-2, B) int64 (one unread
    entry without negatives). Each is a view where its input already is
    so."""
    b = feats.shape[0]
    dev = code.device
    if perms:
        perm = torch.stack([p.to(dev).long().reshape(b) for p in perms])
    else:
        perm = torch.zeros(1, dtype=torch.long, device=dev)
    return (_flat(feats, feat_dtype), _flat(feats_pos, feat_dtype),
            _flat(code, torch.float32), _flat(code_pos, torch.float32),
            coords1.float().contiguous(), coords2.float().contiguous(), perm)


def gather_launch(lib, feats, feats_pos, code, code_pos, coords1, coords2,
                  perm, g: int, hw: Tuple[int, int],
                  code_hw: Tuple[int, int]):
    """The gather kernel in ``lib`` on :func:`gather_inputs`, the features
    on the grid ``hw`` and the code on ``code_hw``:
    (feature sets (G*B, S, CF), code sets (G*B, S, CC), raw code norms
    (G*B, S), each code tap's code-map row (G*B, S, 4) int32 (2*B*Hc*Wc for
    none) and
    weight (G*B, S, 4) f32, and C2's pair-row layout: idx1, idx2 (G*B,)
    int32 (each pair row's sets; -1 for an out-of-range permutation entry),
    row_group (G*B,), order (2*G*B,) and offsets (G*B + 1,) int32, as
    ``corr_stream.backward_launch`` sorts them)."""
    dev = code.device
    b, _, cf = feats.shape
    cc = code.shape[-1]
    s1, s2 = coords1.shape[1:3]
    s = s1 * s2
    sets, i32, f32 = g * b, torch.int32, torch.float32
    fsets = torch.empty((sets, s, cf), dtype=feats.dtype, device=dev)
    csets = torch.empty((sets, s, cc), dtype=f32, device=dev)
    norms = torch.empty((sets, s), dtype=f32, device=dev)
    keys = torch.empty((sets, s, 4), dtype=i32, device=dev)
    wts = torch.empty((sets, s, 4), dtype=f32, device=dev)
    i1, i2, row_group = (torch.empty((sets,), dtype=i32, device=dev)
                         for _ in range(3))
    order = torch.empty((2 * sets,), dtype=i32, device=dev)
    offsets = torch.empty((sets + 1,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        err = lib.stego_corr_sampled_gather(
            feats.data_ptr(), feats_pos.data_ptr(), code.data_ptr(),
            code_pos.data_ptr(), coords1.data_ptr(), coords2.data_ptr(),
            perm.data_ptr(), fsets.data_ptr(), csets.data_ptr(),
            norms.data_ptr(), keys.data_ptr(), wts.data_ptr(), i1.data_ptr(),
            i2.data_ptr(), row_group.data_ptr(), order.data_ptr(),
            offsets.data_ptr(), b, hw[0], hw[1], code_hw[0], code_hw[1], cf,
            cc, s1, s2, g, int(feats.dtype == f32), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "corr_sampled gather kernel")
    return fsets, csets, norms, keys, wts, i1, i2, row_group, order, offsets


def adjoint_launch(lib, dsets, csets, norms, keys, wts, perm, b: int,
                   hw: Tuple[int, int]) -> torch.Tensor:
    """The adjoint in ``lib`` (a Jacobian kernel, then the adjoint
    kernel): the gradient (2B, H*W, CC) of the code maps [code; code_pos],
    ``hw`` the code's grid,
    from the code sets' gradient ``dsets`` (G*B, S, CC), the gather's
    outputs and the permutations ``perm`` (:func:`gather_inputs`). Each
    code-map row adds the taps that land on it in entry order, without
    atomics."""
    dev = dsets.device
    sets, s, cc = dsets.shape
    dcode = torch.empty((2 * b, hw[0] * hw[1], cc), dtype=torch.float32,
                        device=dev)
    gv = torch.empty_like(dsets)
    with torch.cuda.device(dev):
        err = lib.stego_corr_sampled_adjoint(
            dsets.data_ptr(), csets.data_ptr(), norms.data_ptr(),
            keys.data_ptr(), wts.data_ptr(), perm.data_ptr(), gv.data_ptr(),
            dcode.data_ptr(), b, hw[0], hw[1], cc, s, sets // b, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "corr_sampled adjoint kernel")
    return dcode


class _SampledCorr(torch.autograd.Function):
    """Kernel C1 as an autograd function of the two code maps: the gather
    and C2's forward, then C2's backward and the adjoint. With ``keep`` (a
    gradient will be taken) C2's forward keeps fd and the clamp mask."""

    @staticmethod
    def forward(ctx, code, code_pos, feats, feats_pos, coords1, coords2,
                perms, shifts, pointwise, zero_clamp, stabalize, feat_dtype,
                keep):
        dev = code.device
        b, h, w, cf = feats.shape
        hc, wc, cc = code.shape[1:]
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
            if tensors[name].shape != (b, hc, wc, cc):
                raise ValueError(f"{name} shape {tuple(tensors[name].shape)}"
                                 f" != {(b, hc, wc, cc)}")
        for name in ("coords1", "coords2"):
            if tensors[name].shape != coords1.shape \
                    or coords1.shape[0] != b or coords1.shape[-1] != 2:
                raise ValueError(f"{name} must be (B, S1, S2, 2) with B={b}; "
                                 f"got {tuple(tensors[name].shape)}")
        if cf > MAX_FEAT_CHANNELS:
            raise ValueError(f"kernel C1 takes <= {MAX_FEAT_CHANNELS} "
                             f"feature channels; got {cf}")
        lib = build.library()
        inputs = gather_inputs(feats, feats_pos, code, code_pos, coords1,
                               coords2, perms, feat_dtype)
        fsets, csets, norms, keys, wts, i1, i2, *layout = gather_launch(
            lib, *inputs, g, (h, w), (hc, wc))
        acc, fd, mask = corr_stream.forward_launch(
            lib, fsets, csets, i1, i2, zero_clamp, stabalize, False, keep)
        global FWD_LAUNCHES
        FWD_LAUNCHES += 1
        group_sizes = (b,) * g
        losses, cd_means, gm = corr_stream.finalize_rows(
            acc[:, 0], acc[:, 1], acc[:, 2], acc[:, 3], shifts, group_sizes,
            pointwise)
        # C2's saved tensors, in its order, then its pair-row layout and
        # what the adjoint reads
        ctx.save_for_backward(csets, fd, i1, i2, acc, gm, mask, *layout,
                              norms, keys, wts, inputs[-1])
        ctx.static = (shifts, group_sizes, pointwise, b, (hc, wc), cc)
        return losses, cd_means

    @staticmethod
    def backward(ctx, g_losses, g_cdms):
        saved = ctx.saved_tensors
        csets, (norms, keys, wts, perm) = saved[0], saved[10:]
        shifts, group_sizes, pointwise, b, hw, cc = ctx.static
        lib = build.library()
        dsets = corr_stream.backward_launch(
            lib, saved[:7], (shifts, group_sizes, pointwise, False),
            g_losses, g_cdms, layout=saved[7:10])
        dcode = adjoint_launch(lib, dsets, csets, norms, keys, wts, perm, b,
                               hw)
        global BWD_LAUNCHES
        BWD_LAUNCHES += 1
        dcode = dcode.reshape(2, b, *hw, cc)
        return (dcode[0], dcode[1]) + (None,) * 11
