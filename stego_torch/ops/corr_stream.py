"""The streamed contrastive-correlation loss (kernel C2, forward and
backward), its closed form and the loss's front end; counterpart of
``stego_tpu/ops/pallas_corr.py``.

The loss of a group of pairs is a closed form in per-row sums over the
(N, N) correspondence of each pair (``pallas_corr.py:12-20``):

    s1 = sum_j clamp(cd) * fd,  s2 = sum_j clamp(cd),  s3 = sum_j fd

so a kernel only has to produce those sums; :func:`finalize` turns them into
the per-group losses. There is one group per pair type and one per negative
sample: the reference recenters fd with the mean of each helper() call
(src/modules.py:331-333).

* :func:`fused_correlation_loss_plain` is C2's plain PyTorch version, on
  normalized (R, N, C) pair rows, with the kernel's rounding points: fd from
  ``feat_dtype`` values with f32 accumulation, cd in f32 (the kernel takes
  fd on f32 features, the f32 cd and the backward's f32 products by
  3xTF32 on the tensor cores, ``ops/tf32.py``, and recomputes by f32 FMA
  in channel order every cd within a margin of a clamp bound, so that its
  clamp masks are that FMA's, ``ops/tf32.py:cd_tf32x3_fixup``; with
  ``code_bf16``, from bf16-rounded code, and the backward's dL/dcd rounded
  to bf16 before its products, ``pallas_corr.py:251-260``). Autograd gives
  its backward.
* :func:`fused_correlation_loss_multi` is the public function
  (``pallas_corr.py:364``): CPU tensors go to the plain version, CUDA
  tensors to ``csrc/corr_stream.cu`` through a ``torch.autograd.Function``
  whose forward and backward are the kernel's two entries, or raise. Each
  distinct map is normalized once and the pair rows read it by index.
  Gradients flow to the code only; the features are detached (:440-443).
  When a gradient is taken the forward also keeps fd and the clamp mask of
  every pair row, and the backward reads them instead of the features.
* :func:`stream_backward_plain` is the plain version of that backward, on
  the stored fd and mask, for the tests and ``chip_smoke.py``.
* :func:`contrastive_correlation_loss_fused` is the three-pair front end
  (:485-704): full-field (every pixel against every pixel, C2), sampled
  with the sampling inside kernel C1 (``sampling_impl="fused"``,
  ``ops/corr_fused_sampling.py``), or bilinearly sampled and then C2
  (``"gather"``: ``fused_sampling="off"`` and ``pallas_loss_bf16``; the
  sampling is a bmm with the bilinear weight matrix, which gives
  :func:`~stego_torch.ops.sampling.sample_from_coords`'s values with a
  backward that, unlike ``F.grid_sample``'s, adds without atomics).

Unlike the TPU kernel nothing is padded: N and the channels keep their size
(the TPU's 128-row and 128-lane padding is a layout workaround whose padded
rows ``_finalize`` slices away).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from stego_torch.kernels import build
from stego_torch.ops.correlation import NEG_INF_MIN, CorrLossCfg
from stego_torch.ops.math import l2_normalize, tensor_correlation
from stego_torch.ops.sampling import (bilinear_sample_weights,
                                      sample_from_coords)
from stego_torch.parallel import dist

# What the CUDA kernel is built for (csrc/corr_stream.cu): feature channels
# up to ViT-B's 768, bf16 or f32; any number of code channels (in chunks of
# 128).
MAX_FEAT_CHANNELS = 768
# Rows and columns of the kernel's tiles (csrc/corr_stream.cu:kTile).
TILE = 64
# Launches of the CUDA kernel's two entries in this process (plain-version
# calls do not count). Read and reset by chip_smoke.py to show the main path
# used them.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def clamp_bounds(zero_clamp: bool, stabalize: bool) -> Tuple[float, float]:
    """(lo, hi) of the cd clamp (``pallas_corr.py:79-82``)."""
    return (0.0 if zero_clamp else NEG_INF_MIN,
            0.8 if stabalize else math.inf)


def device_vector(values: Sequence[float],
                  device: torch.device) -> torch.Tensor:
    """A small f32 vector of Python floats on ``device``, copied without a
    stream synchronisation (``torch.tensor(..., device=cuda)`` waits for the
    stream, which would stall the host mid-step). Pageable memory is staged
    before the copy call returns, so the temporary may go at once."""
    return torch.tensor(values, dtype=torch.float32).to(device,
                                                        non_blocking=True)


def device_ints(values: Sequence[int], device: torch.device) -> torch.Tensor:
    """:func:`device_vector` for int32 values."""
    return torch.tensor(values, dtype=torch.int32).to(device,
                                                      non_blocking=True)


def finalize(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor,
             cds: torch.Tensor, shifts: Sequence[float], pointwise: bool,
             over_ranks: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-group losses from the row sums (``pallas_corr.py:167-193``).

    s1, s2, s3, cds: (G, Bg, n) row sums of each group's Bg pairs of n
    samples. Returns (losses (G,), cd_means (G,), fd means gm (G,)); the
    loss of group g is the mean over its Bg * n * n elements of
    -clamp(cd) * (fd' - shift), fd' = fd - rowmean + gm when pointwise.
    ``over_ranks``: each rank holds Bg rows of every group and gm is the
    mean over every rank's rows (one all_reduce; fd carries no gradient),
    so that the ranks' mean of the losses is the global batch's loss."""
    n = s1.shape[-1]
    m = s1.shape[1] * n * n
    shift = device_vector(shifts, s1.device)
    # every group's sums in one reduction, each over m: s1, s2, s3 (the fd
    # mean gm), cd and, pointwise, the row-mean term s3 s2 / n
    parts = [s1, s2, s3, cds] + ([s3 * s2 / n] if pointwise else [])
    sums = torch.stack(parts).sum(dim=(2, 3)) / m
    big_s1, big_s2, gm, cd_means = sums[:4]
    if pointwise and over_ranks:
        gm = dist.all_reduce_(gm.detach().clone()) / dist.world()
    if pointwise:
        loss = sums[4] - big_s1 - (gm - shift) * big_s2
    else:
        loss = shift * big_s2 - big_s1
    return loss, cd_means, gm


def finalize_rows(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor,
                  cds: torch.Tensor, shifts: Sequence[float],
                  group_sizes: Sequence[int], pointwise: bool,
                  over_ranks: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`finalize` of (R, n) row sums whose rows are consecutive groups
    of ``group_sizes`` pairs (``pallas_corr.py:_finalize``, :167-193)."""
    if sum(group_sizes) != s1.shape[0] or len(shifts) != len(group_sizes):
        raise ValueError(f"{s1.shape[0]} rows, groups {tuple(group_sizes)}, "
                         f"{len(shifts)} shifts")
    if len(set(group_sizes)) == 1:
        g, n = len(group_sizes), s1.shape[-1]
        return finalize(*(t.reshape(g, -1, n) for t in (s1, s2, s3, cds)),
                        shifts, pointwise, over_ranks)
    parts, start = [], 0
    for size, shift in zip(group_sizes, shifts):
        parts.append(finalize(*(t[None, start:start + size]
                                for t in (s1, s2, s3, cds)), [shift],
                              pointwise, over_ranks))
        start += size
    return tuple(torch.cat(x) for x in zip(*parts))


def prep(t: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, H*W, C) rows l2-normalized in f32 (eps
    1e-10), then cast to ``dtype`` (``pallas_corr.py:_prep``, :356-361,
    without its padding)."""
    b, h, w, c = t.shape
    return l2_normalize(t.reshape(b, h * w, c).float()).to(dtype)


class _Bf16CodeDot(torch.autograd.Function):
    """cd = bf16(c1) bf16(c2)^T with f32 sums, and a backward that rounds
    dL/dcd to bf16 before its products, as the kernels' ``code_bf16``
    (``pallas_corr.py:98-103, 251-260``); the gradients stay f32."""

    @staticmethod
    def forward(ctx, c1, c2):
        a, b = c1.bfloat16().float(), c2.bfloat16().float()
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b.transpose(1, 2))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.bfloat16().float()
        return torch.bmm(g, b), torch.bmm(g.transpose(1, 2), a)


def fused_correlation_loss_plain(
    f1: torch.Tensor,
    f2: torch.Tensor,
    c1: torch.Tensor,
    c2: torch.Tensor,
    shifts: Sequence[float],
    group_sizes: Sequence[int],
    pointwise: bool = True,
    zero_clamp: bool = True,
    stabalize: bool = False,
    code_bf16: bool = False,
    over_ranks: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """C2's plain version on normalized (R, N, C) pair rows, side 1 and
    side 2 of every pair row, the rows in consecutive groups of
    ``group_sizes`` (``over_ranks``: this rank's rows of each group,
    :func:`finalize`). Returns (losses (G,), cd_means (G,)), differentiable
    in the code rows."""
    fd = torch.bmm(f1.detach().float(), f2.detach().float().transpose(1, 2))
    if code_bf16:
        cd = _Bf16CodeDot.apply(c1.float(), c2.float())
    else:
        cd = torch.bmm(c1.float(), c2.float().transpose(1, 2))
    cdc = torch.clamp(cd, *clamp_bounds(zero_clamp, stabalize))
    losses, cd_means, _ = finalize_rows((cdc * fd).sum(-1), cdc.sum(-1),
                                        fd.sum(-1), cd.sum(-1), shifts,
                                        group_sizes, pointwise, over_ranks)
    return losses, cd_means


def stream_loss(feats: torch.Tensor, code: torch.Tensor, idx1: torch.Tensor,
                idx2: torch.Tensor, shifts: Sequence[float],
                group_sizes: Sequence[int], pointwise: bool = True,
                zero_clamp: bool = True, stabalize: bool = False,
                code_bf16: bool = False, use_kernel: bool = True,
                over_ranks: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Losses and cd means of the pair rows (idx1[r], idx2[r]) over the
    normalized maps ``feats`` (M, N, CF) and ``code`` (M, N, CC): kernel C2
    for CUDA tensors (``use_kernel=False`` takes the plain version there
    too), the plain version for CPU tensors. The kernel's forward keeps fd
    and the clamp mask for the backward only when a gradient can be taken
    (not under ``torch.no_grad()``, as in the val steps). ``over_ranks``:
    the rows are this rank's of each group (:func:`finalize`)."""
    if code.device.type == "cpu" or not use_kernel:
        return fused_correlation_loss_plain(
            feats[idx1], feats[idx2], code[idx1], code[idx2], shifts,
            group_sizes, pointwise, zero_clamp, stabalize, code_bf16,
            over_ranks)
    keep = torch.is_grad_enabled() and code.requires_grad
    return _StreamCorr.apply(code, feats.detach(), idx1, idx2,
                             tuple(float(s) for s in shifts),
                             tuple(int(g) for g in group_sizes),
                             bool(pointwise), bool(zero_clamp),
                             bool(stabalize), bool(code_bf16), keep,
                             bool(over_ranks))


def _split(sizes: Sequence[int], shifts: Sequence[float], split_groups: int):
    """Group sizes and shifts with every pair type cut into ``split_groups``
    equal consecutive groups (``pallas_corr.py:418-430``)."""
    if split_groups <= 1:
        return tuple(sizes), tuple(shifts)
    for size in sizes:
        if size % split_groups:
            raise ValueError(f"pair batch {size} not divisible by "
                             f"split_groups {split_groups}")
    reps = range(split_groups)
    return (tuple(s // split_groups for s in sizes for _ in reps),
            tuple(s for s in shifts for _ in reps))


def _merge(losses: torch.Tensor, cd_means: torch.Tensor, split_groups: int):
    """Per pair type, the mean of its split groups (:457-460)."""
    if split_groups <= 1:
        return losses, cd_means
    return (losses.reshape(-1, split_groups).mean(1),
            cd_means.reshape(-1, split_groups).mean(1))


def fused_correlation_loss_multi(
    pairs: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]],
    shifts: Sequence[float],
    pointwise: bool = True,
    zero_clamp: bool = True,
    stabalize: bool = False,
    feat_dtype: torch.dtype = torch.float32,
    pre_prepped: bool = False,
    n_real: int | None = None,
    code_bf16: bool = False,
    split_groups: int = 1,
    use_kernel: bool = True,
    over_ranks: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All pair types in one launch of each of C2's entries.

    ``pairs``: one (f1, f2, c1, c2) tuple of NHWC maps a pair type, all of
    one spatial size. A tensor (feature and code map together) that several
    pairs share is normalized once and read by index. ``pre_prepped`` and
    ``n_real`` keep the JAX signature; no caller in the port sets them:
    with ``pre_prepped`` the pairs are normalized (B, N, C) rows
    (:func:`prep`), and ``n_real``, where given, must be N (the port pads
    nothing). ``shifts``: one a pair
    type. ``feat_dtype``: the features' type in the fd product, bf16 or f32.
    ``code_bf16``: the code side in bf16 with f32 sums
    (``pallas_loss_bf16``). ``split_groups``: every pair type cut into that
    many equal groups, each with its own pointwise fd mean, and their losses
    averaged (``negatives_scope=local``). ``use_kernel=False`` takes the
    plain version on a CUDA tensor. ``over_ranks``: the pairs are this
    rank's rows of each pair type, and each type's pointwise fd mean is
    taken over every rank's (:func:`finalize`). Returns (losses, cd_means),
    one a pair type (``pallas_corr.py:364-461``)."""
    sizes = [p[0].shape[0] for p in pairs]
    group_sizes, shifts = _split(sizes, shifts, split_groups)
    dev = pairs[0][2].device
    maps: list = []  # distinct (feature, code) sides and their first row
    idx1, idx2 = [], []

    def index(f, c):
        for mf, mc, off in maps:
            if mf is f and mc is c:
                break
        else:
            off = sum(x.shape[0] for x, _, _ in maps)
            maps.append((f, c, off))
        return torch.arange(f.shape[0], device=dev) + off

    for f1, f2, c1, c2 in pairs:
        if f2.shape[0] != f1.shape[0]:
            raise ValueError(f"pair sides of batch {f1.shape[0]} and "
                             f"{f2.shape[0]}")
        idx1.append(index(f1, c1))
        idx2.append(index(f2, c2))
    if pre_prepped:
        feats = [f.detach() for f, _, _ in maps]
        code = [c for _, c, _ in maps]
        if n_real is not None and n_real != feats[0].shape[1]:
            raise ValueError(f"n_real {n_real} != {feats[0].shape[1]} rows: "
                             f"the port pads nothing")
        # the fix-up of the kernel's f32 cd has a margin that holds for
        # code rows of norm <= 1 (csrc/corr_stream.cu:fixup_eps), which
        # prep guarantees and the caller's rows might not; a host sync on
        # this path only (code_bf16's cd has no fix-up)
        worst = 0.0 if code_bf16 else max(
            float(torch.linalg.vector_norm(c.detach().float(), dim=-1).max())
            for c in code)
        if worst > 1 + 2 ** -20:
            raise ValueError(f"pre_prepped code rows must be l2-normalised "
                             f"(norm <= 1); the largest norm is {worst}")
    else:
        feats = [prep(f, feat_dtype).detach() for f, _, _ in maps]
        code = [prep(c) for _, c, _ in maps]
    losses, cd_means = stream_loss(
        torch.cat(feats), torch.cat(code), torch.cat(idx1), torch.cat(idx2),
        shifts, group_sizes, pointwise, zero_clamp, stabalize, code_bf16,
        use_kernel, over_ranks)
    return _merge(losses, cd_means, split_groups)


def kernel_row_sums(losses: torch.Tensor) -> torch.Tensor:
    """The row sums (R, 4, N) that the kernel's forward computed for
    ``losses`` (kept on their autograd node for the backward): per pair row
    and sample, sum(clamp(cd) fd), sum(clamp(cd)), sum(fd), sum(cd)."""
    return losses.grad_fn.saved_tensors[4]


def kernel_saved(losses: torch.Tensor) -> Dict[str, torch.Tensor]:
    """What the kernel's forward kept for ``losses``' backward: the code
    maps, the pair rows' map indices ``idx1`` and ``idx2``, the row sums
    ``acc`` (:func:`kernel_row_sums`), each group's fd mean ``gm``, and fd
    (R, N, N) and the clamp mask (R, N, N) bool of every pair row (those of
    a row with an out-of-range map index are not written)."""
    code, fd, i1, i2, acc, gm, mask = losses.grad_fn.saved_tensors
    n = code.shape[1]
    return {"code": code, "idx1": i1, "idx2": i2, "acc": acc, "gm": gm,
            "fd": fd[..., :n], "mask": unpack_mask(mask, n)}


def fd_pitch(n: int) -> int:
    """Row pitch (f32 elements) of the forward's stored fd: n rounded up to
    4, a multiple of 16 bytes, as a TMA box row needs
    (``csrc/corr_stream.cu:fd_pitch``)."""
    return -(-n // 4) * 4


def mask_words(n: int) -> int:
    """32-bit words a row of the stored clamp mask: ceil(n / 32) rounded up
    to 4 (``csrc/corr_stream.cu:mask_words``); bit j % 32 of word j // 32
    is column j."""
    words = -(-n // 32)
    return -(-words // 4) * 4


def unpack_mask(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., N, W) int32 mask words -> (..., N, n) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.flatten(-2)[..., :n].bool()


def code_tiles(code: torch.Tensor, code_bf16: bool) -> torch.Tensor:
    """The code maps (M, N, CC) as the backward kernel's TMA reads them:
    (M, ceil(N / 64), CC, 64), each 64-row tile channel-major, zeros past
    N; bf16 (rounded to nearest even, as the kernel rounded its tiles) with
    ``code_bf16``. A code row of 70 f32 is 280 bytes, which a TMA box row
    (a multiple of 16 bytes) cannot address; a channel row of a tile is 256
    (f32) or 128 (bf16) bytes."""
    m, n, cc = code.shape
    tiles = -(-n // TILE)
    padded = torch.nn.functional.pad(code, (0, 0, 0, tiles * TILE - n))
    out = torch.empty((m, tiles, cc, TILE), device=code.device,
                      dtype=torch.bfloat16 if code_bf16 else torch.float32)
    return out.copy_(padded.view(m, tiles, TILE, cc).transpose(2, 3))


def backward_scalars(g_losses: torch.Tensor, g_cdms: torch.Tensor,
                     gm: torch.Tensor, shifts: Sequence[float],
                     group_sizes: Sequence[int], n: int) -> torch.Tensor:
    """(G, 5) f32 per group: g_loss, g_cdm, fd mean gm, shift, 1/m (m =
    size * n * n), the backward's scalars (``pallas_corr.py:230-236``)."""
    dev = gm.device
    inv_m = device_vector([1.0 / (size * n * n) for size in group_sizes], dev)
    return torch.stack([g_losses.float(), g_cdms.float(), gm,
                        device_vector(shifts, dev), inv_m],
                       dim=1).contiguous()


def row_groups(group_sizes: Sequence[int], device) -> torch.Tensor:
    """(R,) int32: the group of each pair row."""
    return device_ints([gi for gi, size in enumerate(group_sizes)
                        for _ in range(size)], device)


def stream_backward_plain(fd: torch.Tensor, mask: torch.Tensor,
                          code: torch.Tensor, idx1: torch.Tensor,
                          idx2: torch.Tensor, acc: torch.Tensor,
                          scal: torch.Tensor, pointwise: bool,
                          code_bf16: bool) -> torch.Tensor:
    """The plain version of C2's backward on the forward's stored fd (R, N,
    N) f32 and clamp mask (R, N, N) bool: the code gradient (M, N, CC) of
    the normalized code maps ``code`` (M, N, CC) f32. ``acc``: the row sums
    (R, 4, N); ``scal`` (R, 5): each pair row's group scalars
    (:func:`backward_scalars`). The kernel's arithmetic: per entry
    v = ((-(fd' - shift) mask) g_loss + g_cdm) / m, fd' = (fd - s3 / N) + gm
    when pointwise, bf16-rounded with ``code_bf16`` (and the code too);
    then dc1 = v c2 and dc2 = v^T c1 added to each map's gradient in the
    kernel's entry order (by map, side-1 rows, then side-2 rows). A pair row
    with an out-of-range map index adds nothing."""
    r, n = fd.shape[:2]
    g_loss, g_cdm, gm, shift, inv_m = (scal[:, k, None, None].float()
                                       for k in range(5))
    fdp = fd - (acc[:, 2] / n)[..., None] + gm if pointwise else fd
    v = (-(fdp - shift) * mask.float() * g_loss + g_cdm) * inv_m
    c = code.float()
    if code_bf16:
        v, c = v.bfloat16().float(), c.bfloat16().float()
    m = code.shape[0]
    valid = ((idx1 >= 0) & (idx1 < m) & (idx2 >= 0) & (idx2 < m)).tolist()
    i1, i2 = idx1.tolist(), idx2.tolist()
    dcode = torch.zeros_like(c)
    order = torch.sort(torch.cat([idx1, idx2]).cpu(), stable=True)[1]
    for e in order.tolist():
        row = e % r
        if not valid[row]:
            continue
        if e < r:
            dcode[i1[row]] += v[row] @ c[i2[row]]
        else:
            dcode[i2[row]] += v[row].T @ c[i1[row]]
    return dcode


def backward_occupancy(cc: int, code_bf16: bool,
                       device: torch.device) -> Dict[str, int]:
    """The backward kernel's launch at ``cc`` code channels on ``device``
    (a CUDA device): its ring stages, dynamic shared memory (bytes) and the
    blocks an SM holds (the occupancy API)."""
    out = (ctypes.c_int * 3)()
    build.check(build.library().stego_corr_stream_bwd_occupancy(
        cc, int(code_bf16), torch.device(device).index or 0, out),
        "corr_stream backward occupancy")
    return dict(zip(("stages", "smem_bytes", "blocks_per_sm"), out))


def forward_occupancy(code_bf16: bool, feat_f32: bool,
                      device: torch.device) -> Dict[str, int]:
    """The forward kernel's launch on ``device`` (a CUDA device) for its
    code and feature types: registers a thread, dynamic shared memory
    (bytes), the blocks an SM holds (the occupancy API) and its ring
    stages."""
    out = (ctypes.c_int * 4)()
    build.check(build.library().stego_corr_stream_fwd_occupancy(
        int(code_bf16), int(feat_f32), torch.device(device).index or 0,
        out), "corr_stream forward occupancy")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm", "stages"),
                    out))


def fixup_stats(lib, device: torch.device) -> Tuple[int, float]:
    """The entries whose cd the forward's fix-up recomputed by FMA since
    the last call, and the largest |cd by 3xTF32 - cd by FMA| over them,
    in a library built to record them (``-DSTEGO_C2_FWD_ABLATION=16``,
    ``tools/c2_ablation.py``); (0, 0.0) in any other build. Resets both."""
    count, gap = ctypes.c_ulonglong(0), ctypes.c_float(0.0)
    build.check(lib.stego_corr_stream_fwd_fixups(
        torch.device(device).index or 0, ctypes.byref(count),
        ctypes.byref(gap)), "corr_stream forward fix-up count")
    return int(count.value), float(gap.value)


def forward_launch(lib, feats: torch.Tensor, code: torch.Tensor,
                   i1: torch.Tensor, i2: torch.Tensor, zero_clamp: bool,
                   stabalize: bool, code_bf16: bool, keep: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C2's forward entry in ``lib`` (the port's library, or a variant
    that ``tools/c2_ablation.py`` times) on contiguous normalized maps
    ``feats`` (M, N, CF) bf16 or f32 and ``code`` (M, N, CC) f32 and int32
    pair-row indices: (acc (R, 4, N), fd, mask), fd and mask empty unless
    ``keep``. It allocates the copies that the kernel's TMA reads
    (``csrc/corr_stream.cu:stego_corr_stream_fwd``), which its first
    launches fill: the f32 code as its TF32 high and low parts, padded to 4
    channels, since a TMA box row is a multiple of 16 bytes and a code row
    of 70 f32 is 280 (``code_bf16``: the bf16 code padded to 8; 14.5 and
    3.6 MB at the full-field shape); f32 features as their TF32 parts too
    (+2x their bytes, 77 MB at the full-field shape); bf16 features padded
    to 8 channels where they are not (100 channels: a 200-byte row)."""
    dev = code.device
    m, n, cc = code.shape
    cf = feats.shape[-1]
    r = i1.shape[0]
    feats = feats.contiguous()
    feat_f32 = feats.dtype == torch.float32
    f32, bf16 = torch.float32, torch.bfloat16

    def padded(c, mult, dtype):
        return torch.empty((m, n, -(-c // mult) * mult), dtype=dtype,
                           device=dev)

    feat_hi = feat_lo = None
    if feat_f32:
        feat_hi, feat_lo = padded(cf, 4, f32), padded(cf, 4, f32)
    elif cf % 8:
        feat_hi = padded(cf, 8, bf16)
    if code_bf16:
        code_hi, code_lo = padded(cc, 8, bf16), None
    else:
        code_hi, code_lo = padded(cc, 4, f32), padded(cc, 4, f32)
    acc = torch.empty((r, 4, n), dtype=f32, device=dev)
    fd = torch.empty((r, n, fd_pitch(n)) if keep else (0,), dtype=f32,
                     device=dev)
    mask = torch.empty((r, n, mask_words(n)) if keep else (0,),
                       dtype=torch.int32, device=dev)
    lo, hi = clamp_bounds(zero_clamp, stabalize)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.stego_corr_stream_fwd(
        feats.data_ptr(), code.data_ptr(), i1.data_ptr(), i2.data_ptr(),
        acc.data_ptr(), fd.data_ptr() if keep else None,
        mask.data_ptr() if keep else None, ptr(feat_hi), ptr(feat_lo),
        ptr(code_hi), ptr(code_lo), r, m, n, cf, cc, int(code_bf16),
        int(feat_f32), lo, hi, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "corr_stream forward kernel")
    return acc, fd, mask


class _StreamCorr(torch.autograd.Function):
    """Kernel C2 as an autograd function of the normalized code maps. With
    ``keep`` (a gradient will be taken) the forward also writes fd and the
    clamp mask, which the backward reads in place of the features."""

    @staticmethod
    def forward(ctx, code, feats, idx1, idx2, shifts, group_sizes,
                pointwise, zero_clamp, stabalize, code_bf16, keep,
                over_ranks):
        dev = code.device
        if feats.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(
                f"kernel C2 takes bf16 or f32 features (the trunk's "
                f"feat_dtype); got {feats.dtype}")
        if code.dim() != 3 or feats.dim() != 3 \
                or feats.shape[:2] != code.shape[:2]:
            raise ValueError(f"feats {tuple(feats.shape)} and code "
                             f"{tuple(code.shape)} must be (M, N, C) of one "
                             f"(M, N)")
        cf = feats.shape[-1]
        r = idx1.shape[0]
        for name, t in (("feats", feats), ("idx1", idx1), ("idx2", idx2)):
            if t.device != dev:
                raise ValueError(f"kernel C2 needs {name} on {dev}, got "
                                 f"{t.device}")
        if idx2.shape != (r,) or idx1.dim() != 1:
            raise ValueError(f"idx1 {tuple(idx1.shape)} and idx2 "
                             f"{tuple(idx2.shape)} must be (R,)")
        if cf > MAX_FEAT_CHANNELS:
            raise ValueError(f"kernel C2 takes <= {MAX_FEAT_CHANNELS} "
                             f"feature and any number of code channels; "
                             f"got {cf} feature channels")
        code = code.float().contiguous()
        i1 = idx1.to(torch.int32).contiguous()
        i2 = idx2.to(torch.int32).contiguous()
        acc, fd, mask = forward_launch(build.library(), feats, code, i1, i2,
                                       zero_clamp, stabalize, code_bf16, keep)
        global FWD_LAUNCHES
        FWD_LAUNCHES += 1
        losses, cd_means, gm = finalize_rows(acc[:, 0], acc[:, 1], acc[:, 2],
                                             acc[:, 3], shifts, group_sizes,
                                             pointwise, over_ranks)
        ctx.save_for_backward(code, fd, i1, i2, acc, gm, mask)
        ctx.static = (shifts, group_sizes, pointwise, code_bf16)
        return losses, cd_means

    @staticmethod
    def backward(ctx, g_losses, g_cdms):
        dcode = backward_launch(build.library(), ctx.saved_tensors,
                                ctx.static, g_losses, g_cdms)
        global BWD_LAUNCHES
        BWD_LAUNCHES += 1
        return (dcode,) + (None,) * 11


def backward_launch(lib, saved: Sequence[torch.Tensor], static: tuple,
                    g_losses: torch.Tensor, g_cdms: torch.Tensor,
                    layout: Tuple[torch.Tensor, ...] | None = None
                    ) -> torch.Tensor:
    """The code gradient from C2's backward entry in ``lib`` (the port's
    library, or a variant that ``tools/c2_ablation.py`` times), given
    what the forward saved and its static arguments. ``layout``: the pair
    rows' (row_group, order, offsets) int32, where the caller has them
    (kernel C1's gather writes them for its rows); else made here."""
    code, fd, i1, i2, acc, gm, mask = saved
    shifts, group_sizes, pointwise, code_bf16 = static
    dev = code.device
    m, n, cc = code.shape
    r = i1.shape[0]
    scal = backward_scalars(g_losses, g_cdms, gm, shifts, group_sizes, n)
    if layout is None:
        row_group = row_groups(group_sizes, dev)
        # every map's pair rows, side 1 (entry r) then side 2 (entry R + r),
        # in a fixed order: a stable sort by map, no host synchronisation
        keys, order = torch.sort(torch.cat([i1, i2]), stable=True)
        order = order.to(torch.int32)
        offsets = torch.searchsorted(
            keys, torch.arange(m + 1, dtype=torch.int32, device=dev)
        ).to(torch.int32)
    else:
        row_group, order, offsets = layout
    tiles = code_tiles(code, code_bf16)
    dcode = torch.empty_like(code)
    err = lib.stego_corr_stream_bwd(
        fd.data_ptr(), mask.data_ptr(), tiles.data_ptr(), i1.data_ptr(),
        i2.data_ptr(), acc.data_ptr(), scal.data_ptr(), row_group.data_ptr(),
        order.data_ptr(), offsets.data_ptr(), dcode.data_ptr(), r, m, n, cc,
        int(code_bf16), int(pointwise), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "corr_stream backward kernel")
    return dcode


def _full_field(cfg: CorrLossCfg, orig_feats, orig_feats_pos, orig_code,
                orig_code_pos, perms, feat_dtype, code_bf16, use_kernel,
                rows: Optional[slice]):
    """The dense loss over every (pixel, pixel) pair (:538-565): each
    distinct map normalized once; the pair rows are the self pair, the
    KNN-positive pair and one group per negative, whose side 2 is read as
    ``code[perm_k(b)]`` by index; for the images ``rows`` of the global
    batch of ``orig_feats`` when given
    (:func:`contrastive_correlation_loss_fused`)."""
    fp = prep(orig_feats, feat_dtype).detach()
    fpp = prep(orig_feats_pos, feat_dtype).detach()
    cp, cpp = prep(orig_code), prep(orig_code_pos)
    dev = cp.device
    over_ranks = rows is not None
    rows = rows or slice(0, fp.shape[0])
    own = torch.arange(rows.start, rows.stop, device=dev)
    b = own.shape[0]
    idx1 = own.repeat(2 + len(perms))
    idx2 = torch.cat([own, own - rows.start + fp.shape[0]]
                     + [p.to(dev).long()[rows] for p in perms])
    group_sizes, shifts = _split([b] * (2 + len(perms)), cfg.shifts,
                                 cfg.neg_blocks)
    losses, cd_means = stream_loss(torch.cat([fp, fpp]),
                                   torch.cat([cp, cpp]), idx1, idx2, shifts,
                                   group_sizes, cfg.pointwise,
                                   cfg.zero_clamp, cfg.stabalize, code_bf16,
                                   use_kernel, over_ranks)
    return _merge(losses, cd_means, cfg.neg_blocks)


def contrastive_correlation_loss_fused(
    cfg: CorrLossCfg,
    orig_feats: torch.Tensor,
    orig_feats_pos: torch.Tensor,
    orig_code: torch.Tensor,
    orig_code_pos: torch.Tensor,
    coords1: torch.Tensor,
    coords2: torch.Tensor,
    perms: Sequence[torch.Tensor],
    full_field: bool = False,
    return_cd_tensors: bool = False,
    feat_dtype: torch.dtype = torch.float32,
    code_bf16: bool = False,
    sampling_impl: str = "fused",
    use_kernel: bool = True,
    rows: Optional[slice] = None,
) -> Dict[str, torch.Tensor]:
    """Three-pair loss (``pallas_corr.py:contrastive_correlation_loss_fused``,
    :485-704): scalar losses and cd means of the self pair, the KNN-positive
    pair and the negatives (one group each).

    ``full_field``: every pixel against every pixel through C2; the
    coordinates go unused. Otherwise the maps are sampled at ``coords1`` /
    ``coords2``: inside kernel C1 (``sampling_impl="fused"``) or by the
    bilinear weight matrix and then C2 (``"gather"``). With
    ``return_cd_tensors`` (sampled modes) the cd entries are instead the cd
    tensors of the sampled code, for the histograms. ``use_kernel=False``
    calls the kernels' plain versions even on a CUDA tensor, which is how
    the train step is held against them on the card.

    ``rows`` (global negatives over several processes; C2's routes only):
    ``orig_feats`` and ``orig_code`` hold the global batch, gathered over
    the ranks (``parallel/dist.py:gather_rows``), the permutations index
    it, and this rank's images are its ``rows``, whose positives
    (``orig_feats_pos``, ``orig_code_pos``) and coordinates the other
    arguments hold. The loss's pair rows are this rank's, each pair type's
    pointwise fd mean is the global batch's (one all_reduce), and the
    returned losses are this rank's share: their mean over the ranks is the
    one-process loss of the global batch."""
    if len(perms) != cfg.neg_samples:
        raise ValueError(f"{len(perms)} permutations for neg_samples="
                         f"{cfg.neg_samples}")
    has_neg = cfg.neg_samples > 0
    code = code_pos = code_neg = None
    over_ranks = rows is not None
    if full_field:
        losses, cd_means = _full_field(cfg, orig_feats, orig_feats_pos,
                                       orig_code, orig_code_pos, perms,
                                       feat_dtype, code_bf16, use_kernel,
                                       rows)
    elif sampling_impl == "fused":
        if over_ranks:
            raise ValueError(
                "kernel C1 (sampling_impl='fused') reads its negatives "
                "inside one process's batch: global negatives over several "
                "processes take the streamed path (sampling_impl='gather'), "
                "local ones (negatives_scope=local) C1 on each rank")
        if cfg.neg_blocks > 1:
            raise ValueError(
                "neg_blocks>1 (negatives_scope=local) needs one process per "
                "block: the single-device fused kernel takes one pointwise "
                "mean per pair type (the streamed path, sampling_impl="
                "'gather', emulates it on one device)")
        if code_bf16:
            raise ValueError(
                "pallas_loss_bf16 is not implemented for the fused-sampling "
                "kernel C1 (its code side is f32); sampling_impl='gather' "
                "honours it")
        # imported here: kernel C1's module imports this one's finalize
        from stego_torch.ops.corr_fused_sampling import (sampled_corr_fused,
                                                         sampled_corr_plain)

        losses, cd_means = (sampled_corr_fused if use_kernel
                            else sampled_corr_plain)(
            orig_feats, orig_feats_pos, orig_code, orig_code_pos, coords1,
            coords2, perms, cfg.shifts, pointwise=cfg.pointwise,
            zero_clamp=cfg.zero_clamp, stabalize=cfg.stabalize,
            feat_dtype=feat_dtype)
        if return_cd_tensors:
            # the histograms' cd tensors from plainly sampled code; the loss
            # and its gradients come from C1 alone
            with torch.no_grad():
                code = sample_from_coords(orig_code, coords1)
                code_pos = sample_from_coords(orig_code_pos, coords2)
                if has_neg:
                    code_neg = torch.cat([sample_from_coords(orig_code[p],
                                                             coords2)
                                          for p in perms])
    elif sampling_impl == "gather":
        # sample_from_coords as one f32 bmm with each coordinate set's
        # bilinear weights (the JAX package's matmul path, :636-653): the
        # same values as F.grid_sample, but a backward without atomics, so
        # the step's gradient is the same from run to run (a first Adam
        # step turns run-to-run noise on a near-zero gradient into +-lr)
        h, w = orig_feats.shape[1:3]
        b = coords1.shape[0]
        grid_hw = coords1.shape[2], coords1.shape[1]  # transposed grid
        w1, w2 = (bilinear_sample_weights((h, w), c.transpose(1, 2))
                  for c in (coords1, coords2))

        def sample(wm, t):
            out = torch.bmm(wm, t.reshape(t.shape[0], h * w, -1).float())
            return out.reshape(t.shape[0], *grid_hw, t.shape[-1])

        rows = rows or slice(0, orig_feats.shape[0])
        feats = sample(w1, orig_feats[rows])
        code = sample(w1, orig_code[rows])
        feats_pos = sample(w2, orig_feats_pos)
        code_pos = sample(w2, orig_code_pos)
        pairs = [(feats, feats, code, code), (feats, feats_pos, code,
                                              code_pos)]
        if has_neg:
            negs = [p.to(orig_feats.device).long()[rows] for p in perms]
            feats_neg = torch.cat([sample(w2, orig_feats[p]) for p in negs])
            code_neg = torch.cat([sample(w2, orig_code[p]) for p in negs])
            pairs += [(feats, feats_neg[k * b:(k + 1) * b], code,
                       code_neg[k * b:(k + 1) * b])
                      for k in range(len(perms))]
        losses, cd_means = fused_correlation_loss_multi(
            pairs, cfg.shifts, pointwise=cfg.pointwise,
            zero_clamp=cfg.zero_clamp, stabalize=cfg.stabalize,
            feat_dtype=feat_dtype, code_bf16=code_bf16,
            split_groups=cfg.neg_blocks, use_kernel=use_kernel,
            over_ranks=over_ranks)
    else:
        raise ValueError(f"sampling_impl must be 'fused' or 'gather', got "
                         f"{sampling_impl!r}")
    zero = torch.zeros((), device=losses.device)
    out = {
        "pos_intra_loss": losses[0],
        "pos_intra_cd": cd_means[0],
        "pos_inter_loss": losses[1],
        "pos_inter_cd": cd_means[1],
        "neg_inter_loss": losses[2:].mean() if has_neg else zero,
        "neg_inter_cd": cd_means[2:].mean() if has_neg else zero,
    }
    if return_cd_tensors and not full_field:
        with torch.no_grad():
            def cd_of(c1, c2):
                return tensor_correlation(l2_normalize(c1), l2_normalize(c2))

            out["pos_intra_cd"] = cd_of(code, code)
            out["pos_inter_cd"] = cd_of(code, code_pos)
            if has_neg:
                out["neg_inter_cd"] = cd_of(code.repeat(len(perms), 1, 1, 1),
                                            code_neg)
    return out
