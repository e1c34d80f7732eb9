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
  ``feat_dtype`` values with f32 accumulation, cd in f32 (with
  ``code_bf16``, from bf16-rounded code, and the backward's dL/dcd rounded
  to bf16 before its products, ``pallas_corr.py:251-260``). Autograd gives
  its backward.
* :func:`fused_correlation_loss_multi` is the public function
  (``pallas_corr.py:364``): CPU tensors go to the plain version, CUDA
  tensors to ``csrc/corr_stream.cu`` through a ``torch.autograd.Function``
  whose forward and backward are the kernel's two entries, or raise. Each
  distinct map is normalized once and the pair rows read it by index.
  Gradients flow to the code only; the features are detached (:440-443).
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

import math
from typing import Dict, Sequence, Tuple

import torch

from stego_torch.kernels import build
from stego_torch.ops.correlation import (NEG_INF_MIN, CorrLossCfg,
                                         salience_not_ported)
from stego_torch.ops.math import l2_normalize, tensor_correlation
from stego_torch.ops.sampling import (bilinear_sample_weights,
                                      sample_from_coords)

# What the CUDA kernel is built for (csrc/corr_stream.cu).
MAX_FEAT_CHANNELS = 512
MAX_CODE_CHANNELS = 128
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
             cds: torch.Tensor, shifts: Sequence[float], pointwise: bool
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-group losses from the row sums (``pallas_corr.py:167-193``).

    s1, s2, s3, cds: (G, Bg, n) row sums of each group's Bg pairs of n
    samples. Returns (losses (G,), cd_means (G,), fd means gm (G,)); the
    loss of group g is the mean over its Bg * n * n elements of
    -clamp(cd) * (fd' - shift), fd' = fd - rowmean + gm when pointwise."""
    n = s1.shape[-1]
    m = s1.shape[1] * n * n
    shift = device_vector(shifts, s1.device)
    big_s1 = s1.sum(dim=(1, 2))
    big_s2 = s2.sum(dim=(1, 2))
    gm = s3.sum(dim=(1, 2)) / m
    if pointwise:
        rowterm = (s3 * s2).sum(dim=(1, 2)) / n
        loss_sum = -(big_s1 - rowterm + (gm - shift) * big_s2)
    else:
        loss_sum = -(big_s1 - shift * big_s2)
    return loss_sum / m, cds.sum(dim=(1, 2)) / m, gm


def finalize_rows(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor,
                  cds: torch.Tensor, shifts: Sequence[float],
                  group_sizes: Sequence[int], pointwise: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`finalize` of (R, n) row sums whose rows are consecutive groups
    of ``group_sizes`` pairs (``pallas_corr.py:_finalize``, :167-193)."""
    if sum(group_sizes) != s1.shape[0] or len(shifts) != len(group_sizes):
        raise ValueError(f"{s1.shape[0]} rows, groups {tuple(group_sizes)}, "
                         f"{len(shifts)} shifts")
    if len(set(group_sizes)) == 1:
        g, n = len(group_sizes), s1.shape[-1]
        return finalize(*(t.reshape(g, -1, n) for t in (s1, s2, s3, cds)),
                        shifts, pointwise)
    parts, start = [], 0
    for size, shift in zip(group_sizes, shifts):
        parts.append(finalize(*(t[None, start:start + size]
                                for t in (s1, s2, s3, cds)), [shift],
                              pointwise))
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """C2's plain version on normalized (R, N, C) pair rows, side 1 and
    side 2 of every pair row, the rows in consecutive groups of
    ``group_sizes``. Returns (losses (G,), cd_means (G,)), differentiable in
    the code rows."""
    fd = torch.bmm(f1.detach().float(), f2.detach().float().transpose(1, 2))
    if code_bf16:
        cd = _Bf16CodeDot.apply(c1.float(), c2.float())
    else:
        cd = torch.bmm(c1.float(), c2.float().transpose(1, 2))
    cdc = torch.clamp(cd, *clamp_bounds(zero_clamp, stabalize))
    losses, cd_means, _ = finalize_rows((cdc * fd).sum(-1), cdc.sum(-1),
                                        fd.sum(-1), cd.sum(-1), shifts,
                                        group_sizes, pointwise)
    return losses, cd_means


def stream_loss(feats: torch.Tensor, code: torch.Tensor, idx1: torch.Tensor,
                idx2: torch.Tensor, shifts: Sequence[float],
                group_sizes: Sequence[int], pointwise: bool = True,
                zero_clamp: bool = True, stabalize: bool = False,
                code_bf16: bool = False, use_kernel: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Losses and cd means of the pair rows (idx1[r], idx2[r]) over the
    normalized maps ``feats`` (M, N, CF) and ``code`` (M, N, CC): kernel C2
    for CUDA tensors (``use_kernel=False`` takes the plain version there
    too), the plain version for CPU tensors."""
    if code.device.type == "cpu" or not use_kernel:
        return fused_correlation_loss_plain(
            feats[idx1], feats[idx2], code[idx1], code[idx2], shifts,
            group_sizes, pointwise, zero_clamp, stabalize, code_bf16)
    return _StreamCorr.apply(code, feats.detach(), idx1, idx2,
                             tuple(float(s) for s in shifts),
                             tuple(int(g) for g in group_sizes),
                             bool(pointwise), bool(zero_clamp),
                             bool(stabalize), bool(code_bf16))


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All pair types in one launch of each of C2's entries.

    ``pairs``: one (f1, f2, c1, c2) tuple of NHWC maps a pair type, all of
    one spatial size. A tensor (feature and code map together) that several
    pairs share is normalized once and read by index. ``pre_prepped`` and
    ``n_real`` keep the JAX signature; no caller in the port sets them:
    with ``pre_prepped`` the pairs are normalized (B, N, C) rows
    (:func:`prep`), and ``n_real``, where given, must be N (the port pads
    nothing). ``shifts``: one a pair
    type. ``feat_dtype``: the features' type in the fd product (the kernel
    takes bf16 only). ``code_bf16``: the code side in bf16 with f32 sums
    (``pallas_loss_bf16``). ``split_groups``: every pair type cut into that
    many equal groups, each with its own pointwise fd mean, and their losses
    averaged (``negatives_scope=local``). ``use_kernel=False`` takes the
    plain version on a CUDA tensor. Returns (losses, cd_means), one a pair
    type (``pallas_corr.py:364-461``)."""
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
    else:
        feats = [prep(f, feat_dtype).detach() for f, _, _ in maps]
        code = [prep(c) for _, c, _ in maps]
    losses, cd_means = stream_loss(
        torch.cat(feats), torch.cat(code), torch.cat(idx1), torch.cat(idx2),
        shifts, group_sizes, pointwise, zero_clamp, stabalize, code_bf16,
        use_kernel)
    return _merge(losses, cd_means, split_groups)


class _StreamCorr(torch.autograd.Function):
    """Kernel C2 as an autograd function of the normalized code maps."""

    @staticmethod
    def forward(ctx, code, feats, idx1, idx2, shifts, group_sizes,
                pointwise, zero_clamp, stabalize, code_bf16):
        dev = code.device
        if feats.dtype != torch.bfloat16:
            raise ValueError(
                f"kernel C2 takes bf16 features (a bf16 trunk's feat_dtype); "
                f"got {feats.dtype}")
        if code.dim() != 3 or feats.dim() != 3 \
                or feats.shape[:2] != code.shape[:2]:
            raise ValueError(f"feats {tuple(feats.shape)} and code "
                             f"{tuple(code.shape)} must be (M, N, C) of one "
                             f"(M, N)")
        m, n, cc = code.shape
        cf = feats.shape[-1]
        r = idx1.shape[0]
        for name, t in (("feats", feats), ("idx1", idx1), ("idx2", idx2)):
            if t.device != dev:
                raise ValueError(f"kernel C2 needs {name} on {dev}, got "
                                 f"{t.device}")
        if idx2.shape != (r,) or idx1.dim() != 1:
            raise ValueError(f"idx1 {tuple(idx1.shape)} and idx2 "
                             f"{tuple(idx2.shape)} must be (R,)")
        if not (cf <= MAX_FEAT_CHANNELS and cc <= MAX_CODE_CHANNELS):
            raise ValueError(
                f"kernel C2 takes <= {MAX_FEAT_CHANNELS} feature and <= "
                f"{MAX_CODE_CHANNELS} code channels; got {cf}, {cc}")
        feats = feats.contiguous()
        code = code.float().contiguous()
        i1 = idx1.to(torch.int32).contiguous()
        i2 = idx2.to(torch.int32).contiguous()
        acc = torch.empty((r, 4, n), dtype=torch.float32, device=dev)
        lo, hi = clamp_bounds(zero_clamp, stabalize)
        err = build.library().stego_corr_stream_fwd(
            feats.data_ptr(), code.data_ptr(), i1.data_ptr(), i2.data_ptr(),
            acc.data_ptr(), r, m, n, cf, cc, int(code_bf16), lo, hi,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "corr_stream forward kernel")
        global FWD_LAUNCHES
        FWD_LAUNCHES += 1
        losses, cd_means, gm = finalize_rows(acc[:, 0], acc[:, 1], acc[:, 2],
                                             acc[:, 3], shifts, group_sizes,
                                             pointwise)
        ctx.save_for_backward(code, feats, i1, i2, acc, gm)
        ctx.static = (shifts, group_sizes, pointwise, code_bf16, lo, hi)
        return losses, cd_means

    @staticmethod
    def backward(ctx, g_losses, g_cdms):
        code, feats, i1, i2, acc, gm = ctx.saved_tensors
        shifts, group_sizes, pointwise, code_bf16, lo, hi = ctx.static
        dev = code.device
        m, n, cc = code.shape
        r = i1.shape[0]
        inv_m = device_vector([1.0 / (size * n * n) for size in group_sizes],
                              dev)
        scal = torch.stack([g_losses.float(), g_cdms.float(), gm,
                            device_vector(shifts, dev), inv_m],
                           dim=1).contiguous()                   # (G, 5)
        row_group = device_ints([gi for gi, size in enumerate(group_sizes)
                                 for _ in range(size)], dev)
        # every map's pair rows, side 1 (entry r) then side 2 (entry R + r),
        # in a fixed order: a stable sort by map, no host synchronisation
        keys, order = torch.sort(torch.cat([i1, i2]), stable=True)
        order = order.to(torch.int32)
        offsets = torch.searchsorted(
            keys, torch.arange(m + 1, dtype=torch.int32, device=dev)
        ).to(torch.int32)
        dcode = torch.empty_like(code)
        err = build.library().stego_corr_stream_bwd(
            feats.data_ptr(), code.data_ptr(), i1.data_ptr(), i2.data_ptr(),
            acc.data_ptr(), scal.data_ptr(), row_group.data_ptr(),
            order.data_ptr(), offsets.data_ptr(), dcode.data_ptr(), r, m, n,
            feats.shape[-1], cc, int(code_bf16), lo, hi, int(pointwise),
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "corr_stream backward kernel")
        global BWD_LAUNCHES
        BWD_LAUNCHES += 1
        return (dcode, None, None, None, None, None, None, None, None, None)


def _full_field(cfg: CorrLossCfg, orig_feats, orig_feats_pos, orig_code,
                orig_code_pos, perms, feat_dtype, code_bf16, use_kernel):
    """The dense loss over every (pixel, pixel) pair (:538-565): each
    distinct map normalized once; the pair rows are the self pair, the
    KNN-positive pair and one group per negative, whose side 2 is read as
    ``code[perm_k(b)]`` by index."""
    b = orig_feats.shape[0]
    fp = prep(orig_feats, feat_dtype).detach()
    fpp = prep(orig_feats_pos, feat_dtype).detach()
    cp, cpp = prep(orig_code), prep(orig_code_pos)
    dev = cp.device
    ar = torch.arange(b, device=dev)
    idx1 = ar.repeat(2 + len(perms))
    idx2 = torch.cat([ar, ar + b] + [p.to(dev).long() for p in perms])
    group_sizes, shifts = _split([b] * (2 + len(perms)), cfg.shifts,
                                 cfg.neg_blocks)
    losses, cd_means = stream_loss(torch.cat([fp, fpp]),
                                   torch.cat([cp, cpp]), idx1, idx2, shifts,
                                   group_sizes, cfg.pointwise,
                                   cfg.zero_clamp, cfg.stabalize, code_bf16,
                                   use_kernel)
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
    the train step is held against them on the card."""
    if cfg.use_salience:
        raise salience_not_ported()
    if len(perms) != cfg.neg_samples:
        raise ValueError(f"{len(perms)} permutations for neg_samples="
                         f"{cfg.neg_samples}")
    has_neg = cfg.neg_samples > 0
    code = code_pos = code_neg = None
    if full_field:
        losses, cd_means = _full_field(cfg, orig_feats, orig_feats_pos,
                                       orig_code, orig_code_pos, perms,
                                       feat_dtype, code_bf16, use_kernel)
    elif sampling_impl == "fused":
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
        b, h, w = orig_feats.shape[:3]
        grid_hw = coords1.shape[2], coords1.shape[1]  # transposed grid
        w1, w2 = (bilinear_sample_weights((h, w), c.transpose(1, 2))
                  for c in (coords1, coords2))

        def sample(wm, t):
            out = torch.bmm(wm, t.reshape(t.shape[0], h * w, -1).float())
            return out.reshape(t.shape[0], *grid_hw, t.shape[-1])

        feats = sample(w1, orig_feats)
        code = sample(w1, orig_code)
        feats_pos = sample(w2, orig_feats_pos)
        code_pos = sample(w2, orig_code_pos)
        pairs = [(feats, feats, code, code), (feats, feats_pos, code,
                                              code_pos)]
        if has_neg:
            feats_neg = torch.cat([sample(w2, orig_feats[p]) for p in perms])
            code_neg = torch.cat([sample(w2, orig_code[p]) for p in perms])
            pairs += [(feats, feats_neg[k * b:(k + 1) * b], code,
                       code_neg[k * b:(k + 1) * b])
                      for k in range(len(perms))]
        losses, cd_means = fused_correlation_loss_multi(
            pairs, cfg.shifts, pointwise=cfg.pointwise,
            zero_clamp=cfg.zero_clamp, stabalize=cfg.stabalize,
            feat_dtype=feat_dtype, code_bf16=code_bf16,
            split_groups=cfg.neg_blocks, use_kernel=use_kernel)
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
