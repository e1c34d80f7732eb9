"""Smoke run of stego_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from stego_torch/csrc with nvcc (one process a source, started
   together).
2. Holds kernel L (LayerNorm) and kernel A (attention) against their plain
   PyTorch versions at the shapes the trunk gives them, and times both,
   beside F.layer_norm and F.scaled_dot_product_attention (timed only: the
   port never calls them); L also cold, on rotating inputs larger than L2.
3. Serves flip-TTA requests with a seeded ViT-S/8 STEGO segmenter at full
   width (cocostuff27 head: dim 70, nonlinear, 27 classes, bf16 trunk):
   3 requests of 8 images at res 224, then 3 at res 320, through
   load_model_for_eval and make_eval_step, after a round trip through a
   .ckpt. Each request must launch each kernel a fixed number of times, and
   its code and predictions must agree with the same batch through the
   plain versions on the card.
4. Holds kernel C1 (the sampled correlation loss, forward and backward)
   against its plain version at the train step's shapes, and times both.
5. Holds kernel C2 (the streamed correlation loss, forward and backward)
   against its plain version at the full-field shape (7 dense 784 x 784
   fields of 16 images) and the grid-sampled shape (121 samples), with f32
   and with bf16 code (code_bf16), and times both; the f32 kernel, which
   ignores code_bf16, must fail the code_bf16 gate.
6. Trains: 20 steps of make_train_step at the reference footprint
   (src/configs/train_config.yml: ViT-S/8, res 224, batch 16, 11 x 11
   samples, 5 negatives, dropout) on one fixed synthetic batch, each
   launching C1 forward and backward once and the trunk's kernels once
   over img || img_pos; the loss must fall. One step with C1 is held
   against the same step with C1's plain version. Then 3 val steps
   (make_val_step) at res 320.
7. Trains with the streamed loss C2: 10 full-field steps (full_field_loss)
   at the same footprint, whose loss must fall (then timed also with C2's
   plain version), then 3 steps each with
   fused_sampling="off" and pallas_loss_bf16; each step launches C2 forward
   and backward once and C1 never, and one step of each is held against
   the same step with C2's plain version.

Prints one JSON line with the kernels' results (times, launches on the
main paths, errors against the plain versions, the least time the card
could take for the same work, and the library call's time where one
PyTorch call computes the same function), the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Exits non-zero, without that line,
when there is no CUDA device, a kernel does not build or launch, or a check
fails. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

BATCH = 8
REQUESTS = 3
RESOLUTIONS = (224, 320)
HEADS, HEAD_DIM, EMBED = 6, 64, 384  # ViT-S/8
LN_SHAPES = [(8 * 785, EMBED), (8 * 1601, EMBED)]
ATTN_SHAPES = [(8, 785), (8, 1601), (2, 3137)]
ATTN_RTOL, ATTN_ATOL = 2e-2, 5e-3  # attention rows of PARITY_r05.json
CODE_MAX_ABS, CODE_MEAN_ABS, PRED_AGREE = 6e-2, 4e-3, 0.99
# per request: 2 trunk calls x (12 attention sublayers, 25 LayerNorms)
ATTN_PER_REQUEST, LN_PER_REQUEST = 2 * 12, 2 * 25
# the train step's footprint (src/configs/train_config.yml)
TRAIN_BATCH, TRAIN_RES, VAL_RES = 16, 224, 320
TRAIN_STEPS, HIST_STEPS, VAL_STEPS = 20, (0, 10), 3
CORR_SHAPE = dict(b=16, hw=28, cf=384, cc=70, s=11, neg=5)
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6  # sampled-loss rows of PARITY_r05.json
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5  # tests/test_fused_sampling.py:265
# the streamed loss: full-field maps, grid-sampled maps (PARITY_r05's corr
# rows: losses and cd rtol 1e-4 atol 1e-5, code gradients as above)
STREAM_SHAPES = (("full-field", 28), ("grid-sampled", 11))
STREAM_RTOL, STREAM_ATOL = 1e-4, 1e-5
# code_bf16: both versions compute cd in other orders, so a cd within an
# f32 rounding of the clamp's bound may fall inside the mask in one and
# outside in the other; each such element moves a code gradient row by up
# to ~2**-8 of the largest gradient (the weights make it 1). So: every code
# gradient within BF16_GRAD_ATOL, and at least BF16_GRAD_SHARE of them
# within the f32 tolerance (GRAD_RTOL, GRAD_ATOL). Not rounding dL/dcd to
# bf16 (8 significant bits) moves nearly every element by ~2**-9 of its
# row's size; phase C2 checks that both controls, the f32 kernel on the raw
# and on the bf16-rounded code, fail this gate. The step's updated
# parameters: within a tenth of lr (5e-4), the most a first Adam step moves
# a parameter whose gradient is below 1e-9 (lr g / (|g| + 1e-8)); the step
# with the f32 kernel must fail that.
BF16_GRAD_ATOL, BF16_GRAD_SHARE, BF16_PARAM_ATOL = 2 ** -7, 0.99, 5e-5
FULL_STEPS, SHORT_STEPS = 10, 3
# counted launches: attention, LN, C1 forward/backward, C2 forward/backward
COUNTS = ("attention", "layer_norm", "corr_sampled_fwd", "corr_sampled_bwd",
          "corr_stream_fwd", "corr_stream_bwd")
# H100 SXM at 700 W, dense (NVIDIA data sheet): FLOP/s by operand
# type and HBM bytes/s, for the least time a kernel's work could take
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20

failures: list[str] = []


def check(ok: bool, what: str) -> bool:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)
    return ok


def within(diff, tol, want) -> bool:
    """All of ``diff`` within ``tol``; else prints the count and the worst
    element."""
    bad = diff > tol
    if not bool(bad.any()):
        return True
    i = int(torch.argmax(diff / tol))
    print(f"  {int(bad.sum())} of {diff.numel()} elements out of tolerance; "
          f"worst: diff {float(diff.flatten()[i]):.3e}, tolerance "
          f"{float(tol.flatten()[i]):.3e}, reference "
          f"{float(want.flatten()[i]):.6e}")
    return False


def call_ms(fn, iters: int = 20) -> float:
    """Mean time of one call of ``fn`` in ms, launch overhead included:
    CUDA events around ``iters`` calls after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn, iters: int = 1, attempts: int = 3) -> dict:
    """Device microseconds by kernel name over ``iters`` calls of ``fn``,
    from the profiler's CUDA trace (after one warm-up call). The trace
    now and then comes back without device events; the window is then
    traced again, up to ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                times[e.name] = times.get(e.name, 0.0) \
                    + e.time_range.elapsed_us()
        if times:
            return times
        print("  (the profiler's trace held no device events; tracing again)")
    raise RuntimeError(f"the profiler recorded no device time in {attempts} "
                       f"traces")


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn`` in ms: the summed durations of the
    kernels it launches."""
    return sum(kernel_times(fn, iters).values()) / iters / 1e3


def compare_times(kernel, plain):
    """{device, call} x {kernel, plain} ms, timed in turns plain, kernel,
    kernel, plain."""
    out = {}
    for what, timer in (("device", device_ms), ("call", call_ms)):
        p1, k1, k2, p2 = timer(plain), timer(kernel), timer(kernel), \
            timer(plain)
        out[what] = ((k1 + k2) / 2, (p1 + p2) / 2)
    return out


def bound(flops: dict, nbytes: float):
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``flops`` (operations by type, each at its peak rate) and
    ``nbytes`` (inputs read once, outputs written once)."""
    t_ops = sum(f / PEAK_FLOPS[kind] for kind, f in flops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound_text(b) -> str:
    return f"bound {b[0]:.4f} ms ({b[1]}, H100 SXM peaks)"


def timing_text(t) -> str:
    return (f"device kernel {t['device'][0]:.4f} ms, plain "
            f"{t['device'][1]:.4f} ms; per call with launch: kernel "
            f"{t['call'][0]:.4f} ms, plain {t['call'][1]:.4f} ms")


def cold_ms(fn, inputs) -> float:
    """Device time of one call of ``fn`` when its input is not in L2: one
    call on each of ``inputs`` in turn (together larger than L2), from the
    profiler's trace."""
    def sweep():
        for x in inputs:
            fn(x)

    return sum(kernel_times(sweep, 3).values()) / (3 * len(inputs)) / 1e3


def phase_layer_norm(dev):
    import torch.nn.functional as F

    from stego_torch.ops import layer_norm as ln

    print("kernel L (layer_norm) vs plain, bf16, within one bf16 ulp; "
          "library: F.layer_norm with bf16 weights (it takes no f32 "
          "weights with a bf16 input on the card)")
    g = torch.Generator(device=dev).manual_seed(0)
    worst, first = 0.0, None
    for rows, d in LN_SHAPES:
        x = (torch.randn(rows, d, generator=g, device=dev) * 3 + 1.5) \
            .bfloat16()
        w = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        b = 0.1 * torch.randn(d, generator=g, device=dev)
        got = ln.fused_layer_norm(x, w, b, 1e-6)
        torch.cuda.synchronize()
        want = ln.layer_norm_plain(x, w, b, 1e-6)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        worst = max(worst, err)
        t = compare_times(lambda: ln.fused_layer_norm(x, w, b, 1e-6),
                          lambda: ln.layer_norm_plain(x, w, b, 1e-6))
        wb, bb = w.bfloat16(), b.bfloat16()
        lib = device_ms(lambda: F.layer_norm(x, (d,), wb, bb, 1e-6))
        copies = -(-2 * L2_BYTES // x.nbytes)
        xs = [x + i for i in range(copies)]
        cold = cold_ms(lambda xi: ln.fused_layer_norm(xi, w, b, 1e-6), xs)
        lib_cold = cold_ms(lambda xi: F.layer_norm(xi, (d,), wb, bb, 1e-6),
                           xs)
        del xs
        # 2 bf16 bytes read and written an element, f32 weight and bias;
        # ~8 f32 operations an element (mean, variance, normalise, affine)
        bnd = bound({"f32": 8 * rows * d}, 4 * rows * d + 8 * d)
        check(within(diff, ln.bf16_ulp_tolerance(want), want),
              f"({rows}, {d}): max_abs_err {err:.3e}; {timing_text(t)}; "
              f"cold (inputs {copies} x {x.nbytes / 2**20:.1f} MiB in "
              f"turn): kernel {cold:.4f} ms, F.layer_norm {lib_cold:.4f} "
              f"ms; warm F.layer_norm {lib:.4f} ms; {bound_text(bnd)}")
        if first is None:
            first = dict(ms=t["device"][0], plain_ms=t["device"][1],
                         cold_ms=cold, library_ms=lib, bound=bnd)
    return worst, first


def packed_qkv(b, n, gen, dev):
    """(B, N, 3 * EMBED) bf16: q and k drawn N(0, 1) * 2 so softmax rows are
    peaked, v drawn N(0, 1). Scaling v would only scale the output and its
    absolute error: the kernel and the plain version each round p to bf16,
    and a one-ulp difference on a large p moves the output by ~2**-8 |v|."""
    qkv = torch.randn(b, n, 3 * EMBED, generator=gen, device=dev)
    qkv[..., :2 * EMBED] *= 2
    return qkv.bfloat16()


def phase_attention(dev):
    from stego_torch.ops import flash_attention as fa

    import torch.nn.functional as F

    print(f"kernel A (attention) vs plain, bf16, H={HEADS} d={HEAD_DIM}, "
          f"q, k ~ N(0, 4), v ~ N(0, 1), rtol {ATTN_RTOL} atol {ATTN_ATOL}; "
          f"library: F.scaled_dot_product_attention on (B, H, N, d)")
    g = torch.Generator(device=dev).manual_seed(1)
    worst, first = 0.0, None
    for b, n in ATTN_SHAPES:
        # q, k, v as the column blocks of one packed qkv, as in the trunk
        q, k, v = packed_qkv(b, n, g, dev).split(EMBED, dim=-1)
        scale = HEAD_DIM ** -0.5
        got = fa.token_major_attention(q, k, v, HEADS, scale)
        torch.cuda.synchronize()
        want = fa.attention_plain(q, k, v, HEADS, scale)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        worst = max(worst, err)
        ok = within(diff, ATTN_ATOL + ATTN_RTOL * want.float().abs(), want)
        t = compare_times(
            lambda: fa.token_major_attention(q, k, v, HEADS, scale),
            lambda: fa.attention_plain(q, k, v, HEADS, scale))
        qh, kh, vh = (x.reshape(b, n, HEADS, HEAD_DIM).transpose(1, 2)
                      .contiguous() for x in (q, k, v))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale))
        # q k^T and p v: 4 N^2 d bf16 operations a head; q, k, v, out once
        bnd = bound({"bf16": 4 * b * HEADS * n * n * HEAD_DIM},
                    4 * b * n * EMBED * 2)
        check(ok, f"(B={b}, N={n}): max_abs_err {err:.3e}; {timing_text(t)}; "
                  f"F.scaled_dot_product_attention {lib:.4f} ms; "
                  f"{bound_text(bnd)}")
        if first is None:
            first = dict(ms=t["device"][0], plain_ms=t["device"][1],
                         library_ms=lib, bound=bnd)
    return worst, first


def images(gen, res, dev, batch=BATCH):
    """A batch of random [0, 1] images, ImageNet-normalized, NHWC."""
    from stego_torch.data.transforms import channel_stats

    mean, std = (torch.as_tensor(s, device=dev) for s in channel_stats(3))
    img01 = torch.rand(batch, res, res, 3, generator=gen, device=dev)
    return (img01 - mean) / std


def phase_slice(dev, tmp):
    from stego_torch.config import Config
    from stego_torch.eval.evaluate import (flip_tta_code, load_model_for_eval,
                                           make_eval_step)
    from stego_torch.models import convert
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln
    from stego_torch.train.segmenter import UnsupervisedSegmenter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("slice: seeded ViT-S/8 segmenter, cocostuff27 head, bf16 trunk")
    cfg = Config(dataset_name="cocostuff27", model_type="vit_small",
                 dino_patch_size=8, dim=70, projection_type="nonlinear",
                 backbone_dtype="bfloat16", run_crf=False)
    seeded = UnsupervisedSegmenter(27, cfg,
                                   generator=torch.Generator().manual_seed(0))
    path = os.path.join(tmp, "vit_small_8_seed0.ckpt")
    convert.save_stego_checkpoint(path, seeded)
    loaded = convert.load_stego_checkpoint(path)
    want = seeded.state_dict()
    check(loaded.cfg == cfg and loaded.state_dict().keys() == want.keys()
          and all(torch.equal(v, want[k])
                  for k, v in loaded.state_dict().items()),
          "round trip through save/load_stego_checkpoint: tensors equal")
    again = convert.from_jax_params(*convert.to_jax_params(seeded), cfg)
    check(all(torch.equal(v, want[k]) for k, v in again.state_dict().items()),
          "round trip through to/from_jax_params: tensors equal")

    seg = load_model_for_eval(path, dev)
    step = make_eval_step(seg, run_crf=False)
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = {res: [images(gen, res, dev) for _ in range(REQUESTS)]
               for res in RESOLUTIONS}
    torch.cuda.synchronize()

    # the main path: every launch from here to the read below is counted
    fa.LAUNCHES = 0
    ln.LAUNCHES = 0
    served = {}
    for res, imgs in batches.items():
        for img in imgs:
            a0, l0 = fa.LAUNCHES, ln.LAUNCHES
            t0 = time.perf_counter()
            preds = step(img, img[..., 0])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            served.setdefault(res, []).append((ms, preds))
            check(fa.LAUNCHES - a0 == ATTN_PER_REQUEST
                  and ln.LAUNCHES - l0 == LN_PER_REQUEST,
                  f"res {res} request: {ms:.2f} ms, attention launches "
                  f"{fa.LAUNCHES - a0}, layer_norm launches "
                  f"{ln.LAUNCHES - l0}")
    launches = {"attention": fa.LAUNCHES, "layer_norm": ln.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    for res, runs in served.items():
        med = statistics.median(ms for ms, _ in runs)
        img = batches[res][-1]
        by_kernel = kernel_times(lambda: step(img, img[..., 0]))
        busy = sum(by_kernel.values()) / 1e3
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        print(f"  res {res}: median {med:.2f} ms per request of {BATCH}, "
              f"{BATCH / med * 1e3:.1f} images/s; device busy {busy:.3f} ms "
              f"a request ({busy / med:.0%} of the median)")
        for name, us in top:
            print(f"    {us / 1e3:8.3f} ms  {name[:90]}")
        with torch.inference_mode():
            code = flip_tta_code(seg, img)
            seg.net.model.use_kernels = False
            plain_code = flip_tta_code(seg, img)
            plain_preds = step(img, img[..., 0])
            seg.net.model.use_kernels = True
        hp = res // seg.vit_cfg.patch_size
        check(code.shape == (BATCH, hp, hp, 70)
              and bool(torch.isfinite(code).all()),
              f"res {res}: code {tuple(code.shape)} f32, finite")
        diff = (code - plain_code).abs()
        check(float(diff.max()) <= CODE_MAX_ABS
              and float(diff.mean()) <= CODE_MEAN_ABS,
              f"res {res}: code vs plain versions: max abs "
              f"{float(diff.max()):.3e} (<= {CODE_MAX_ABS}), mean abs "
              f"{float(diff.mean()):.3e} (<= {CODE_MEAN_ABS})")
        for name, got, want_p in zip(("linear", "cluster"), runs[-1][1],
                                     plain_preds):
            agree = float((got == want_p).float().mean())
            check(got.shape == (BATCH, res, res) and got.dtype == torch.int32
                  and int(got.min()) >= 0 and int(got.max()) < 27
                  and agree >= PRED_AGREE,
                  f"res {res}: {name} predictions {tuple(got.shape)}, "
                  f"agree with plain on {agree:.4%} (>= {PRED_AGREE:.0%})")
    print(f"  peak device memory {peak_gb:.2f} GiB")
    return launches


def corr_inputs(dev, b, hw, cf, cc, s, neg, seed):
    """Seeded inputs of kernel C1 at the train step's shapes: f32 feature
    and code maps (as the trunk and head give them), U(-1, 1) coordinates,
    super_perm negatives, and the weights of a random combination of the
    losses and cd means to take gradients of."""
    from stego_torch.ops.math import super_perm

    g = torch.Generator(device=dev).manual_seed(seed)
    feats = [torch.randn(b, hw, hw, cf, generator=g, device=dev)
             for _ in range(2)]
    code = [torch.randn(b, hw, hw, cc, generator=g, device=dev)
            for _ in range(2)]
    coords = [torch.rand(b, s, s, 2, generator=g, device=dev) * 2 - 1
              for _ in range(2)]
    perms = [super_perm(b, g) for _ in range(neg)]
    weights = torch.randn(2, 2 + neg, generator=g, device=dev)
    return feats, code, coords, perms, weights


def phase_corr(dev):
    from stego_torch.ops import corr_fused_sampling as c1

    sh = CORR_SHAPE
    print(f"kernel C1 (corr_sampled) vs plain: B={sh['b']}, {sh['hw']}x"
          f"{sh['hw']} maps, feats {sh['cf']} in bf16, code {sh['cc']} f32, "
          f"{sh['s']}x{sh['s']} samples, {sh['neg']} negatives; losses and "
          f"cd rtol {LOSS_RTOL} atol {LOSS_ATOL}, code grads rtol "
          f"{GRAD_RTOL} atol {GRAD_ATOL}")
    feats, code, coords, perms, wts = corr_inputs(dev, **sh, seed=3)
    shifts = [0.18, 0.12] + [0.46] * sh["neg"]
    errs = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for opts in (dict(pointwise=True, zero_clamp=True),
                 dict(pointwise=False, stabalize=True)):
        def forward(fn):
            c = [x.clone().requires_grad_(True) for x in code]
            losses, cds = fn(feats[0], feats[1], c[0], c[1], coords[0],
                             coords[1], perms, shifts,
                             feat_dtype=torch.bfloat16, **opts)
            total = (losses * wts[0]).sum() + (cds * wts[1]).sum()
            return losses, cds, total, c

        def run(fn):
            losses, cds, total, c = forward(fn)
            return (losses.detach(), cds.detach(),
                    *torch.autograd.grad(total, c))

        wts = unit_gradient_weights(wts, run, c1.sampled_corr_plain)
        got = run(c1.sampled_corr_fused)
        torch.cuda.synchronize()
        want = run(c1.sampled_corr_plain)
        label = ", ".join(f"{k}={v}" for k, v in opts.items())
        hold_to_plain(label, got, want, errs, (LOSS_RTOL, LOSS_ATOL),
                      (GRAD_RTOL, GRAD_ATOL))
        if not times:
            times = time_fwd_bwd(forward, run, c1.sampled_corr_fused,
                                 c1.sampled_corr_plain)
    bounds = c1_bounds(**sh)
    print(f"  forward {bound_text(bounds['fwd'])}; backward "
          f"{bound_text(bounds['bwd'])}")
    return errs, times, bounds


def c1_bounds(b, hw, cf, cc, s, neg):
    """C1's least times, forward and backward, all f32 FMA (the kernel
    keeps the TPU's rounding points, so no tensor cores). Forward: fd and
    cd of every slot (S x S x (cf + cc) multiply-adds, S = s * s samples)
    and the 4-tap sampling of both sides; it reads the bf16 feature and f32
    code maps and the coordinates and writes the row sums, z2cn and fd.
    Backward: cd again, dz1 and dz2, the normalise Jacobian and the 4-tap
    scatter; it reads the residuals and writes the code gradients."""
    n, ss, slots = hw * hw, s * s, (2 + neg) * b
    coords = 2 * b * ss * 2 * 4
    resid = slots * (5 * ss + ss * cc + ss * ss) * 4
    fwd = bound({"f32": 2 * slots * ss * ss * (cf + cc)
                 + 2 * slots * 2 * ss * 4 * (cf + cc)},
                2 * b * n * (2 * cf + 4 * cc) + coords + resid)
    bwd = bound({"f32": 3 * 2 * slots * ss * ss * cc
                 + 2 * slots * 2 * ss * 6 * cc},
                resid + coords + 2 * b * n * cc * 4)
    return {"fwd": fwd, "bwd": bwd}


def unit_gradient_weights(wts, run, plain):
    """``wts`` scaled so that the plain version's largest code gradient is
    1. At weights of order 1 the code gradients of a full-field loss are
    ~1e-7 and any atol of 1e-5 holds; at unit scale the gradient tolerances
    measure the error against the gradient's own size."""
    return wts / max(float(g.abs().max()) for g in run(plain)[2:])


def agreement(got, want, loss_tol, grad_tol, share=None, verbose=True):
    """(losses, cd means, *code gradients) of a kernel against its plain
    version, by part ("fwd": losses and cd means within ``loss_tol``
    (rtol, atol); "bwd": code gradients within ``grad_tol``, and with
    ``share`` at least that share of them within the f32 tolerance
    (GRAD_RTOL, GRAD_ATOL)): {part: (ok, text)}. ``verbose`` prints the
    worst element of a part out of tolerance."""
    out = {}
    for what, sl, (rtol, atol) in (("fwd", slice(0, 2), loss_tol),
                                   ("bwd", slice(2, None), grad_tol)):
        diffs = [(g - w).abs() for g, w in zip(got[sl], want[sl])]
        tols = [atol + rtol * w.abs() for w in want[sl]]
        err = max(float(d.max()) for d in diffs)
        ok = all([within(d, t, w) if verbose else bool((d <= t).all())
                  for d, t, w in zip(diffs, tols, want[sl])])
        ratio = max(float((d / t).max()) for d, t in zip(diffs, tols))
        scale = max(float(w.abs().max()) for w in want[sl])
        name = "losses and cd means" if what == "fwd" else "code gradients"
        text = (f"{name}, max_abs_err {err:.3e} (largest |value| "
                f"{scale:.3e}; worst error / tolerance {ratio:.3f})")
        if what == "bwd" and share is not None:
            inside = sum(int((d <= GRAD_ATOL + GRAD_RTOL * w.abs()).sum())
                         for d, w in zip(diffs, want[sl]))
            frac = inside / sum(d.numel() for d in diffs)
            ok = ok and frac >= share
            text += (f", {frac:.4%} within rtol {GRAD_RTOL} atol {GRAD_ATOL}"
                     f" (>= {share:.0%})")
        out[what] = (ok, text, err)
    return out


def hold_to_plain(label, got, want, errs, loss_tol, grad_tol, share=None):
    """Checks :func:`agreement` of a kernel with its plain version; keeps
    the largest absolute errors in ``errs``."""
    for what, (ok, text, err) in agreement(got, want, loss_tol, grad_tol,
                                           share).items():
        errs[what] = max(errs[what], err)
        check(ok, f"{label}: {text}")


def time_fwd_bwd(forward, run, kernel, plain):
    """Device and per-call times of the forward, forward+backward and
    backward alone of a kernel and its plain version; returns the device
    times {"fwd": (kernel, plain), "bwd": (kernel, plain)}."""
    t_fwd = compare_times(lambda: forward(kernel), lambda: forward(plain))
    t_all = compare_times(lambda: run(kernel), lambda: run(plain))
    _, _, tk, ck = forward(kernel)
    _, _, tp, cp = forward(plain)
    t_bwd = compare_times(
        lambda: torch.autograd.grad(tk, ck, retain_graph=True),
        lambda: torch.autograd.grad(tp, cp, retain_graph=True))
    for what, t in (("forward", t_fwd), ("forward+backward", t_all),
                    ("backward alone", t_bwd)):
        print(f"  {what}: {timing_text(t)}")
    return {"fwd": t_fwd["device"], "bwd": t_bwd["device"]}


def stream_inputs(dev, b, hw, cf, cc, neg, distinct, seed):
    """Seeded inputs of kernel C2 as the train step builds them
    (ops/corr_stream.py): normalized bf16 feature and f32 code maps, and the
    pair rows of the self pair, the positive pair and ``neg`` negatives.
    Full-field (``distinct=False``): the maps of the b images and of their
    positives, negatives read by index. Grid-sampled (``distinct=True``):
    one map set a pair type, as the sampled pairs are."""
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops.math import super_perm

    g = torch.Generator(device=dev).manual_seed(seed)
    m = (2 + neg if distinct else 2) * b
    feats = c2.prep(torch.randn(m, hw, hw, cf, generator=g, device=dev),
                    torch.bfloat16)
    code = c2.prep(torch.randn(m, hw, hw, cc, generator=g, device=dev))
    ar = torch.arange(b, device=dev)
    idx1 = ar.repeat(2 + neg)
    idx2 = (torch.arange(m, device=dev) if distinct else
            torch.cat([ar, ar + b] + [super_perm(b, g) for _ in range(neg)]))
    weights = torch.randn(2, 2 + neg, generator=g, device=dev)
    return feats, code, idx1, idx2, weights


def c2_bounds(rows, maps, n, cf, cc, code_bf16):
    """C2's least times, forward and backward. Forward: fd, a bf16 product
    of n x n x cf a pair row, and cd, n x n x cc in f32 (bf16 with
    code_bf16); it reads the maps and writes the row sums. Backward: fd and
    cd again and the two contractions coeff c2 and coeff^T c1 (n x n x cc
    each); it reads the maps and the row sums and writes the code
    gradients."""
    fd = 2 * rows * n * n * cf
    cd = 2 * rows * n * n * cc
    code_type = "bf16" if code_bf16 else "f32"
    maps_bytes = maps * n * (2 * cf + 4 * cc)
    sums = rows * 4 * n * 4
    fwd_ops, bwd_ops = {"bf16": fd, "f32": 0}, {"bf16": fd, "f32": 0}
    fwd_ops[code_type] += cd
    bwd_ops[code_type] += 3 * cd
    fwd = bound(fwd_ops, maps_bytes + sums)
    bwd = bound(bwd_ops, maps_bytes + sums + maps * n * cc * 4)
    return {"fwd": fwd, "bwd": bwd}


def phase_corr_stream(dev):
    from stego_torch.ops import corr_stream as c2

    sh = CORR_SHAPE
    b, cf, cc, neg = sh["b"], sh["cf"], sh["cc"], sh["neg"]
    print(f"kernel C2 (corr_stream) vs plain: B={b}, feats {cf} in bf16, "
          f"code {cc} f32, {neg} negatives; losses and cd rtol "
          f"{STREAM_RTOL} atol {STREAM_ATOL}, code grads rtol {GRAD_RTOL} "
          f"atol {GRAD_ATOL}")
    shifts = [0.18, 0.12] + [0.46] * neg
    groups = [b] * (2 + neg)
    out = {}
    zero_clamp = dict(pointwise=True, zero_clamp=True)  # the train runs'
    cases = [(name, hw, False, opts) for name, hw in STREAM_SHAPES
             for opts in (zero_clamp, dict(pointwise=False, stabalize=True))]
    # code_bf16 at the shape of the path that runs it (pallas_loss_bf16,
    # grid-sampled), then at the full-field shape
    cases += [(name, hw, True, zero_clamp) for name, hw in STREAM_SHAPES[::-1]]
    for name, hw, code_bf16, opts in cases:
        key = (name, code_bf16)
        distinct = name == "grid-sampled"
        feats, code, idx1, idx2, wts = stream_inputs(
            dev, b, hw, cf, cc, neg, distinct, seed=hw + code_bf16)

        def forward(use_kernel, code_in=code, bf16=code_bf16):
            c = code_in.clone().requires_grad_(True)
            losses, cds = c2.stream_loss(feats, c, idx1, idx2, shifts,
                                         groups, code_bf16=bf16,
                                         use_kernel=use_kernel, **opts)
            total = (losses * wts[0]).sum() + (cds * wts[1]).sum()
            return losses, cds, total, c

        def run(use_kernel, **kw):
            losses, cds, total, c = forward(use_kernel, **kw)
            return (losses.detach(), cds.detach(),
                    *torch.autograd.grad(total, c))

        wts = unit_gradient_weights(wts, run, False)
        got = run(True)
        torch.cuda.synchronize()
        want = run(False)
        again = run(True)
        res = out.setdefault(key, {"errs": {"fwd": 0.0, "bwd": 0.0}})
        grad_tol = (GRAD_RTOL, BF16_GRAD_ATOL if code_bf16 else GRAD_ATOL)
        share = BF16_GRAD_SHARE if code_bf16 else None
        label = (f"{name} (N={hw * hw}, {idx1.numel()} pair rows, "
                 f"{feats.shape[0]} maps)"
                 f"{', code_bf16' if code_bf16 else ''}, "
                 + ", ".join(f"{k}={v}" for k, v in opts.items())
                 + f"; code grads rtol {grad_tol[0]} atol {grad_tol[1]}")
        hold_to_plain(label, got, want, res["errs"],
                      (STREAM_RTOL, STREAM_ATOL), grad_tol, share)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{label}: two kernel runs bitwise equal")
        if code_bf16:
            # controls: kernels that ignore code_bf16 must fail the gate
            for what, code_in in (("raw", code),
                                  ("bf16-rounded", code.bfloat16().float())):
                ctl = agreement(run(True, code_in=code_in, bf16=False), want,
                                (STREAM_RTOL, STREAM_ATOL), grad_tol, share,
                                verbose=False)
                verdict = {k: "passes" if v[0] else "fails"
                           for k, v in ctl.items()}
                check(not (ctl["fwd"][0] and ctl["bwd"][0]),
                      f"control, f32 kernel on the {what} code against the "
                      f"code_bf16 plain version: forward {verdict['fwd']} "
                      f"({ctl['fwd'][1]}); backward {verdict['bwd']} "
                      f"({ctl['bwd'][1]})")
        if "times" in res:
            continue
        res["times"] = time_fwd_bwd(forward, run, True, False)
        res["bounds"] = c2_bounds(idx1.numel(), feats.shape[0], hw * hw, cf,
                                  cc, code_bf16)
        print(f"  forward {bound_text(res['bounds']['fwd'])}; backward "
              f"{bound_text(res['bounds']['bwd'])}")
    return out


def train_counts():
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln

    return (fa.LAUNCHES, ln.LAUNCHES, c1.FWD_LAUNCHES, c1.BWD_LAUNCHES,
            c2.FWD_LAUNCHES, c2.BWD_LAUNCHES)


def reset_counts():
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln

    fa.LAUNCHES = ln.LAUNCHES = c1.FWD_LAUNCHES = c1.BWD_LAUNCHES = 0
    c2.FWD_LAUNCHES = c2.BWD_LAUNCHES = 0


def compare_steps(ref, batch, rand, kernel, param_atol=GRAD_ATOL):
    """One train step from ``ref``'s state with the loss's kernel
    (``kernel``, C1 or C2) and one with its plain version (trunk kernels on
    in both): metrics within rtol LOSS_RTOL, atol LOSS_ATOL, updated
    parameters within rtol GRAD_RTOL, atol ``param_atol``; then one with
    every kernel off, reported only. With ``pallas_loss_bf16``, a step with
    the kernel ignoring it (the f32 kernel) must fail the parameter gate."""
    def one_step(use_kernels, use_corr_kernel, ignore_code_bf16=False):
        from stego_torch.train.segmenter import make_train_step

        seg = copy.deepcopy(ref)
        seg.net.model.use_kernels = use_kernels
        seg.use_corr_kernel = use_corr_kernel
        step = make_train_step(seg, with_hist=False)
        if ignore_code_bf16:  # the sampler stays the one resolved above
            seg.cfg = dataclasses.replace(seg.cfg, pallas_loss_bf16=False)
        metrics = step(batch, rand)
        return metrics, {n: p.detach() for n, p in seg.named_parameters()}, \
            {n: p.grad for n, p in seg.named_parameters()}

    def grad_gap(ga, gb):
        """|ga - gb| / |gb| over every parameter's gradient."""
        pairs = [(ga[n], gb[n]) for n in gb if gb[n] is not None]
        num = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
        return math.sqrt(num / sum(float((b ** 2).sum()) for _, b in pairs))

    def param_gap(pa, pb):
        return max(float((pa[n] - pb[n]).abs().max()) for n in pb)

    mk, pk, gk = one_step(True, True)
    mp, pp, gp = one_step(True, False)
    m0, _, _ = one_step(False, False)
    print(f"  gradients with {kernel} vs {kernel} plain: |g_kernel - "
          f"g_plain| / |g_plain| = {grad_gap(gk, gp):.3e} (report only)")
    if ref.cfg.pallas_loss_bf16:
        _, pc, gc = one_step(True, True, ignore_code_bf16=True)
        inside = all(bool(((pc[n] - pp[n]).abs()
                           <= param_atol + GRAD_RTOL * pp[n].abs()).all())
                     for n in pp)
        check(not inside,
              f"control, {kernel} ignoring pallas_loss_bf16 vs {kernel} "
              f"plain fails the parameter gate: updated parameters max abs "
              f"diff {param_gap(pc, pp):.3e} (atol {param_atol}); gradients "
              f"{grad_gap(gc, gp):.3e}")
    worst = 0.0
    ok = True
    for k in mk:
        d = (mk[k] - mp[k]).abs()
        worst = max(worst, float(d))
        ok &= within(d, LOSS_ATOL + LOSS_RTOL * mp[k].abs(), mp[k])
    check(ok, f"step with {kernel} vs {kernel} plain: {len(mk)} loss/cd "
              f"metrics, max abs diff {worst:.3e} (rtol {LOSS_RTOL}, atol "
              f"{LOSS_ATOL})")
    worst, where = 0.0, None
    ok = True
    for n in pk:
        d = (pk[n] - pp[n]).abs()
        if float(d.max()) > worst:
            worst, where = float(d.max()), (n, int(torch.argmax(d)))
        ok &= within(d, param_atol + GRAD_RTOL * pp[n].abs(), pp[n])
    check(ok, f"step with {kernel} vs {kernel} plain: updated parameters, "
              f"max abs diff {worst:.3e} (rtol {GRAD_RTOL}, atol "
              f"{param_atol})")
    if where is not None:
        n, i = where
        g_k, g_p = (float(g[n].flatten()[i]) for g in (gk, gp))
        print(f"  largest parameter difference at {n}[{i}]: gradient "
              f"{g_k:.6e} with {kernel}, {g_p:.6e} plain (Adam's first "
              f"step moves a parameter by lr * g / (|g| + 1e-8))")
    print(f"  every kernel off (trunk plain, {kernel} plain): loss/total "
          f"{float(m0['loss/total']):.6f}, with kernels "
          f"{float(mk['loss/total']):.6f}, diff "
          f"{float(m0['loss/total'] - mk['loss/total']):.3e} (report only)")


def train_run(dev, label, steps, hist_steps, expect, fall_window,
              time_plain=False, **cfg_kw):
    """``steps`` train steps of a seeded ViT-S/8 segmenter (cocostuff27
    head, bf16 trunk) at the reference footprint on one fixed batch, the
    variant with histograms at ``hist_steps``. Every step must launch
    exactly ``expect`` (the COUNTS) and give a finite loss; with
    ``fall_window`` the mean loss of the last that many steps must be below
    that of the first. Reports the median step, images/s, device busy, the
    top 6 kernels and peak memory (with ``time_plain`` also the step's time
    with the loss's plain version), then holds one step with the loss's
    kernel against the same step with its plain version. Returns the
    trained segmenter, the batch, the generator and the launches of the
    steps (the main path; the comparison's launches are not counted)."""
    from stego_torch.config import Config
    from stego_torch.train.segmenter import (UnsupervisedSegmenter,
                                             draw_step_randomness,
                                             make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"train, {label}: seeded ViT-S/8 segmenter, cocostuff27 head, "
          f"bf16 trunk, res {TRAIN_RES}, batch {TRAIN_BATCH}, 5 negatives, "
          f"dropout; {steps} steps on one fixed batch")
    cfg = Config(dataset_name="cocostuff27", model_type="vit_small",
                 dino_patch_size=8, dim=70, projection_type="nonlinear",
                 backbone_dtype="bfloat16", res=TRAIN_RES,
                 batch_size=TRAIN_BATCH, run_crf=False, **cfg_kw)
    seg = UnsupervisedSegmenter(27, cfg,
                                generator=torch.Generator().manual_seed(0))
    seg.to(dev)
    seg.net.model.cast_blocks(torch.bfloat16)
    ref = copy.deepcopy(seg)
    gen = torch.Generator(device=dev).manual_seed(4)
    img = images(gen, TRAIN_RES, dev, TRAIN_BATCH)
    batch = {"img": img,
             "img_pos": img + 0.05 * torch.randn(img.shape, generator=gen,
                                                 device=dev),
             "label": torch.randint(-1, 27, img.shape[:3], generator=gen,
                                    device=dev)}
    step_fns = {h: make_train_step(seg, with_hist=h) for h in (True, False)}
    hist_logged = not cfg.full_field_loss  # full-field logs cd means only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: every launch from here to the read below is counted
    reset_counts()
    losses, step_ms = [], []
    for i in range(steps):
        before = train_counts()
        t0 = time.perf_counter()
        m = step_fns[i in hist_steps](
            batch, draw_step_randomness(seg, TRAIN_BATCH, gen))
        loss = float(m["loss/total"])  # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        delta = tuple(a - b for a, b in zip(train_counts(), before))
        check(delta == expect and math.isfinite(loss)
              and ("hist/pos_intra" in m) == (hist_logged
                                               and i in hist_steps),
              f"step {i}{' (hist)' if i in hist_steps else ''}: "
              f"{step_ms[-1]:.2f} ms, loss/total {loss:.6f}, launches "
              f"attention/LN/C1 fwd/C1 bwd/C2 fwd/C2 bwd {delta}")
    launches = dict(zip(COUNTS, train_counts()))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if fall_window:
        first = statistics.mean(losses[:fall_window])
        last = statistics.mean(losses[-fall_window:])
        check(last < first,
              f"loss/total falls: mean of steps 0-{fall_window - 1} "
              f"{first:.6f}, of steps {steps - fall_window}-{steps - 1} "
              f"{last:.6f}")
    skip = min(3, steps - 1)
    med = statistics.median(step_ms[skip:])
    by_kernel = kernel_times(lambda: step_fns[False](
        batch, draw_step_randomness(seg, TRAIN_BATCH, gen)))
    busy = sum(by_kernel.values()) / 1e3
    print(f"  median {med:.2f} ms per step (steps {skip}-{steps - 1}), "
          f"{TRAIN_BATCH / med * 1e3:.1f} images/s; device busy "
          f"{busy:.3f} ms a step ({busy / med:.0%} of the median); peak "
          f"device memory {peak_gb:.2f} GiB")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:8.3f} ms  {name[:90]}")
    if time_plain:
        # the same step with the loss's plain version, after the counted run
        seg.use_corr_kernel = False
        plain_ms = []
        for i in range(5):
            t0 = time.perf_counter()
            float(step_fns[False](batch, draw_step_randomness(
                seg, TRAIN_BATCH, gen))["loss/total"])
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        plain_busy = sum(kernel_times(lambda: step_fns[False](
            batch, draw_step_randomness(seg, TRAIN_BATCH, gen))).values()) / 1e3
        seg.use_corr_kernel = True
        plain_med = statistics.median(plain_ms[2:])
        print(f"  with the loss's plain version: median {plain_med:.2f} ms "
              f"per step (steps 2-4 of 5), {TRAIN_BATCH / plain_med * 1e3:.1f}"
              f" images/s; device busy {plain_busy:.3f} ms a step")

    compare_steps(ref, batch, draw_step_randomness(ref, TRAIN_BATCH, gen),
                  "C2" if expect[4] else "C1",
                  BF16_PARAM_ATOL if cfg.pallas_loss_bf16 else GRAD_ATOL)
    return seg, gen, launches


def phase_train(dev):
    from stego_torch.train.segmenter import make_val_step

    seg, gen, launches = train_run(
        dev, "sampled loss (kernel C1), 11x11 samples", TRAIN_STEPS,
        HIST_STEPS, (12, 25, 1, 1, 0, 0), 5)

    print(f"val: {VAL_STEPS} steps of make_val_step at res {VAL_RES}, batch "
          f"{TRAIN_BATCH}")
    val = make_val_step(seg)
    vbatch = {"img": images(gen, VAL_RES, dev, TRAIN_BATCH),
              "label": torch.randint(-1, 27, (TRAIN_BATCH, VAL_RES, VAL_RES),
                                     generator=gen, device=dev)}
    n_valid = int((vbatch["label"] >= 0).sum())
    torch.cuda.synchronize()
    reset_counts()
    val_ms = []
    for i in range(VAL_STEPS):
        before = train_counts()
        t0 = time.perf_counter()
        out = val(vbatch)
        sums = (int(out["conf_linear"].sum()), int(out["conf_cluster"].sum()))
        val_ms.append((time.perf_counter() - t0) * 1e3)
        delta = tuple(a - b for a, b in zip(train_counts(), before))
        check(delta == (12, 25, 0, 0, 0, 0) and sums == (n_valid, n_valid),
              f"val step {i}: {val_ms[-1]:.2f} ms, launches {delta}, "
              f"confusion matrices sum to {sums} of {n_valid} valid pixels")
    val_launches = dict(zip(COUNTS, train_counts()))
    print(f"  median {statistics.median(val_ms):.2f} ms per val step")
    return launches, val_launches


def phase_train_stream(dev):
    """The streamed loss's three training options; launches of each run."""
    runs = {}
    expect = (12, 25, 0, 0, 1, 1)
    _, _, runs["full_field"] = train_run(
        dev, "full-field loss (kernel C2, 7 dense 784x784 fields)",
        FULL_STEPS, (0,), expect, 3, time_plain=True, full_field_loss=True)
    _, _, runs["gather"] = train_run(
        dev, "fused_sampling=off (grid-sampled 11x11, kernel C2)",
        SHORT_STEPS, (0,), expect, 0, fused_sampling="off")
    _, _, runs["code_bf16"] = train_run(
        dev, "pallas_loss_bf16 (grid-sampled 11x11, kernel C2, bf16 code)",
        SHORT_STEPS, (0,), expect, 0, pallas_loss_bf16=True)
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from stego_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda", 0)
    ln_err, ln = phase_layer_norm(dev)
    at_err, at = phase_attention(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(dev, tmp)
    check(launches["attention"] == 2 * REQUESTS * ATTN_PER_REQUEST
          and launches["layer_norm"] == 2 * REQUESTS * LN_PER_REQUEST,
          f"eval path launches: {launches}")
    c1_err, c1_times, c1_bound = phase_corr(dev)
    c2 = phase_corr_stream(dev)
    train, val = phase_train(dev)
    stream = phase_train_stream(dev)

    def per_step(steps, corr):
        return dict(zip(COUNTS, [12 * steps, 25 * steps]
                        + [steps * x for x in corr]))

    check(train == per_step(TRAIN_STEPS, (1, 1, 0, 0)),
          f"train path launches: {train}")
    check(val == per_step(VAL_STEPS, (0, 0, 0, 0)),
          f"val path launches: {val}")
    for name, run in stream.items():
        steps = FULL_STEPS if name == "full_field" else SHORT_STEPS
        check(run == per_step(steps, (0, 0, 1, 1)),
              f"{name} train path launches: {run}")
    # launches of each kernel summed over every path it runs on: eval,
    # train (sampled, full-field, grid-sampled, bf16 code) and val
    total = {name: sum(run.get(name, 0) for run in
                       (launches, train, val, *stream.values()))
             for name in COUNTS}

    def row(name, source, replaces, launches_, err, times, bnd, lib=None,
            **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
                **extra}

    c1_src = "stego_torch/csrc/corr_sampled.cu"
    c1_ref = "stego_tpu/ops/pallas_corr_fused_sampling.py"
    c2_src = "stego_torch/csrc/corr_stream.cu"
    c2_ref = "stego_tpu/ops/pallas_corr.py"
    rows = [
        row("layer_norm", "stego_torch/csrc/layer_norm.cu",
            "stego_tpu/ops/layer_norm.py:39", total["layer_norm"], ln_err,
            (ln["ms"], ln["plain_ms"]), ln["bound"], ln["library_ms"],
            cold_ms=ln["cold_ms"]),
        row("attention", "stego_torch/csrc/attention.cu",
            "stego_tpu/ops/flash_attention.py:391", total["attention"],
            at_err, (at["ms"], at["plain_ms"]), at["bound"],
            at["library_ms"]),
        row("corr_sampled_fwd", c1_src, f"{c1_ref}:93",
            total["corr_sampled_fwd"], c1_err["fwd"], c1_times["fwd"],
            c1_bound["fwd"]),
        row("corr_sampled_bwd", c1_src, f"{c1_ref}:187",
            total["corr_sampled_bwd"], c1_err["bwd"], c1_times["bwd"],
            c1_bound["bwd"]),
    ]
    # C2 by the path that runs it, each row measured at that path's shape
    # (phase C2's full-field code_bf16 case runs on no path: printed only)
    for suffix, key, run in (
            ("", ("full-field", False), stream["full_field"]),
            ("_gather", ("grid-sampled", False), stream["gather"]),
            ("_code_bf16", ("grid-sampled", True), stream["code_bf16"])):
        for what, line in (("fwd", 106), ("bwd", 229)):
            rows.append(row(
                f"corr_stream_{what}{suffix}", c2_src, f"{c2_ref}:{line}",
                run[f"corr_stream_{what}"], c2[key]["errs"][what],
                c2[key]["times"][what], c2[key]["bounds"][what]))
    print(json.dumps({"kernels": rows}))
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
