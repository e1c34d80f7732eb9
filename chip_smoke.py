"""Smoke run of stego_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from stego_torch/csrc with nvcc.
2. Holds kernel L (LayerNorm) and kernel A (attention) against their plain
   PyTorch versions at the shapes the trunk gives them, and times both.
3. Serves flip-TTA requests with a seeded ViT-S/8 STEGO segmenter at full
   width (cocostuff27 head: dim 70, nonlinear, 27 classes, bf16 trunk):
   3 requests of 8 images at res 224, then 3 at res 320, through
   load_model_for_eval and make_eval_step, after a round trip through a
   .ckpt. Each request must launch each kernel a fixed number of times, and
   its code and predictions must agree with the same batch through the
   plain versions on the card.
4. Holds kernel C1 (the sampled correlation loss, forward and backward)
   against its plain version at the train step's shapes, and times both.
5. Trains: 20 steps of make_train_step at the reference footprint
   (src/configs/train_config.yml: ViT-S/8, res 224, batch 16, 11 x 11
   samples, 5 negatives, dropout) on one fixed synthetic batch, each
   launching C1 forward and backward once and the trunk's kernels once
   over img || img_pos; the loss must fall. One step with C1 is held
   against the same step with C1's plain version. Then 3 val steps
   (make_val_step) at res 320.

Prints one JSON line with the kernels' results, the nvidia-smi line, and as
the last line {"ok": true, "device": {...}}. Exits non-zero, without that
line, when there is no CUDA device, a kernel does not build or launch, or a
check fails. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
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


def kernel_times(fn, iters: int = 1) -> dict:
    """Device microseconds by kernel name over ``iters`` calls of ``fn``,
    from the profiler's CUDA trace (after one warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not times:
        raise RuntimeError("the profiler recorded no device time")
    return times


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


def timing_text(t) -> str:
    return (f"device kernel {t['device'][0]:.4f} ms, plain "
            f"{t['device'][1]:.4f} ms; per call with launch: kernel "
            f"{t['call'][0]:.4f} ms, plain {t['call'][1]:.4f} ms")


def phase_layer_norm(dev):
    from stego_torch.ops import layer_norm as ln

    print("kernel L (layer_norm) vs plain, bf16, within one bf16 ulp")
    g = torch.Generator(device=dev).manual_seed(0)
    worst, times = 0.0, None
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
        times = times or t["device"]
        check(within(diff, ln.bf16_ulp_tolerance(want), want),
              f"({rows}, {d}): max_abs_err {err:.3e}; {timing_text(t)}")
    return worst, times


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

    print(f"kernel A (attention) vs plain, bf16, H={HEADS} d={HEAD_DIM}, "
          f"q, k ~ N(0, 4), v ~ N(0, 1), rtol {ATTN_RTOL} atol {ATTN_ATOL}")
    g = torch.Generator(device=dev).manual_seed(1)
    worst, times = 0.0, None
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
        times = times or t["device"]
        check(ok, f"(B={b}, N={n}): max_abs_err {err:.3e}; {timing_text(t)}")
    return worst, times


def images(gen, res, dev, batch=BATCH):
    """A batch of random [0, 1] images, ImageNet-normalized, NHWC."""
    from stego_torch.data.transforms import channel_stats

    mean, std = (torch.as_tensor(s, device=dev) for s in channel_stats(3))
    img01 = torch.rand(batch, res, res, 3, generator=gen, device=dev)
    return (img01 - mean) / std


def phase_slice(dev, tmp):
    from stego_tpu.config import Config
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

        got = run(c1.sampled_corr_fused)
        torch.cuda.synchronize()
        want = run(c1.sampled_corr_plain)
        label = ", ".join(f"{k}={v}" for k, v in opts.items())
        for what, sl, rtol, atol in (("fwd", slice(0, 2), LOSS_RTOL,
                                      LOSS_ATOL),
                                     ("bwd", slice(2, 4), GRAD_RTOL,
                                      GRAD_ATOL)):
            diffs = [(g - w).abs() for g, w in zip(got[sl], want[sl])]
            err = max(float(d.max()) for d in diffs)
            errs[what] = max(errs[what], err)
            ok = all(within(d, atol + rtol * w.abs(), w)
                     for d, w in zip(diffs, want[sl]))
            check(ok, f"{label}: {'losses and cd means' if what == 'fwd' else 'code gradients'}"
                      f", max_abs_err {err:.3e}")
        if times:
            continue
        t_fwd = compare_times(lambda: forward(c1.sampled_corr_fused),
                              lambda: forward(c1.sampled_corr_plain))
        t_all = compare_times(lambda: run(c1.sampled_corr_fused),
                              lambda: run(c1.sampled_corr_plain))
        _, _, tk, ck = forward(c1.sampled_corr_fused)
        _, _, tp, cp = forward(c1.sampled_corr_plain)
        t_bwd = compare_times(
            lambda: torch.autograd.grad(tk, ck, retain_graph=True),
            lambda: torch.autograd.grad(tp, cp, retain_graph=True))
        for what, t in (("forward", t_fwd), ("forward+backward", t_all),
                        ("backward alone", t_bwd)):
            print(f"  {what}: {timing_text(t)}")
        times = {"fwd": t_fwd["device"], "bwd": t_bwd["device"]}
    return errs, times


def train_counts():
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln

    return (fa.LAUNCHES, ln.LAUNCHES, c1.FWD_LAUNCHES, c1.BWD_LAUNCHES)


def reset_counts():
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln

    fa.LAUNCHES = ln.LAUNCHES = c1.FWD_LAUNCHES = c1.BWD_LAUNCHES = 0


def compare_steps(ref, batch, rand):
    """One train step from ``ref``'s state with C1 and one with C1's plain
    version (trunk kernels on in both); then one with every kernel off,
    reported only."""
    def one_step(use_kernels, use_corr_kernel):
        from stego_torch.train.segmenter import make_train_step

        seg = copy.deepcopy(ref)
        seg.net.model.use_kernels = use_kernels
        seg.use_corr_kernel = use_corr_kernel
        metrics = make_train_step(seg, with_hist=False)(batch, rand)
        return metrics, {n: p.detach() for n, p in seg.named_parameters()}

    mk, pk = one_step(True, True)
    mp, pp = one_step(True, False)
    m0, _ = one_step(False, False)
    worst = 0.0
    ok = True
    for k in mk:
        d = (mk[k] - mp[k]).abs()
        worst = max(worst, float(d))
        ok &= within(d, LOSS_ATOL + LOSS_RTOL * mp[k].abs(), mp[k])
    check(ok, f"step with C1 vs C1 plain: {len(mk)} loss/cd metrics, max abs "
              f"diff {worst:.3e} (rtol {LOSS_RTOL}, atol {LOSS_ATOL})")
    worst = 0.0
    ok = True
    for n in pk:
        d = (pk[n] - pp[n]).abs()
        worst = max(worst, float(d.max()))
        ok &= within(d, GRAD_ATOL + GRAD_RTOL * pp[n].abs(), pp[n])
    check(ok, f"step with C1 vs C1 plain: updated parameters, max abs diff "
              f"{worst:.3e} (rtol {GRAD_RTOL}, atol {GRAD_ATOL})")
    print(f"  every kernel off (trunk plain, C1 plain): loss/total "
          f"{float(m0['loss/total']):.6f}, with kernels "
          f"{float(mk['loss/total']):.6f}, diff "
          f"{float(m0['loss/total'] - mk['loss/total']):.3e} (report only)")


def phase_train(dev):
    from stego_tpu.config import Config
    from stego_torch.train.segmenter import (UnsupervisedSegmenter,
                                             draw_step_randomness,
                                             make_train_step, make_val_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"train: seeded ViT-S/8 segmenter, cocostuff27 head, bf16 trunk, "
          f"res {TRAIN_RES}, batch {TRAIN_BATCH}, 11x11 samples, 5 "
          f"negatives, dropout; {TRAIN_STEPS} steps on one fixed batch")
    cfg = Config(dataset_name="cocostuff27", model_type="vit_small",
                 dino_patch_size=8, dim=70, projection_type="nonlinear",
                 backbone_dtype="bfloat16", res=TRAIN_RES,
                 batch_size=TRAIN_BATCH, run_crf=False)
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
    steps = {h: make_train_step(seg, with_hist=h) for h in (True, False)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: every launch from here to the read below is counted
    reset_counts()
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        before = train_counts()
        t0 = time.perf_counter()
        m = steps[i in HIST_STEPS](
            batch, draw_step_randomness(seg, TRAIN_BATCH, gen))
        loss = float(m["loss/total"])  # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        delta = tuple(a - b for a, b in zip(train_counts(), before))
        check(delta == (12, 25, 1, 1) and math.isfinite(loss)
              and ("hist/pos_intra" in m) == (i in HIST_STEPS),
              f"step {i}{' (hist)' if i in HIST_STEPS else ''}: "
              f"{step_ms[-1]:.2f} ms, loss/total {loss:.6f}, launches "
              f"attention/LN/C1 fwd/C1 bwd {delta}")
    launches = dict(zip(("attention", "layer_norm", "corr_sampled_fwd",
                         "corr_sampled_bwd"), train_counts()))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    first, last = (statistics.mean(losses[:5]),
                   statistics.mean(losses[-5:]))
    check(last < first, f"loss/total falls: mean of steps 0-4 {first:.6f}, "
                        f"of steps {TRAIN_STEPS - 5}-{TRAIN_STEPS - 1} "
                        f"{last:.6f}")
    med = statistics.median(step_ms[3:])
    by_kernel = kernel_times(lambda: steps[False](
        batch, draw_step_randomness(seg, TRAIN_BATCH, gen)))
    busy = sum(by_kernel.values()) / 1e3
    print(f"  median {med:.2f} ms per step (steps 3-{TRAIN_STEPS - 1}), "
          f"{TRAIN_BATCH / med * 1e3:.1f} images/s; device busy "
          f"{busy:.3f} ms a step ({busy / med:.0%} of the median); peak "
          f"device memory {peak_gb:.2f} GiB")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:8.3f} ms  {name[:90]}")

    compare_steps(ref, batch, draw_step_randomness(ref, TRAIN_BATCH, gen))

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
        check(delta == (12, 25, 0, 0) and sums == (n_valid, n_valid),
              f"val step {i}: {val_ms[-1]:.2f} ms, launches {delta}, "
              f"confusion matrices sum to {sums} of {n_valid} valid pixels")
    val_launches = dict(zip(("attention", "layer_norm"), train_counts()))
    print(f"  median {statistics.median(val_ms):.2f} ms per val step")
    return launches, val_launches


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
    ln_err, (ln_ms, ln_plain) = phase_layer_norm(dev)
    at_err, (at_ms, at_plain) = phase_attention(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(dev, tmp)
    check(launches["attention"] == 2 * REQUESTS * ATTN_PER_REQUEST
          and launches["layer_norm"] == 2 * REQUESTS * LN_PER_REQUEST,
          f"eval path launches: {launches}")
    c1_err, c1_times = phase_corr(dev)
    train, val = phase_train(dev)
    check(train == {"attention": 12 * TRAIN_STEPS,
                    "layer_norm": 25 * TRAIN_STEPS,
                    "corr_sampled_fwd": TRAIN_STEPS,
                    "corr_sampled_bwd": TRAIN_STEPS},
          f"train path launches: {train}")
    check(val == {"attention": 12 * VAL_STEPS, "layer_norm": 25 * VAL_STEPS},
          f"val path launches: {val}")
    # launches of each kernel summed over the three paths (eval, train, val)
    for name in ("attention", "layer_norm"):
        launches[name] += train[name] + val[name]

    c1_src = "stego_torch/csrc/corr_sampled.cu"
    c1_ref = "stego_tpu/ops/pallas_corr_fused_sampling.py"
    print(json.dumps({"kernels": [
        {"name": "layer_norm", "route": "cuda",
         "source": "stego_torch/csrc/layer_norm.cu",
         "replaces": "stego_tpu/ops/layer_norm.py:39",
         "launches": launches["layer_norm"], "max_abs_err": ln_err,
         "ms": ln_ms, "plain_ms": ln_plain},
        {"name": "attention", "route": "cuda",
         "source": "stego_torch/csrc/attention.cu",
         "replaces": "stego_tpu/ops/flash_attention.py:391",
         "launches": launches["attention"], "max_abs_err": at_err,
         "ms": at_ms, "plain_ms": at_plain},
        {"name": "corr_sampled_fwd", "route": "cuda", "source": c1_src,
         "replaces": f"{c1_ref}:93",
         "launches": train["corr_sampled_fwd"], "max_abs_err": c1_err["fwd"],
         "ms": c1_times["fwd"][0], "plain_ms": c1_times["fwd"][1]},
        {"name": "corr_sampled_bwd", "route": "cuda", "source": c1_src,
         "replaces": f"{c1_ref}:187",
         "launches": train["corr_sampled_bwd"], "max_abs_err": c1_err["bwd"],
         "ms": c1_times["bwd"][0], "plain_ms": c1_times["bwd"][1]},
    ]}))
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
