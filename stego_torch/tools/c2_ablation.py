"""What each part of kernel C2 costs, timed on the card.

    python -m stego_torch.tools.c2_ablation [--iters 20]

C2's backward (``csrc/corr_stream.cu``) streams the forward's stored fd and
clamp mask through a TMA ring, forms the coefficients from them and runs
dc_tile's products on the tensor cores. This builds variants of the kernel
library with parts of the backward left out (``STEGO_C2_BWD_ABLATION``:
1 the products, 2 the coefficients, 3 both, which leaves the ring's
reads and barriers; 4 dc_tile with a run-time slot count in place of its
constant one) and times each variant's backward beside the port's on the
same saved tensors, at the shapes of ``chip_smoke.py``'s C2 rows: B=16,
five negatives, 70 code channels f32 and bf16 (``code_bf16``) at 28x28
(full-field) and 11x11 (grid-sampled), and 160 f32 at 28x28, bf16 features
at 384. It also times the forward with a gradient (keeping fd and the
mask) and under ``torch.no_grad()`` (keeping neither). Times are device ms
per launch of the kernels named ``corr_stream_*`` (the profiler's trace,
``--iters`` launches after a warm-up), each variant timed twice, in the
order 0 1 2 3 4 4 3 2 1 0, and averaged. The port's backward must give the
autograd gradient bit for bit; the variants' outputs are not checked (they
are wrong by design). Exits 1 when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from stego_torch.kernels import build
from stego_torch.ops import corr_stream as c2
from stego_torch.ops.math import super_perm

VARIANTS = {0: "the kernel", 1: "no products", 2: "no coefficients",
            3: "ring alone", 4: "run-time slots"}
# (maps' side, code channels, code_bf16, name)
SHAPES = ((28, 70, False, "full-field"), (28, 70, True, "full-field"),
          (11, 70, False, "grid-sampled"), (28, 160, False, "full-field"))


def kernel_ms(fn, prefix: str, iters: int) -> float:
    """Device ms per call of ``fn`` in kernels whose name holds ``prefix``,
    from the profiler's trace, after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and prefix in e.name)
    if us == 0.0:
        raise RuntimeError(f"the profiler's trace holds no {prefix} kernel")
    return us / iters / 1e3


def libraries() -> dict:
    """The port's library and one variant a bit pattern, built in
    parallel (one nvcc a source each)."""
    def one(bits):
        if bits == 0:
            return build.library()
        return build.load(build.build(
            (f"-DSTEGO_C2_BWD_ABLATION={bits}",)))

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(one, VARIANTS)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("c2_ablation: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = libraries()
    g = torch.Generator(device=dev).manual_seed(5)
    b, neg, cf = 16, 5, 384
    shifts = [0.18, 0.12] + [0.46] * neg
    groups = [b] * (2 + neg)
    for hw, cc, code_bf16, name in SHAPES:
        m = 2 * b
        feats = c2.prep(torch.randn(m, hw, hw, cf, generator=g, device=dev),
                        torch.bfloat16)
        code = c2.prep(torch.randn(m, hw, hw, cc, generator=g, device=dev))
        ar = torch.arange(b, device=dev)
        idx1 = ar.repeat(2 + neg)
        idx2 = torch.cat([ar, ar + b] + [super_perm(b, g)
                                         for _ in range(neg)])
        c = code.clone().requires_grad_(True)

        def forward(c=c, feats=feats, idx2=idx2, code_bf16=code_bf16):
            return c2.stream_loss(feats, c, idx1, idx2, shifts, groups,
                                  code_bf16=code_bf16)

        losses, cds = forward()
        (want,) = torch.autograd.grad(losses.sum() + cds.sum(), c,
                                      retain_graph=True)
        node = losses.grad_fn
        saved, static = node.saved_tensors, node.static
        ones = (torch.ones_like(losses), torch.ones_like(cds))
        got = c2.backward_launch(libs[0], saved, static, *ones)
        if not torch.equal(got, want):
            print(f"c2_ablation: the port's backward at {name}, {cc} "
                  f"channels differs from its autograd gradient",
                  file=sys.stderr)
            return 1
        bwd = {bits: [] for bits in VARIANTS}
        for bits in [*VARIANTS, *reversed(VARIANTS)]:
            bwd[bits].append(kernel_ms(
                lambda lib=libs[bits]: c2.backward_launch(
                    lib, saved, static, *ones), "corr_stream_bwd",
                args.iters))
        keep = kernel_ms(forward, "corr_stream_fwd", args.iters)
        with torch.no_grad():
            no_keep = kernel_ms(forward, "corr_stream_fwd", args.iters)
        keep2 = kernel_ms(forward, "corr_stream_fwd", args.iters)
        print(f"C2 {name} (N={hw * hw}), {cc} code channels "
              f"{'bf16' if code_bf16 else 'f32'}: backward ms "
              + ", ".join(f"{VARIANTS[bits]} {sum(t) / 2:.4f}"
                          for bits, t in bwd.items())
              + f"; forward ms keeping fd and mask {(keep + keep2) / 2:.4f}, "
              f"keeping neither {no_keep:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
