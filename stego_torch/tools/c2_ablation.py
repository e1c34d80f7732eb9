"""What each part of kernel C2 costs, timed on the card.

    python -m stego_torch.tools.c2_ablation [--iters 20]

C2's forward (``csrc/corr_stream.cu``) streams feature and code panels
through a TMA ring into wgmma, fixes up the f32 cd near the clamp bounds,
sums the rows and, when a gradient is taken, keeps fd and the clamp mask.
This builds variants of the kernel library (each its own hashed ``.so``)
with parts of the forward left out (``STEGO_C2_FWD_ABLATION``: 1 the fd
products, 2 the cd products, 4 the stores of fd and the mask, 7 all three,
which leaves the ring's loads alone, 8 the fix-up) and times each
variant's forward, with a gradient kept, beside the port's; it prints how
many entries the fix-up recomputed and the largest |cd by 3xTF32 - cd by
FMA| over them beside the fix-up's margin (a counting build,
``STEGO_C2_FWD_ABLATION=16``), and the forward's registers, shared memory,
blocks an SM and ring stages (the occupancy API). C2's backward streams the
forward's stored fd and clamp mask through a TMA ring, forms the
coefficients from them and runs dc_tile's products on the tensor cores;
its variants (``STEGO_C2_BWD_ABLATION``: 1 the products, 2 the
coefficients, 3 both, which leaves the ring's reads and barriers; 4
dc_tile with a run-time slot count in place of its constant one) are timed
beside the port's backward on the same saved tensors. The shapes are those
of ``chip_smoke.py``'s C2 rows: B=16, five negatives, 70 code channels f32
and bf16 (``code_bf16``) at 28x28 (full-field) and 11x11 (grid-sampled),
and 160 f32 at 28x28, bf16 features at 384; and at 28x28 with 70 f32 code
channels, f32 features at 384 and bf16 features at 768. It also times the
forward with a gradient (keeping fd and the mask) and under
``torch.no_grad()`` (keeping neither). Times are device ms per launch of
the kernels named ``corr_stream_*`` (the profiler's trace, ``--iters``
launches after a warm-up; the forward's input copies count with it), each
variant timed twice, the second pass in reverse order, and averaged. The
port's backward must give the autograd gradient bit for bit; the
variants' outputs are not checked (the ablated ones are wrong by design).
Exits 1 when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from stego_torch.kernels import build
from stego_torch.ops import corr_stream as c2
from stego_torch.ops import tf32
from stego_torch.ops.math import super_perm

VARIANTS = {0: "the kernel", 1: "no products", 2: "no coefficients",
            3: "ring alone", 4: "run-time slots"}
# the forward's variants: their build flags
FWD_VARIANTS = {
    "the kernel": (),
    "no fd products": ("-DSTEGO_C2_FWD_ABLATION=1",),
    "no cd products": ("-DSTEGO_C2_FWD_ABLATION=2",),
    "no fd or mask stores": ("-DSTEGO_C2_FWD_ABLATION=4",),
    "loads alone": ("-DSTEGO_C2_FWD_ABLATION=7",),
    "no fix-up": ("-DSTEGO_C2_FWD_ABLATION=8",),
}
COUNT_FIXUPS = ("-DSTEGO_C2_FWD_ABLATION=16",)
# (maps' side, code channels, code_bf16, name, feature type, channels)
BF16, F32 = torch.bfloat16, torch.float32
SHAPES = ((28, 70, False, "full-field", BF16, 384),
          (28, 70, True, "full-field", BF16, 384),
          (11, 70, False, "grid-sampled", BF16, 384),
          (28, 160, False, "full-field", BF16, 384),
          (28, 70, False, "full-field", F32, 384),
          (28, 70, False, "full-field", BF16, 768))


def kernel_ms(fn, prefix: str, iters: int, attempts: int = 5) -> float:
    """Device ms per call of ``fn`` in kernels whose name holds ``prefix``,
    from the profiler's trace, after one warm-up call. The trace now and
    then holds no device events: it is taken again, ``attempts`` times in
    all, before this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and prefix in e.name)
        if us > 0.0:
            return us / iters / 1e3
    raise RuntimeError(f"the profiler's trace holds no {prefix} kernel")


def libraries() -> tuple:
    """The port's library and the variants, ({bits: backward's}, {label:
    forward's}, the counting build), built in parallel (one nvcc a source
    each)."""
    def one(flags):
        return build.load(build.build(flags)) if flags else build.library()

    keys = ([(f"-DSTEGO_C2_BWD_ABLATION={b}",) if b else ()
             for b in VARIANTS] + list(FWD_VARIANTS.values())
            + [COUNT_FIXUPS])
    with ThreadPoolExecutor(len(keys)) as pool:
        libs = list(pool.map(one, keys))
    nb = len(VARIANTS)
    return (dict(zip(VARIANTS, libs[:nb])),
            dict(zip(FWD_VARIANTS, libs[nb:nb + len(FWD_VARIANTS)])),
            libs[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("c2_ablation: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs, fwd_libs, counting = libraries()
    for code_bf16 in (False, True):
        for feat_f32 in (False, True):
            occ = c2.forward_occupancy(code_bf16, feat_f32, dev)
            print(f"C2 forward, {'bf16' if code_bf16 else 'f32'} code, "
                  f"{'f32' if feat_f32 else 'bf16'} features: "
                  f"{occ['registers']} registers, {occ['smem_bytes']} bytes "
                  f"of shared memory, {occ['blocks_per_sm']} blocks an SM, "
                  f"{occ['stages']} ring stages (occupancy API)")
    g = torch.Generator(device=dev).manual_seed(5)
    b, neg = 16, 5
    shifts = [0.18, 0.12] + [0.46] * neg
    groups = [b] * (2 + neg)
    for hw, cc, code_bf16, name, fdt, cf in SHAPES:
        m = 2 * b
        feats = c2.prep(torch.randn(m, hw, hw, cf, generator=g, device=dev),
                        fdt)
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
        fwd = {label: [] for label in FWD_VARIANTS}
        i1, i2 = idx1.to(torch.int32), idx2.to(torch.int32)
        for label in [*FWD_VARIANTS, *reversed(FWD_VARIANTS)]:
            fwd[label].append(kernel_ms(
                lambda lib=fwd_libs[label]: c2.forward_launch(
                    lib, feats, code, i1, i2, True, False, code_bf16, True),
                "corr_stream_fwd", args.iters))
        c2.fixup_stats(counting, dev)
        c2.forward_launch(counting, feats, code, i1, i2, True, False,
                          code_bf16, True)
        torch.cuda.synchronize()
        fixed, gap = c2.fixup_stats(counting, dev)
        entries = idx1.numel() * (hw * hw) ** 2
        print(f"C2 {name} (N={hw * hw}), {cc} code channels "
              f"{'bf16' if code_bf16 else 'f32'}, {cf} {str(fdt)[6:]} "
              f"features: backward ms "
              + ", ".join(f"{VARIANTS[bits]} {sum(t) / 2:.4f}"
                          for bits, t in bwd.items())
              + f"; forward ms keeping fd and mask {(keep + keep2) / 2:.4f}, "
              f"keeping neither {no_keep:.4f}; forward variants ms "
              + ", ".join(f"{label} {sum(t) / 2:.4f}"
                          for label, t in fwd.items())
              + f"; the fix-up recomputed {fixed} of {entries} entries "
              f"(zero_clamp), largest |3xTF32 - FMA| over them {gap:.3e} "
              f"(margin fixup_eps {tf32.fixup_eps(cc):.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
