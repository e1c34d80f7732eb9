"""Kernels C1 and C2 of this checkout against another checkout's, on the card.

    python -m stego_torch.tools.loss_kernels_diff <other checkout>

Runs C1 (the sampled loss, at the train step's shape: B=16, 28x28 maps, 70
code channels, 11x11 samples, 5 negatives; bf16 features at 192, 384 and
768 channels and f32 at 384) and C2 (the streamed loss: full-field and
grid-sampled, f32 and bf16 code, 70, 128 and 160 code channels, bf16
features at 384 and 768 channels and f32 at 384) of each checkout, in a
process of its own, on the same seeded inputs, and prints for every
output whether the two are bitwise equal and their largest difference.
Both checkouts are driven through their public functions only, so their
C entry points may differ (C2's backward took the features until it read
the fd and mask that its forward keeps; C1's products became C2's). C1's
outputs also include what its forward keeps, in one layout whatever the
checkout's: each pair row's side-2 normalised code, fd and row sums,
group-major (pair row g * B + b). A C1 with products of its own added its
code gradients with atomics, so their last bits followed the order of the
adds, and took fd and cd by f32 FMA; so C1's outputs differ from such a
checkout's in their last bits. C2's forward
takes its f32 cd by 3xTF32 with an FMA fix-up near the clamp bounds (PR
10; before it, f32 FMA throughout) and sums each row's columns in another
order, so its losses, cd means and code gradients differ from an older
checkout's in their last bits, by design: each line gives whether two
outputs are bitwise equal and their largest difference, absolute and
relative to the larger output's largest value. Every other output of a
change that keeps the kernels' arithmetic is bitwise equal.
It also prints each case's times, forward and backward, in both
checkouts: the summed device time of the kernels named ``corr_*`` and of
every kernel of the call (the wrapper's casts, sorts and ``finalize``
too; the profiler's trace, 20 calls after a warm-up), so that the two are
timed in one run on one card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch

C1_OUTPUTS = ("losses", "cd means", "side-2 code", "fd", "row sums",
              "dcode", "dcode_pos")
C2_OUTPUTS = ("losses", "cd means", "dcode")


def kernel_ms(fn, iters: int = 20) -> tuple:
    """Device ms per call of ``fn``: (in kernels named ``corr_*``, C1's and
    C2's; in all its kernels), from the profiler's trace, after one warm-up
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    corr = sum(e.time_range.elapsed_us() for e in events
               if "corr_" in e.name)
    every = sum(e.time_range.elapsed_us() for e in events)
    return corr / iters / 1e3, every / iters / 1e3


def c1_kept(losses: torch.Tensor, b: int, g: int) -> list:
    """What C1's forward kept for ``losses``' backward, in one layout
    whatever the checkout: each pair row's side-2 normalised code (R, S,
    CC), fd (R, S, S) and row sums (R, 4, S), group-major (R = g * b). A
    C1 with products of its own kept them slot-major (b, g), with the
    side-2 code norms as a fifth row of sums; the route through C2 keeps
    C2's saved tensors and the sets (pair row r reads set idx2[r])."""
    saved = losses.grad_fn.saved_tensors
    if len(saved) == 7:  # grid1, grid2, perm, z2cn, fd, acc, gm
        def group_major(x):
            return x.reshape(b, g, *x.shape[1:]).transpose(0, 1) \
                .reshape(g * b, *x.shape[1:])

        return [group_major(saved[3]), group_major(saved[4]),
                group_major(saved[5][:, :4])]
    csets, fd, _, i2, acc = saved[:5]
    return [csets[i2.long()], fd[..., :fd.shape[1]], acc]


def produce(out: str) -> None:
    """Every output of both kernels on the seeded inputs, saved to out."""
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops.math import super_perm

    dev = torch.device("cuda")
    res, times = {}, {}
    g = torch.Generator(device=dev).manual_seed(3)
    b, hw, cc, s, neg = 16, 28, 70, 11, 5
    shifts = [0.18, 0.12] + [0.46] * neg
    for fdt, cf in ((torch.bfloat16, 384), (torch.float32, 384),
                    (torch.bfloat16, 768), (torch.bfloat16, 192)):
        feats = [torch.randn(b, hw, hw, cf, generator=g, device=dev)
                 for _ in range(2)]
        code = [torch.randn(b, hw, hw, cc, generator=g, device=dev)
                .requires_grad_(True) for _ in range(2)]
        coords = [torch.rand(b, s, s, 2, generator=g, device=dev) * 2 - 1
                  for _ in range(2)]
        perms = [super_perm(b, g) for _ in range(neg)]

        def forward():
            return c1.sampled_corr_fused(
                feats[0], feats[1], code[0], code[1], coords[0], coords[1],
                perms, shifts, feat_dtype=fdt)

        losses, cds = forward()
        kept = c1_kept(losses, b, 2 + neg)
        grads = torch.autograd.grad(losses.sum() + cds.sum(), code)
        key = f"C1, {str(fdt)[6:]} features, {cf} channels"
        res[key] = [losses, cds, *kept, *grads]
        times[key] = time_fwd_bwd(forward, code)
    groups = [b] * (2 + neg)
    for hw2, distinct, code_bf16, cc2, fdt, cf in (
            (28, False, False, 70, torch.bfloat16, 384),
            (11, True, True, 70, torch.bfloat16, 384),
            (11, True, False, 128, torch.bfloat16, 384),
            (28, False, False, 70, torch.float32, 384),
            (28, False, True, 70, torch.bfloat16, 384),
            (28, False, False, 70, torch.bfloat16, 768),
            (28, False, False, 160, torch.bfloat16, 384)):
        m = (2 + neg if distinct else 2) * b
        feats = c2.prep(torch.randn(m, hw2, hw2, cf, generator=g,
                                    device=dev), fdt)
        code = c2.prep(torch.randn(m, hw2, hw2, cc2, generator=g, device=dev))
        ar = torch.arange(b, device=dev)
        idx1 = ar.repeat(2 + neg)
        idx2 = (torch.arange(m, device=dev) if distinct else torch.cat(
            [ar, ar + b] + [super_perm(b, g) for _ in range(neg)]))
        c = code.clone().requires_grad_(True)

        def forward(c=c, feats=feats, idx2=idx2, code_bf16=code_bf16):
            return c2.stream_loss(feats, c, idx1, idx2, shifts, groups,
                                  code_bf16=code_bf16, use_kernel=True,
                                  pointwise=True, zero_clamp=True)

        losses, cds = forward()
        grads = torch.autograd.grad(losses.sum() + cds.sum(), c)
        key = (f"C2, N={hw2 * hw2}, {cc2} code channels"
               f"{', code_bf16' if code_bf16 else ''}, {cf} {str(fdt)[6:]} "
               f"features")
        res[key] = [losses, cds, *grads]
        times[key] = time_fwd_bwd(forward, [c])
    torch.save({"outputs": {k: [t.detach().cpu() for t in v]
                            for k, v in res.items()}, "ms": times}, out)


def time_fwd_bwd(forward, inputs) -> tuple:
    """(forward, backward) :func:`kernel_ms` of the loss ``forward()``
    returns, differentiated in ``inputs``."""
    fwd = kernel_ms(forward)
    losses, cds = forward()
    total = losses.sum() + cds.sum()
    bwd = kernel_ms(lambda: torch.autograd.grad(total, inputs,
                                                retain_graph=True))
    return fwd, bwd


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--produce":
        produce(argv[1])
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("loss_kernels_diff: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, root in (("other", argv[0]), ("this", here)):
            out = os.path.join(tmp, f"{name}.pt")
            env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
            # this file as a script, so that stego_torch is the checkout's
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--produce", out], check=True, env=env,
                           cwd=os.path.abspath(root))
            results.append(torch.load(out))
    other, this = results
    for key, tensors in this["outputs"].items():
        names = C1_OUTPUTS if key.startswith("C1") else C2_OUTPUTS
        for name, x, y in zip(names, other["outputs"][key], tensors):
            diff = float((x - y).abs().max())
            scale = max(float(x.abs().max()), float(y.abs().max()), 1e-30)
            print(f"{key}: {name}: bitwise equal {torch.equal(x, y)}, max "
                  f"abs diff {diff:.3e} ({diff / scale:.3e} of the largest "
                  f"|value|)")
    for key, times in this["ms"].items():
        for what, (fwd, bwd), (fwd_o, bwd_o) in zip(
                ("corr_* kernel ms", "all device ms"), zip(*times),
                zip(*other["ms"][key])):
            print(f"{key}: {what} forward {fwd:.4f} (other {fwd_o:.4f}, "
                  f"{fwd / fwd_o:.3f}x), backward {bwd:.4f} (other "
                  f"{bwd_o:.4f}, {bwd / bwd_o:.3f}x), both {fwd + bwd:.4f} "
                  f"(other {fwd_o + bwd_o:.4f}, "
                  f"{(fwd + bwd) / (fwd_o + bwd_o):.3f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
