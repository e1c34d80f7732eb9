"""Kernel A's narrow-head kernel of this checkout against another checkout's,
on the card, timed in one run.

    python -m stego_torch.tools.attention_narrow_diff <other checkout>

Runs the narrow-head kernel (heads of 8, 16 and 32, bf16 and f32 q/k/v) of
each checkout in every head-major form at the sensitive accuracy
instrument's shape (B=16, H=4, N=65; q, k ~ N(0, 4), v ~ N(0, 1), seeded)
through the public functions of ``ops/flash_attention.py``, each checkout
in a process of its own, in the turns other, this, this, other on one
card. Prints, for every case, each checkout's device ms per call (the
profiler's trace, 50 calls after a warm-up; the mean of its two turns),
their ratio, and the largest difference between the two outputs (the
kernels may sum in other orders, so the outputs need not be bitwise
equal; ``chip_smoke.py`` holds each to its plain version).
"""

from __future__ import annotations

import sys

import torch

if __package__:
    from .checkout_diff import kernel_ms, run_checkouts
else:  # --produce, a script in the other checkout (checkout_diff.py)
    from checkout_diff import kernel_ms, run_checkouts

DS = (8, 16, 32)
DTYPES = ("bfloat16", "float32")
FORMS = ("batch_resident", "resident", "flash", "no_softmax")
SHAPE = (16, 4, 65)  # B, H, N


def produce(out: str) -> None:
    """Every case's output and device ms, saved to ``out``."""
    from stego_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    b, h, n = SHAPE
    outputs, times = {}, {}
    for d in DS:
        g = torch.Generator(device=dev).manual_seed(d)
        qkv = torch.randn(b, n, 3, h, d, generator=g, device=dev)
        qkv[:, :, :2] *= 2
        for dtype in DTYPES:
            q, k, v = (x.transpose(1, 2) for x in
                       qkv.to(getattr(torch, dtype)).unbind(2))
            for form in FORMS:
                fn = getattr(fa, f"{form}_attention")
                key = f"d={d} {dtype} {form}"
                outputs[key] = fn(q, k, v, d ** -0.5).cpu()
                times[key] = kernel_ms(
                    lambda fn=fn: fn(q, k, v, d ** -0.5), 50)[1]
    torch.save({"outputs": outputs, "ms": times}, out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--produce":
        produce(argv[1])
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("attention_narrow_diff: no CUDA device", file=sys.stderr)
        return 1
    runs = run_checkouts(__file__, argv[0],
                         ("other", "this", "this", "other"))
    print(f"card: {torch.cuda.get_device_name(0)}; B, H, N = {SHAPE}; "
          f"device ms a call, mean of two turns (other, this, this, other)")
    for key, got in runs["this"][0]["outputs"].items():
        turns = {name: [r["ms"][key] for r in rs] for name, rs in runs.items()}
        ms = {name: sum(t) / len(t) for name, t in turns.items()}
        other = runs["other"][0]["outputs"][key]
        diff = float((got.float() - other.float()).abs().max())
        print(f"{key}: " + "; ".join(
            f"{name} {ms[name]:.4f} ms ({turns[name][0]:.4f}, "
            f"{turns[name][1]:.4f})" for name in ("this", "other"))
            + f"; this / other {ms['this'] / ms['other']:.3f}; outputs "
            f"bitwise equal {torch.equal(got, other)}, max abs diff "
            f"{diff:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
