"""Kernel A's consumer warpgroups a block, timed on the card.

    python -m stego_torch.tools.attention_consumers [--iters 50] [--repeats 5]

Kernel A's bf16 kernel (``csrc/attention.cu``) gives a block 2 or 3
consumer warpgroups of 64 query rows each and picks the count by the grid's
waves (``consumers_for``). This times the trunk's token-major two-pass
launch (as :func:`stego_torch.ops.flash_attention.token_major_attention`)
with 2 and 3 consumers forced and with the kernel's own choice, through the
C entry ``stego_attention_consumers``, at the token-major shapes of
``chip_smoke.py``'s kernel A rows: B=8, N=785, H=6 (ViT-S at res 224),
B=32, N=785, H=12 (ViT-B's train trunk) and B=8, N=1601, H=6 (res 320),
d=64, on the column blocks of one packed qkv. The three outputs must be
equal bit for bit (the count changes which block takes a row, not its
sums). Prints ms per launch (CUDA events, the median of ``--repeats`` runs
of ``--iters`` launches after a warm-up) and exits 1 on a mismatch or when
there is no CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import Dict, List, Optional

import torch

from stego_torch.kernels import build
from stego_torch.ops.flash_attention import FORMS, HEAD_DIM

SHAPES = ((8, 785, 6), (32, 785, 12), (8, 1601, 6))
COUNTS = {"grid's choice": 0, "2": 2, "3": 3}


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, heads: int, consumers: int) -> None:
    """Kernel A, two-pass, on token-major (B, N, H*64) bf16 q, k, v into
    ``out`` with ``consumers`` consumer warpgroups a block (0: the grid's
    choice)."""
    views = [x.unflatten(-1, (heads, HEAD_DIM)) for x in (q, k, v, out)]
    strides = [s for x in views for s in x.stride()[:3]]
    b, n = q.shape[:2]
    err = build.library().stego_attention_consumers(
        *(x.data_ptr() for x in views), b, n, heads, *strides,
        float(HEAD_DIM ** -0.5), FORMS["two_pass"], consumers,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "attention kernel")


def time_ms(fn, iters: int, repeats: int) -> float:
    """Median ms per call of ``fn`` over ``repeats`` runs of ``iters``."""
    fn()  # warm-up
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def sweep(iters: int = 50, repeats: int = 5) -> List[Dict]:
    """One row a shape: ms by consumer count and whether the outputs of
    every count are equal."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for b, n, heads in SHAPES:
        embed = heads * HEAD_DIM
        qkv = torch.randn(b, n, 3 * embed, generator=gen, device=dev)
        qkv[..., :2 * embed] *= 2
        q, k, v = qkv.to(torch.bfloat16).split(embed, dim=-1)
        outs, ms = {}, {}
        for name, count in COUNTS.items():
            out = torch.empty((b, n, embed), dtype=torch.bfloat16, device=dev)
            ms[name] = time_ms(
                lambda: launch(q, k, v, out, heads, count), iters, repeats)
            outs[name] = out
        equal = all(torch.equal(o, outs["2"]) for o in outs.values())
        rows.append(dict(shape=(b, n, heads), ms=ms, equal=equal))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_consumers: no CUDA device", file=sys.stderr)
        return 1
    print(f"kernel A, token-major two-pass, bf16, d={HEAD_DIM}: ms a launch "
          f"by consumer warpgroups a block on "
          f"{torch.cuda.get_device_name(0)}")
    ok = True
    for r in sweep(args.iters, args.repeats):
        b, n, heads = r["shape"]
        times = ", ".join(f"{name} {ms:.4f}" for name, ms in r["ms"].items())
        print(f"  B={b} N={n} H={heads}: {times}; outputs equal: "
              f"{r['equal']}")
        ok &= r["equal"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
