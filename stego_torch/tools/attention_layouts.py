"""Attention layouts on the card: 12 chained attention sublayers a rung.

    python -m stego_torch.tools.attention_layouts [--models vit_small,vit_base]
        [--batch 32] [--tokens 785] [--iters 10]

Counterpart of ``scripts/bench_attncore.py`` (ViT-S, H=6) and
``scripts/bench_attn_vitb.py`` (ViT-B, H=12), the JAX package's layout
experiments at B=32 (the image and its positive of a batch-16 train step),
N=785 (res 224), d=64, bf16. Each rung times 12 sublayers of the trunk's
pre-LN attention sublayer,

    h = LN(x);  x = x + proj(core(qkv(h)))

with one packed qkv GEMM (the port's trunk form), so the projections and
every layout copy are inside the time. The rungs differ in ``core``:

* ``einsum``: the trunk's einsum form (``models/vit.py``: f32 logits, the
  softmax over bf16 logits), head-major through reshapes and copies;
* ``head-major, copies outside``: q, k, v copied head-major, kernel A
  (``batch_resident_attention``) and the output copied back
  (``bench_attncore.py:nopad_core``);
* ``head-major views``: kernel A reads head-major views of the packed qkv
  and writes the output token-major (``trunk_attention``, ViT-T's path);
  ``resident`` the same with the normalised softmax rounded to bf16
  (``resident_attention``);
* ``token-major``: kernel A on the column blocks of qkv, writing
  token-major (the trunk's path for an even head count). The TPU's flat
  (``bench_attncore.py:flat_core``), pair and all-heads
  (``bench_attn_vitb.py:pair_core``, ``allheads_core``) kernels cut the same
  layout into other blocks; on the card they are this one launch;
* ``packed``: kernel A on the (B, N, 3, H*d) view (``packed_attention``);
* ``flash``: kernel A's online-softmax form on head-major views;
* ``no softmax``: the two products alone (``bench_attncore.py:84-85``);
* ``token-major, add+LN fused`` (``head-major views, add+LN fused`` for an
  odd head count): as token-major (head-major views), the residual add and
  the next LN in one kernel (``add_layer_norm``, L2);
* ``SDPA``: ``F.scaled_dot_product_attention``, a yardstick: the port
  never calls it.

Prints ms per chain (CUDA events, after a warm-up) and the launches of
one chain (:func:`run_ladder`), and for the first sublayer's core the max
|diff| against the einsum core and, for the rungs that launch kernel A,
against the plain version of the same function (:func:`ladder_errors`). On
the CPU (``--device cpu``, for a small check) every wrapper takes its plain
version. Without ``--device cpu`` it runs on the first CUDA device and
exits with an error when there is none.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from stego_torch.models.vit import VIT_CONFIGS
from stego_torch.ops import flash_attention as fa
from stego_torch.ops import layer_norm as ln

LAYERS = 12
EPS = VIT_CONFIGS["vit_small"][8].ln_eps


def _einsum_core(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(logits.to(qkv.dtype), dim=-1)
    return (attn @ v).transpose(1, 2).reshape(b, n, -1)


def _views(qkv: torch.Tensor, heads: int):
    """Head-major (B, H, N, d) views of q, k, v, and a new token-major
    output with its head-major view."""
    q, k, v = (x.transpose(1, 2)
               for x in qkv.unflatten(-1, (3, heads, -1)).unbind(2))
    out = torch.empty(qkv.shape[:2] + (qkv.shape[2] // 3,), dtype=qkv.dtype,
                      device=qkv.device)
    return q, k, v, out, out.unflatten(-1, (heads, -1)).transpose(1, 2)


def _head_major_views(fn: Callable, use_kernel: bool):
    def core(qkv, heads, scale):
        q, k, v, out, out_h = _views(qkv, heads)
        fn(q, k, v, scale, out=out_h, use_kernel=use_kernel)
        return out
    return core


def _copies_outside(use_kernel: bool):
    def core(qkv, heads, scale):
        q, k, v = (x.transpose(1, 2).contiguous()
                   for x in qkv.unflatten(-1, (3, heads, -1)).unbind(2))
        o = fa.batch_resident_attention(q, k, v, scale, use_kernel=use_kernel)
        return o.transpose(1, 2).flatten(2)
    return core


def _token_major(use_kernel: bool):
    def core(qkv, heads, scale):
        q, k, v = qkv.chunk(3, dim=-1)
        fn = fa.token_major_attention if use_kernel else fa.attention_plain
        return fn(q, k, v, heads, scale)
    return core


def _packed(use_kernel: bool):
    def core(qkv, heads, scale):
        return fa.packed_attention(qkv.unflatten(-1, (3, -1)), heads, scale,
                                   use_kernel=use_kernel)
    return core


def _sdpa_core(qkv, heads, scale):
    q, k, v, out, out_h = _views(qkv, heads)
    out_h.copy_(F.scaled_dot_product_attention(q, k, v, scale=scale))
    return out


def rungs(heads: int) -> List[tuple]:
    """(name, core, the core's plain version or None, fused add+LN)."""
    out = [("einsum", _einsum_core, None, False),
           ("head-major, copies outside", _copies_outside(True),
            _copies_outside(False), False),
           ("head-major views", _head_major_views(fa.trunk_attention, True),
            _head_major_views(fa.trunk_attention, False), False),
           ("head-major views, resident",
            _head_major_views(fa.resident_attention, True),
            _head_major_views(fa.resident_attention, False), False)]
    if heads % 2 == 0:
        out += [("token-major", _token_major(True), _token_major(False),
                 False),
                ("packed", _packed(True), _packed(False), False)]
    out += [("flash", _head_major_views(fa.flash_attention, True),
             _head_major_views(fa.flash_attention, False), False),
            ("no softmax", _head_major_views(fa.no_softmax_attention, True),
             _head_major_views(fa.no_softmax_attention, False), False)]
    if heads % 2 == 0:
        out.append(("token-major, add+LN fused", _token_major(True),
                    _token_major(False), True))
    else:
        out.append(("head-major views, add+LN fused",
                    _head_major_views(fa.trunk_attention, True),
                    _head_major_views(fa.trunk_attention, False), True))
    out.append(("SDPA (yardstick)", _sdpa_core, None, False))
    return out


def make_weights(dim: int, device: torch.device, seed: int = 0) -> Dict:
    """Seeded weights of 12 sublayers: qkv and proj 0.02 N(0, 1) in bf16,
    LayerNorm weight 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1) in f32."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=device)

    return {"qkv": (0.02 * rand(LAYERS, 3 * dim, dim)).bfloat16(),
            "qkv_b": (0.02 * rand(LAYERS, 3 * dim)).bfloat16(),
            "proj": (0.02 * rand(LAYERS, dim, dim)).bfloat16(),
            "proj_b": (0.02 * rand(LAYERS, dim)).bfloat16(),
            "ln_w": 1 + 0.1 * rand(LAYERS + 1, dim),
            "ln_b": 0.1 * rand(LAYERS + 1, dim)}


def chain(x: torch.Tensor, w: Dict, heads: int, core: Callable,
          fused: bool) -> torch.Tensor:
    """12 pre-LN attention sublayers over x (B, N, D) bf16."""
    scale = (x.shape[-1] // heads) ** -0.5
    h = ln.fused_layer_norm(x, w["ln_w"][0], w["ln_b"][0], EPS)
    for i in range(LAYERS):
        qkv = F.linear(h, w["qkv"][i], w["qkv_b"][i])
        y = F.linear(core(qkv, heads, scale), w["proj"][i], w["proj_b"][i])
        if fused:
            x, h = ln.add_layer_norm(x, y, w["ln_w"][i + 1],
                                     w["ln_b"][i + 1], EPS)
        else:
            x = x + y
            h = ln.fused_layer_norm(x, w["ln_w"][i + 1], w["ln_b"][i + 1],
                                    EPS)
    return x


def _launches() -> Dict[str, int]:
    return {**fa.ENTRY_LAUNCHES, "layer_norm": ln.LAUNCHES,
            "add_layer_norm": ln.ADD_LAUNCHES}


def _chain_ms(fn: Callable, iters: int, device: torch.device) -> float:
    fn()  # warm-up
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _inputs(model: str, batch: int, tokens: int, device: torch.device,
            seed: int):
    vit = VIT_CONFIGS[model][8]
    dim, heads = vit.embed_dim, vit.num_heads
    w = make_weights(dim, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(batch, tokens, dim, generator=g, device=device).bfloat16()
    return w, x, heads


def ladder_errors(model: str, batch: int = 32, tokens: int = 785,
                  device: Optional[torch.device] = None,
                  seed: int = 0) -> Dict[str, Dict]:
    """Each rung's core on the first sublayer's qkv against the einsum
    core (max |diff|) and against the plain version of the same function:
    max |diff| and the worst |diff| / tolerance, with rtol 2e-2, atol 5e-3
    (both round p at the same points, an f32 logit summed in another order
    may round p one bf16 ulp apart) and, for the no-softmax rung, whose p
    are the logits and whose outputs sums of N of them, two bf16 ulps of
    its largest output. None where there is no plain version."""
    device = torch.device("cuda", 0) if device is None else device
    w, x, heads = _inputs(model, batch, tokens, device, seed)
    scale = fa.HEAD_DIM ** -0.5
    out = {}
    with torch.no_grad():
        qkv0 = F.linear(ln.fused_layer_norm(x, w["ln_w"][0], w["ln_b"][0],
                                            EPS), w["qkv"][0], w["qkv_b"][0])
        ref = _einsum_core(qkv0, heads, scale).float()
        for name, core, plain, _ in rungs(heads):
            got = core(qkv0, heads, scale).float()
            err = ratio = None
            if plain is not None:
                want = plain(qkv0, heads, scale).float()
                diff = (got - want).abs()
                tol = (torch.full_like(want, 2 ** -7 * float(
                    want.abs().max())) if name == "no softmax"
                    else 5e-3 + 2e-2 * want.abs())
                err, ratio = float(diff.max()), float((diff / tol).max())
            out[name] = dict(max_abs_diff_einsum=float(
                (got - ref).abs().max()), max_abs_err_plain=err,
                worst_ratio_plain=ratio)
    return out


def run_ladder(model: str, batch: int = 32, tokens: int = 785,
               iters: int = 10, device: Optional[torch.device] = None,
               seed: int = 0) -> List[Dict]:
    """Every rung's chain for ``model`` (a key of VIT_CONFIGS): {rung, ms per
    chain, launches of one chain}. Runs 2 + ``iters`` chains a rung and
    nothing else, so that a caller can count its launches."""
    device = torch.device("cuda", 0) if device is None else device
    w, x, heads = _inputs(model, batch, tokens, device, seed)
    rows = []
    with torch.no_grad():
        for name, core, _, fused in rungs(heads):
            before = _launches()
            chain(x, w, heads, core, fused)
            launches = {k: v - before[k] for k, v in _launches().items()
                        if v != before[k]}
            ms = _chain_ms(lambda: chain(x, w, heads, core, fused), iters,
                           device)
            rows.append(dict(rung=name, ms=ms, launches=launches))
    return rows


def print_ladder(model: str, rows: List[Dict], errors: Dict[str, Dict],
                 batch: int, tokens: int) -> None:
    print(f"{model}: {LAYERS} chained pre-LN attention sublayers, B={batch}, "
          f"N={tokens}, H={VIT_CONFIGS[model][8].num_heads}, "
          f"d={fa.HEAD_DIM}, bf16")
    for r in rows:
        e = errors[r["rung"]]
        plain = ("" if e["max_abs_err_plain"] is None else
                 f", vs its plain version {e['max_abs_err_plain']:.3e} "
                 f"(worst / tolerance {e['worst_ratio_plain']:.3f})")
        print(f"  {r['rung']:34s} {r['ms']:9.3f} ms per chain; core vs "
              f"einsum max|diff| {e['max_abs_diff_einsum']:.3e}{plain}; "
              f"launches a chain {r['launches']}")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--models", default="vit_small,vit_base")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--tokens", type=int, default=785)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("attention_layouts: no CUDA device (pass --device cpu for a "
              "check with the plain versions)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.device == "cpu" else "cuda", 0)
    for model in args.models.split(","):
        errors = ladder_errors(model, args.batch, args.tokens, device)
        rows = run_ladder(model, args.batch, args.tokens, args.iters, device)
        print_ladder(model, rows, errors, args.batch, args.tokens)
    return 0


if __name__ == "__main__":
    sys.exit(main())
