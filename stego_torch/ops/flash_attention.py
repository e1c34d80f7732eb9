"""Forward-only attention for the frozen ViT trunk (kernel A).

Counterpart of every attention kernel of ``stego_tpu/ops/flash_attention.py``
and of the layout experiments of ``scripts/bench_attncore.py`` and
``scripts/bench_attn_vitb.py``. On the TPU each layout needs its own Pallas
kernel; here all of them launch ``csrc/attention.cu``, which reads q, k, v
and writes the output through per-tensor (batch, token, head) strides, so a
layout is a choice of strides and the views go to the kernel uncopied:

* token-major ``(B, N, H*d)``, head h at columns ``h*d .. h*d + d``:
  :func:`token_major_attention` (``pair_attention``, N_pad <= 1152, and
  ``pair_kv_attention``, N_pad <= 4096; an even head count) and
  :func:`packed_attention` (q, k, v of one ``(B, N, 3, H*d)`` tensor);
* head-major ``(B, H, N, d)``: :func:`batch_resident_attention`,
  :func:`kv_resident_attention` and :func:`resident_attention`, which
  :func:`trunk_attention` chooses among by N as the JAX trunk does (an odd
  head count, ViT-T's 3), :func:`flash_attention` and
  :func:`no_softmax_attention` (the matmuls-only experiment). Each takes an
  ``out`` of that shape, which may be a view of a token-major tensor: the
  trunk writes the output where its projection reads it.

The kernel keeps each TPU kernel's rounding points through its form
(:data:`FORMS`), and :func:`attention_heads_plain` is the plain PyTorch
version of every form:

* ``two_pass`` (pair, pair_kv, batch_resident, kv_resident, packed): q*scale
  in q's dtype, f32 logits, p = exp(s - max) rounded to v's dtype before the
  PV product, f32 accumulation divided by the row sum at the end;
* ``resident``: the f32 logits times scale, the normalised softmax rounded
  to v's dtype before the PV product, whose f32 sum is the output;
* ``flash``: the f32 logits times scale, an online softmax over blocks of
  TK = 128 keys (p rounded against the running max, the sum and the
  accumulator rescaled), divided by the sum at the end;
* ``no_softmax``: p = s, the logits of q*scale, rounded to v's dtype, no
  division (``bench_attncore.py:84-85``).

:func:`attention_op`, registered as the op ``stego_torch::attention``, is
the trunk's attention in functional form (token-major in, a new output)
for ``torch.export``: the serving artifact (``serve.py``) calls kernel A
through it, and it ends in the same launch as the functions above.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises: bf16 q/k/v of d = 64 the wgmma kernel, bf16 ones of d = 8, 16 or
32 (the sensitive accuracy instrument's tiny ViT has heads of 8) a simple
kernel of their own in the same source, f32 ones of d = 64 (an f32 trunk
with ``use_flash_attention``, which the JAX package also sends through its
Pallas kernels) the f32 instantiation A-f32, whose softmax forms take
their products on the tensor cores by 3xTF32 (``ops/tf32.py`` emulates that
arithmetic) and whose no-softmax form stays on f32 FMA. f32 heads narrower
than 64 raise. The kernel has no sequence bound; the N bounds below are
the JAX package's dispatch, kept so that both run the same numerics at
every resolution.
"""

from __future__ import annotations

from typing import Optional

import torch

from stego_torch.kernels import build

# Sequence bounds of the TPU's kernels (stego_tpu/ops/flash_attention.py:141,
# :353): the VMEM-resident kernels up to N_pad 1152, the kv-resident ones up
# to 4096, the einsum path beyond.
RESIDENT_MAX_N = 1152
KV_RESIDENT_MAX_N = 4096
TK = 128  # keys a step of flash_attention's online softmax (:24-25)
HEAD_DIM = 64  # the head width of the wgmma kernel and of A-f32
NARROW_HEAD_DIMS = (8, 16, 32)  # bf16 only, the narrow-head kernel
# The kernel's forms (csrc/attention.cu), by name.
FORMS = {"two_pass": 0, "resident": 1, "flash": 2, "no_softmax": 3}

# The C entry of each dtype the kernel takes (csrc/attention.cu).
ENTRIES = {torch.bfloat16: "stego_attention",
           torch.float32: "stego_attention_f32"}
# Launches of the CUDA kernel in this process (plain-version calls do not
# count): all of them, those on f32 q/k/v (A-f32), and by the JAX entry
# point each stands for (the token-major ones by N: pair up to
# RESIDENT_MAX_N, pair_kv beyond). Read and reset by chip_smoke.py to show
# the main path used it.
LAUNCHES = 0
F32_LAUNCHES = 0
ENTRY_LAUNCHES = dict.fromkeys(
    ("pair", "pair_kv", "packed", "resident", "batch_resident",
     "kv_resident", "flash", "no_softmax"), 0)
# and by head width
HEAD_DIM_LAUNCHES = dict.fromkeys(NARROW_HEAD_DIMS + (HEAD_DIM,), 0)


def reset_launches() -> None:
    global LAUNCHES, F32_LAUNCHES
    LAUNCHES = 0
    F32_LAUNCHES = 0
    for counts in (ENTRY_LAUNCHES, HEAD_DIM_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _n_pad(n: int) -> int:
    return -(-n // 128) * 128


def use_pair_attention(num_heads: int, head_dim: int, n: int) -> bool:
    """The JAX trunk's dispatch predicate for the token-major kernels
    (``stego_tpu/ops/flash_attention.py:567-575``): d = 64, an even head
    count, and N padded to 128 within KV_RESIDENT_MAX_N."""
    return (head_dim == HEAD_DIM and num_heads % 2 == 0
            and _n_pad(n) <= KV_RESIDENT_MAX_N)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*d) -> (B, H, N, d), a view."""
    return x.unflatten(-1, (num_heads, -1)).transpose(1, 2)


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    return q * torch.tensor(scale, dtype=q.dtype)


def attention_heads_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, form: str = "two_pass",
                          matmul=torch.matmul) -> torch.Tensor:
    """Head-major (B, H, N, d) attention in v's dtype with the rounding
    points of ``form`` (see the module docstring). ``matmul`` takes both
    f32 products. It is a seam for tests and ``chip_smoke.py`` only, which
    pass ``ops/tf32.py``'s emulations of the card's TF32 arithmetic through
    every form's own rounding points; no entry point passes it."""
    vf = v.float()

    def pv(p):
        return matmul(p.to(v.dtype).float(), vf)

    if form == "flash":
        qf = q.float()
        shape = q.shape[:-1] + (1,)
        m = torch.full(shape, -torch.inf, device=q.device)
        l = torch.zeros(shape, device=q.device)
        acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device)
        for k0 in range(0, k.shape[2], TK):
            s = matmul(qf, k[:, :, k0:k0 + TK].float().transpose(-1, -2)) \
                * scale
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + matmul(p.to(v.dtype).float(),
                                      vf[:, :, k0:k0 + TK])
            m = m_new
        return (acc / l).to(v.dtype)
    if form == "resident":
        s = matmul(q.float(), k.float().transpose(-1, -2)) * scale
        return pv(torch.softmax(s, dim=-1)).to(v.dtype)
    s = matmul(_scaled(q, scale).float(), k.float().transpose(-1, -2))
    if form == "no_softmax":
        return pv(s).to(v.dtype)
    if form != "two_pass":
        raise ValueError(f"unknown attention form {form!r}; have "
                         f"{sorted(FORMS)}")
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (pv(p) / p.sum(-1, keepdim=True)).to(v.dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, scale: float, matmul=torch.matmul
                    ) -> torch.Tensor:
    """softmax(q*scale . k^T) v per head, token-major in and out (the
    two-pass form)."""
    out = attention_heads_plain(_heads(q, num_heads), _heads(k, num_heads),
                                _heads(v, num_heads), scale, matmul=matmul)
    return out.transpose(1, 2).flatten(2)


def token_major_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int, scale: float) -> torch.Tensor:
    """Attention over token-major (B, N, H*d) q/k/v; output (B, N, H*d) in
    v's dtype. Gate with :func:`use_pair_attention`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads, scale)
    b, n, hd = q.shape
    out = torch.empty((b, n, hd), dtype=v.dtype, device=v.device)
    entry = "pair" if _n_pad(n) <= RESIDENT_MAX_N else "pair_kv"
    _launch(*(x.unflatten(-1, (num_heads, -1)) for x in (q, k, v, out)),
            scale, "two_pass", entry)
    return out


def packed_attention(qkv: torch.Tensor, num_heads: int, scale: float,
                     use_kernel: bool = True) -> torch.Tensor:
    """Attention straight from the packed qkv projection output
    (``flash_attention.py:630``): ``qkv`` is (B, N, 3, H*d), feature order
    [q|k|v] x [head] x [dim]; returns (B, N, H*d), token-major. The JAX
    kernel's contract holds: d = 64 and an even head count."""
    b, n, three, hd = qkv.shape
    if three != 3 or hd % num_heads or hd // num_heads != HEAD_DIM \
            or num_heads % 2:
        raise ValueError(f"packed attention needs (B, N, 3, H*64) with an "
                         f"even H; got {tuple(qkv.shape)}, H={num_heads}")
    q, k, v = qkv.unbind(2)
    if qkv.device.type == "cpu" or not use_kernel:
        return attention_plain(q, k, v, num_heads, scale)
    out = torch.empty((b, n, hd), dtype=qkv.dtype, device=qkv.device)
    _launch(*(x.unflatten(-1, (num_heads, -1)) for x in (q, k, v, out)),
            scale, "two_pass", "packed")
    return out


def attention_entry(num_heads: int, head_dim: int, n: int) -> Optional[str]:
    """The JAX trunk's attention entry point by head count and N: token-major
    ``pair``/``pair_kv`` where :func:`use_pair_attention` holds, else
    head-major ``batch_resident``/``kv_resident`` as :func:`trunk_attention`
    picks them; None beyond KV_RESIDENT_MAX_N (the caller's einsum path)."""
    n_pad = _n_pad(n)
    if use_pair_attention(num_heads, head_dim, n):
        return "pair" if n_pad <= RESIDENT_MAX_N else "pair_kv"
    if n_pad <= RESIDENT_MAX_N:
        return "batch_resident"
    return "kv_resident" if n_pad <= KV_RESIDENT_MAX_N else None


@torch.library.custom_op("stego_torch::attention", mutates_args=(),
                         device_types="cpu")
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 num_heads: int, scale: float) -> torch.Tensor:
    """The trunk's attention as a registered op, ``stego_torch::attention``:
    token-major (B, N, H*d) q, k, v (any strides with a contiguous last
    axis, e.g. the column blocks of one qkv) to a new contiguous (B, N, H*d)
    output in v's dtype, mutating nothing. It is what ``torch.export``
    traces (``models/vit.py``), since the direct calls read ``data_ptr``.
    On a CUDA tensor it launches kernel A at :func:`attention_entry`'s entry
    (counted there, as the direct calls are); on the CPU it is the plain
    version, the two-pass form of every one of those entries."""
    _op_entry(q, num_heads)
    return attention_plain(q, k, v, num_heads, scale)


def _op_entry(q: torch.Tensor, num_heads: int) -> str:
    b, n, hd = q.shape
    entry = attention_entry(num_heads, hd // num_heads, n)
    if entry is None:
        raise ValueError(f"stego_torch::attention: N={n} pads past "
                         f"KV_RESIDENT_MAX_N={KV_RESIDENT_MAX_N}")
    return entry


@attention_op.register_kernel("cuda")
def _attention_op_cuda(q, k, v, num_heads, scale):
    entry = _op_entry(q, num_heads)
    out = torch.empty(q.shape, dtype=v.dtype, device=v.device)
    _launch(*(x.unflatten(-1, (num_heads, -1)) for x in (q, k, v, out)),
            scale, "two_pass", entry)
    return out


@attention_op.register_fake
def _attention_op_fake(q, k, v, num_heads, scale):
    return q.new_empty(q.shape, dtype=v.dtype)


def _head_major(q, k, v, scale, form, entry, out, use_kernel):
    """Head-major (B, H, N, d) attention of ``form`` into ``out`` (a new
    tensor when None); the plain version for a CPU tensor or
    ``use_kernel=False``."""
    if q.dim() != 4 or k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"head-major attention needs (B, H, N, d) q, k, v; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if out is not None and out.shape != v.shape:
        raise ValueError(f"out {tuple(out.shape)} != {tuple(v.shape)}")
    if q.device.type == "cpu" or not use_kernel:
        got = attention_heads_plain(q, k, v, scale, form)
        return got if out is None else out.copy_(got)
    if out is None:
        out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(*(x.transpose(1, 2) for x in (q, k, v, out)), scale, form, entry)
    return out


def _check_resident_n(n: int, name: str) -> None:
    if _n_pad(n) > RESIDENT_MAX_N:
        raise ValueError(f"{name}: N={n} pads past RESIDENT_MAX_N="
                         f"{RESIDENT_MAX_N}; use kv_resident_attention or "
                         f"flash_attention for long sequences")


def resident_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, *, out: Optional[torch.Tensor] = None,
                       use_kernel: bool = True) -> torch.Tensor:
    """``flash_attention.py:144``: the scale on the f32 logits and the
    normalised softmax rounded to v's dtype (N_pad <= RESIDENT_MAX_N)."""
    _check_resident_n(q.shape[2], "resident_attention")
    return _head_major(q, k, v, scale, "resident", "resident", out,
                       use_kernel)


def batch_resident_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: float,
                             heads_per_step: Optional[int] = None, *,
                             out: Optional[torch.Tensor] = None,
                             use_kernel: bool = True) -> torch.Tensor:
    """``flash_attention.py:223`` (N_pad <= RESIDENT_MAX_N). On the TPU
    ``heads_per_step`` sizes a grid step to its VMEM; the card's kernel
    takes one (batch, head) a block whatever it is, so here it is only
    validated (it must divide H) and chooses nothing."""
    h = q.shape[1]
    hs = h if heads_per_step is None else int(heads_per_step)
    if hs <= 0 or h % hs:
        raise ValueError(f"heads_per_step={heads_per_step} does not divide "
                         f"{h} heads")
    _check_resident_n(q.shape[2], "batch_resident_attention")
    return _head_major(q, k, v, scale, "two_pass", "batch_resident", out,
                       use_kernel)


def kv_resident_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, *, out: Optional[torch.Tensor] = None,
                          use_kernel: bool = True) -> torch.Tensor:
    """``flash_attention.py:293``: the long-sequence form (res 320 and 448),
    the same rounding points as :func:`batch_resident_attention`."""
    return _head_major(q, k, v, scale, "two_pass", "kv_resident", out,
                       use_kernel)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, *, out: Optional[torch.Tensor] = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """``flash_attention.py:66``: online softmax over TK-key blocks, any
    N."""
    return _head_major(q, k, v, scale, "flash", "flash", out, use_kernel)


def no_softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, *, out: Optional[torch.Tensor] = None,
                         use_kernel: bool = True) -> torch.Tensor:
    """``bench_attncore.py:nopad_attention(do_softmax=False)``: the two
    products without the softmax, (q*scale . k^T) v, to time the matmuls
    alone."""
    return _head_major(q, k, v, scale, "no_softmax", "no_softmax", out,
                       use_kernel)


def trunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, *, out: Optional[torch.Tensor] = None,
                    use_kernel: bool = True) -> Optional[torch.Tensor]:
    """The JAX trunk's head-major dispatch (``flash_attention.py:369``) by
    N: :func:`batch_resident_attention` up to N_pad RESIDENT_MAX_N,
    :func:`kv_resident_attention` up to KV_RESIDENT_MAX_N, None beyond (the
    caller's einsum path). The TPU's VMEM budget picks the head slice and,
    when no slice fits, :func:`resident_attention`; at every shape a
    configuration reaches (d = 64, 3 heads, N_pad <= 1152) all heads fit, so
    the choice above is the JAX package's, and the budget is not ported."""
    n_pad = _n_pad(q.shape[2])
    if n_pad <= RESIDENT_MAX_N:
        return batch_resident_attention(q, k, v, scale, out=out,
                                        use_kernel=use_kernel)
    if n_pad <= KV_RESIDENT_MAX_N:
        return kv_resident_attention(q, k, v, scale, out=out,
                                     use_kernel=use_kernel)
    return None


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, scale: float, form: str, entry: str) -> None:
    """Kernel A on (B, N, H, d) views of q, k, v and ``out``, any strides
    with a contiguous last axis, all bf16 (d = 64 or one of
    NARROW_HEAD_DIMS) or all f32 (d = 64)."""
    global LAUNCHES, F32_LAUNCHES
    b, n, h, d = q.shape
    if q.dtype not in ENTRIES:
        raise ValueError(f"attention kernel takes bf16 or f32, q is "
                         f"{q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"attention kernel needs {name} on {q.device} "
                             f"(CUDA), got {x.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"attention kernel takes q, k, v and out of "
                             f"one dtype; q is {q.dtype}, {name} {x.dtype}")
        if x.shape != (b, n, h, d):
            raise ValueError(f"{name} shape {tuple(x.shape)} != "
                             f"{(b, n, h, d)}")
        if x.stride(3) != 1 or any(x.stride(i) % 8 for i in range(3)) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"attention kernel needs {name} with a contiguous last axis, "
                f"batch, token and head strides that are multiples of 8 and "
                f"a 16-byte aligned base; got strides {x.stride()}")
    narrow = d in NARROW_HEAD_DIMS
    if narrow and q.dtype == torch.float32:
        raise ValueError(
            f"attention kernel: f32 heads of {d} are not built (A-f32 takes "
            f"head_dim {HEAD_DIM}; the narrow-head kernel bf16 only): run the "
            f"f32 trunk without use_flash_attention, or a bf16 trunk "
            f"(ROADMAP.md queue 1, Accuracy at training scale)")
    if d != HEAD_DIM and not narrow:
        raise ValueError(f"attention kernel is built for head_dim "
                         f"{HEAD_DIM} and, in bf16, {NARROW_HEAD_DIMS}; "
                         f"got {d}")
    if out.numel() == 0:
        return

    def strides(x):
        return x.stride(0), x.stride(1), x.stride(2)

    lib = build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, h) + ((d,) if narrow else ()) + (
            *strides(q), *strides(k), *strides(v), *strides(out),
            float(scale), FORMS[form], q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    fn = lib.stego_attention_narrow if narrow else getattr(lib,
                                                           ENTRIES[q.dtype])
    build.check(fn(*args), "attention kernel")
    LAUNCHES += 1
    F32_LAUNCHES += q.dtype == torch.float32
    ENTRY_LAUNCHES[entry] += 1
    HEAD_DIM_LAUNCHES[d] += 1
