"""LayerNorm over the last axis with f32 statistics (kernel L), and its
residual form (L2).

Counterpart of ``stego_tpu/ops/layer_norm.py``. The bf16 ViT trunk calls
:func:`fused_layer_norm` 25 times a forward (``models/vit.py:_block_ln``);
:func:`add_layer_norm`, the residual add fused with the LayerNorm that
follows it, is dispatched nowhere in the trunk, as in the JAX package
(``layer_norm.py:147-155``: the extra write and read outweighed the add it
absorbs there); ``tools/attention_layouts.py`` runs it in its chain.

* :func:`layer_norm_plain` and :func:`add_layer_norm_plain` are the plain
  PyTorch versions: the explicit two-pass f32 form of the TPU kernels
  (``_ln_kernel``, ``_add_ln_kernel``). CPU tensors take them, and they are
  the references the kernel is held against on the card.
* :func:`fused_layer_norm` and :func:`add_layer_norm` dispatch by device: a
  CPU tensor goes to the plain version, a CUDA tensor launches
  ``csrc/layer_norm.cu`` or raises.
* :func:`layer_norm_op`, the op ``stego_torch::layer_norm``, is
  :func:`fused_layer_norm`'s forward for ``torch.export`` (the serving
  artifact, ``serve.py``), by the same dispatch.

Both are ``torch.autograd.Function``s whose backward is the plain form of
the JAX package's custom VJPs (``_ln_bwd`` :186-202, ``_add_ln_bwd``
:129-134), so gradients pass through them as through the JAX functions.
The frozen trunk runs them under ``torch.no_grad``, which records nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stego_torch.kernels import build

# Every D the kernel takes: the multiples of 32 up to 1024; ViT-T's 192,
# ViT-S's 384 and ViT-B's 768 have instantiations of their own, the rest
# (the sensitive accuracy instrument's 32) the runtime-width kernel.
KERNEL_WIDTHS = tuple(range(32, 1025, 32))
# Launches of the CUDA kernel's two entries in this process (plain-version
# calls do not count), and of both by D. Read and reset by chip_smoke.py
# to show the main path used them.
LAUNCHES = 0
ADD_LAUNCHES = 0
WIDTH_LAUNCHES: dict = {}


def _normalize(xf: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    inv_d = 1.0 / xf.shape[-1]
    mean = xf.sum(-1, keepdim=True) * inv_d
    xc = xf - mean
    var = (xc * xc).sum(-1, keepdim=True) * inv_d
    y = xc * torch.rsqrt(var + eps)
    return y * weight.float() + bias.float()


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Two-pass f32 LayerNorm: mean = sum(x)/D, var = sum((x-mean)^2)/D,
    (x - mean) * rsqrt(var + eps) * weight + bias, in x's dtype."""
    return _normalize(x.float(), weight, bias, eps).to(x.dtype)


def add_layer_norm_plain(x: torch.Tensor, y: torch.Tensor,
                         weight: torch.Tensor, bias: torch.Tensor, eps: float,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r, LN(r)) with r = x + y rounded to x's dtype and the statistics of
    the rounded sum (``_add_ln_kernel`` :72-86); LN(r) in ``out_dtype``
    (default x's)."""
    r = (x.float() + y.float()).to(x.dtype)
    out = _normalize(r.float(), weight, bias, eps)
    return r, out.to(x.dtype if out_dtype is None else out_dtype)


def bf16_ulp_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each element of ``ref``, taken at
    a magnitude of at least 2**-8: the tolerance a bf16 LayerNorm is held to
    against another. An output below 2**-8 is a cancellation of
    x_hat * weight against bias, terms of order 1 whose f32 rounding
    (~1e-7) then decides more than one bf16 bit; one ulp at 2**-8 is 3e-5."""
    mag = ref.float().abs().clamp_min(2.0 ** -8)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _ln_backward(x2: torch.Tensor, weight: torch.Tensor, eps: float,
                 dy: torch.Tensor):
    """``_ln_bwd`` (:186-202) on (R, D) rows: dx in x's dtype, dweight and
    dbias in weight's."""
    xf = x2.float()
    dyf = dy.float()
    mean = xf.mean(1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = xc * inv
    dg = (dyf * xhat).sum(0).to(weight.dtype)
    db = dyf.sum(0).to(weight.dtype)
    dxhat = dyf * weight.float()
    dx = inv * (dxhat - dxhat.mean(1, keepdim=True)
                - xhat * (dxhat * xhat).mean(1, keepdim=True))
    return dx.to(x2.dtype), dg, db


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if x.device.type == "cpu":
            return layer_norm_plain(x, weight, bias, eps)
        return _launch(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        d = x.shape[-1]
        dx, dg, db = _ln_backward(x.reshape(-1, d), weight, ctx.eps,
                                  dy.reshape(-1, d))
        return dx.reshape(x.shape), dg, db, None


class _AddLayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, weight, bias, eps, out_dtype):
        if x.device.type == "cpu":
            r, out = add_layer_norm_plain(x, y, weight, bias, eps, out_dtype)
        else:
            r, out = _launch_add(x, y, weight, bias, eps, out_dtype)
        ctx.save_for_backward(r, weight)
        ctx.eps = eps
        return r, out

    @staticmethod
    def backward(ctx, dr, dout):
        """``_add_ln_bwd`` (:129-134): the LN's dx (rounded to r's dtype)
        plus the cotangent of r, rounded to r's dtype, for both x and y."""
        r, weight = ctx.saved_tensors
        d = r.shape[-1]
        dx_ln, dg, db = _ln_backward(r.reshape(-1, d), weight, ctx.eps,
                                     dout.reshape(-1, d))
        total = dx_ln.float().reshape(r.shape)
        if dr is not None:
            total = dr.float() + total
        total = total.to(r.dtype)
        return total, total, dg, db, None, None


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm of ``x`` (..., D) with (D,) f32 ``weight``/``bias``. On a
    CUDA tensor ``x`` must be bf16 with D in KERNEL_WIDTHS."""
    return _LayerNorm.apply(x, weight, bias, eps)


@torch.library.custom_op("stego_torch::layer_norm", mutates_args=(),
                         device_types="cpu")
def layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """:func:`fused_layer_norm`'s forward as a registered op,
    ``stego_torch::layer_norm``, for ``torch.export`` (the direct call reads
    ``data_ptr``): kernel L on a CUDA tensor (bf16 rows of D in
    KERNEL_WIDTHS, counted in LAUNCHES), the plain version on the CPU. No
    gradient: the serving artifact runs the frozen trunk."""
    return layer_norm_plain(x, weight, bias, eps)


@layer_norm_op.register_kernel("cuda")
def _layer_norm_op_cuda(x, weight, bias, eps):
    return _launch(x, weight, bias, eps)


@layer_norm_op.register_fake
def _layer_norm_op_fake(x, weight, bias, eps):
    return torch.empty_like(x)


def add_layer_norm(x: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float,
                   out_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused residual add + LayerNorm (``layer_norm.py:140``): returns
    ``(x + y, LN(x + y))``, the sum rounded to x's dtype before its f32
    statistics, LN in ``out_dtype`` (default x's: bf16, or f32). x and y
    share one dtype (the JAX function asserts it). On a CUDA tensor x and y
    must be bf16 with D in KERNEL_WIDTHS."""
    if x.dtype != y.dtype or x.shape != y.shape:
        raise ValueError(f"add_layer_norm needs x and y of one dtype and "
                         f"shape; got {x.dtype} {tuple(x.shape)} and "
                         f"{y.dtype} {tuple(y.shape)}")
    return _AddLayerNorm.apply(x, y, weight, bias, eps, out_dtype)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           what: str) -> int:
    d = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.bfloat16 or d not in KERNEL_WIDTHS:
        raise ValueError(f"{what} kernel takes bf16 rows of D a multiple of "
                         f"32 up to 1024; got {x.dtype}, D={d}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs a contiguous, 16-byte "
                         f"aligned input")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.dtype != torch.float32 or p.shape != (d,)
                or not p.is_contiguous() or p.device != x.device
                or p.data_ptr() % 16):
            raise ValueError(
                f"{what} {name} must be a contiguous, 16-byte aligned "
                f"f32 ({d},) tensor on {x.device}; got {p.dtype} "
                f"{tuple(p.shape)} on {p.device}")
    return d


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    global LAUNCHES
    d = _check(x, weight, bias, "layer_norm")
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    err = build.library().stego_layer_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        rows, d, float(eps), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "layer_norm kernel")
    LAUNCHES += 1
    WIDTH_LAUNCHES[d] = WIDTH_LAUNCHES.get(d, 0) + 1
    return y


def _launch_add(x: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, eps: float,
                out_dtype: Optional[torch.dtype]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    global ADD_LAUNCHES
    d = _check(x, weight, bias, "add_layer_norm")
    if y.device != x.device or not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError("add_layer_norm kernel needs y contiguous, 16-byte "
                         "aligned and on x's device")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"add_layer_norm kernel writes bf16 or f32, not "
                         f"{out_dtype}")
    r = torch.empty_like(x)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rows = x.numel() // d
    if rows == 0:
        return r, out
    err = build.library().stego_add_layer_norm(
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        r.data_ptr(), out.data_ptr(), rows, d,
        int(out_dtype == torch.float32), float(eps), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "add_layer_norm kernel")
    ADD_LAUNCHES += 1
    WIDTH_LAUNCHES[d] = WIDTH_LAUNCHES.get(d, 0) + 1
    return r, out
