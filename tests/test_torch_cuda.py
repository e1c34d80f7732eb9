"""stego_torch CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from stego_torch.ops import flash_attention as fa
from stego_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda
EPS = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ln_inputs(rows, d, device, dtype):
    g = torch.Generator(device=device).manual_seed(rows + d)
    x = torch.randn(rows, d, generator=g, device=device) * 3 + 1.5
    w = 1 + 0.1 * torch.randn(d, generator=g, device=device)
    b = 0.1 * torch.randn(d, generator=g, device=device)
    return x.to(dtype), w, b


@pytest.mark.parametrize("rows,d", [(8 * 785, 384), (8 * 1601, 384),
                                    (3, 768), (13, 384), (8 * 785, 192),
                                    (8 * 1601, 192), (13, 192),
                                    (16 * 65, 32), (48 * 65, 32), (13, 32),
                                    (16 * 65, 64), (13, 64), (7, 1024),
                                    (5, 96)])
def test_layer_norm_kernel_bf16_within_one_ulp(cuda, rows, d):
    """Trunk shapes (ViT-S/8 and ViT-T/8 b=8 at res 224 and 320; the
    sensitive accuracy instrument's tiny ViT, D = 32, at batch 16 and its
    aug step's 48 images) and ragged ones, at the runtime-width kernel's
    widths too (64, 96, 1024)."""
    x, w, b = _ln_inputs(rows, d, cuda, torch.bfloat16)
    before = ln.LAUNCHES
    got = ln.fused_layer_norm(x, w, b, EPS)
    torch.cuda.synchronize()
    assert ln.LAUNCHES == before + 1
    want = ln.layer_norm_plain(x, w, b, EPS)
    assert torch.all((got.float() - want.float()).abs()
                     <= ln.bf16_ulp_tolerance(want))


@pytest.mark.parametrize("rows,d", [(8 * 785, 192), (8 * 785, 384),
                                    (13, 768), (16 * 65, 32), (13, 64)])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_add_layer_norm_kernel_matches_plain(cuda, rows, d, out_dtype):
    """L2, the residual form: r = bf16(x + y) bit for bit (one rounding of
    an exact f32 sum), LN(r) within one bf16 ulp (bf16 out) or rtol 1e-5,
    atol 1e-5 (f32 out: the f32 statistics summed in another order)."""
    x, w, b = _ln_inputs(rows, d, cuda, torch.bfloat16)
    y = torch.randn(rows, d, generator=torch.Generator(device=cuda)
                    .manual_seed(d), device=cuda).bfloat16()
    before = (ln.LAUNCHES, ln.ADD_LAUNCHES)
    r, out = ln.add_layer_norm(x, y, w, b, EPS, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (ln.LAUNCHES, ln.ADD_LAUNCHES) == (before[0], before[1] + 1)
    want_r, want = ln.add_layer_norm_plain(x, y, w, b, EPS, out_dtype)
    assert torch.equal(r, want_r) and out.dtype == want.dtype
    if out_dtype is None:
        assert torch.all((out.float() - want.float()).abs()
                         <= ln.bf16_ulp_tolerance(want))
    else:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_layer_norm_kernel_rejects_other_widths(cuda):
    """D must be a multiple of 32 up to 1024."""
    for d in (48, 1056):
        x, w, b = _ln_inputs(4, d, cuda, torch.bfloat16)
        with pytest.raises(ValueError, match="multiple of 32"):
            ln.fused_layer_norm(x, w, b, EPS)


@pytest.mark.parametrize("b,n,heads", [(8, 785, 6), (8, 1601, 6),
                                       (2, 3137, 6), (1, 1, 1), (2, 63, 3),
                                       (1, 64, 2), (3, 65, 2), (1, 200, 12)])
def test_attention_kernel_matches_plain(cuda, b, n, heads):
    """q/k/v as strided views of a packed qkv like the trunk's; q, k
    drawn N(0, 1) * 2 so softmax rows are peaked, v N(0, 1). rtol 2e-2,
    atol 5e-3: both versions round p to bf16 against the row max, and the
    f32 logits differ in summation order, so a p may round one bf16 ulp
    apart, moving the output by ~2**-8 |v|."""
    g = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(b, n, 3 * heads * 64, generator=g, device=cuda)
    qkv[..., :2 * heads * 64] *= 2
    q, k, v = qkv.bfloat16().split(heads * 64, dim=-1)
    before = fa.LAUNCHES
    got = fa.token_major_attention(q, k, v, heads, 0.125)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.attention_plain(q, k, v, heads, 0.125)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=5e-3)


@pytest.mark.parametrize("d", (fa.HEAD_DIM,) + fa.NARROW_HEAD_DIMS)
def test_attention_kernel_is_deterministic(cuda, d):
    """Two launches on the same inputs agree bit for bit, at every head
    width (128 // d heads)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 300, 128, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    heads = 128 // d
    a = fa.token_major_attention(q, k, v, heads, d ** -0.5)
    b = fa.token_major_attention(q, k, v, heads, d ** -0.5)
    assert fa.HEAD_DIM_LAUNCHES[d] >= 2
    assert torch.equal(a, b)
    for fn in (fa.resident_attention, fa.flash_attention):
        heads_major = [x.unflatten(-1, (heads, d)).transpose(1, 2)
                       for x in (q, k, v)]
        assert torch.equal(fn(*heads_major, d ** -0.5),
                           fn(*heads_major, d ** -0.5))


HEAD_MAJOR = ("resident_attention", "batch_resident_attention",
              "kv_resident_attention", "flash_attention",
              "no_softmax_attention", "trunk_attention")


def _head_major_inputs(dev, b, h, n, seed, d=64):
    """Head-major (B, H, N, d) views of one packed qkv, as the ViT-T trunk
    hands them: q, k ~ N(0, 4) so softmax rows are peaked, v ~ N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g, device=dev)
    qkv[:, :, :2] *= 2
    return [x.transpose(1, 2) for x in qkv.bfloat16().unbind(2)]


def attention_tolerance(name, want):
    """rtol 2e-2, atol 5e-3 (PARITY_r05's attention rows): both versions
    round p to bf16 at the same point, the f32 logits differ in summation
    order, so a p may round one bf16 ulp apart. The no-softmax form's p are
    the logits themselves, of order 10, and its outputs sums of N of them,
    so it is held to two bf16 ulps of its largest output."""
    if name == "no_softmax_attention":
        return torch.full_like(want, 2 ** -7 * float(want.abs().max()))
    return 5e-3 + 2e-2 * want.abs()


HEAD_MAJOR_SHAPES = [(8, 3, 785), (8, 3, 1601), (1, 3, 1), (2, 3, 63),
                     (1, 3, 130), (2, 3, 1153)]


@pytest.mark.parametrize("name,b,h,n", [
    (name, *shape) for name in HEAD_MAJOR for shape in HEAD_MAJOR_SHAPES
    # the resident forms keep the JAX package's bound, N_pad <= 1152
    if not (name in ("resident_attention", "batch_resident_attention")
            and -(-shape[2] // 128) * 128 > fa.RESIDENT_MAX_N)])
def test_head_major_attention_kernel_matches_plain(cuda, name, b, h, n):
    """Every head-major form of kernel A (A3, A4, S) at ViT-T's shapes (B=8,
    3 heads, N=785 and 1601) and ragged ones, on views of a packed qkv, the
    output written through a token-major view as the trunk does, against
    its plain version."""
    fn = getattr(fa, name)
    q, k, v = _head_major_inputs(cuda, b, h, n, seed=n + h)
    tok = torch.empty(b, n, h * 64, dtype=torch.bfloat16, device=cuda)
    out = tok.unflatten(-1, (h, 64)).transpose(1, 2)
    before = fa.LAUNCHES
    fn(q, k, v, 0.125, out=out)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fn(q, k, v, 0.125, use_kernel=False).float()
    diff = (out.float() - want).abs()
    assert torch.all(diff <= attention_tolerance(name, want)), \
        float(diff.max())


# the sensitive accuracy instrument's trunk (4 heads of 8 at res 64, N =
# 65; batch 16, and 48 images in its aug step) and ragged shapes
NARROW_SHAPES = [(16, 4, 65), (48, 4, 65), (1, 2, 1), (2, 3, 130),
                 (2, 4, 1153)]


@pytest.mark.parametrize("d", fa.NARROW_HEAD_DIMS)
@pytest.mark.parametrize("name", HEAD_MAJOR)
def test_narrow_head_attention_kernel_matches_plain(cuda, name, d):
    """The narrow-head kernel (bf16, d = 8, 16, 32) in every head-major
    form, on views of a packed qkv with the output written through a
    token-major view, against its plain version at the head-major gates;
    and token-major (B, N, H*d) in and out. One launch a call, counted
    under its head width."""
    fn = getattr(fa, name)
    scale = d ** -0.5
    for b, h, n in NARROW_SHAPES:
        if (name in ("resident_attention", "batch_resident_attention")
                and -(-n // 128) * 128 > fa.RESIDENT_MAX_N):
            continue
        q, k, v = _head_major_inputs(cuda, b, h, n, seed=n + h + d, d=d)
        tok = torch.empty(b, n, h * d, dtype=torch.bfloat16, device=cuda)
        out = tok.unflatten(-1, (h, d)).transpose(1, 2)
        before = fa.HEAD_DIM_LAUNCHES[d]
        fn(q, k, v, scale, out=out)
        torch.cuda.synchronize()
        assert fa.HEAD_DIM_LAUNCHES[d] == before + 1
        want = fn(q, k, v, scale, use_kernel=False).float()
        diff = (out.float() - want).abs()
        assert torch.all(diff <= attention_tolerance(name, want)), \
            (b, h, n, float(diff.max()))
        if name == "trunk_attention" and n <= 1152:
            tq, tk, tv = (x.transpose(1, 2).flatten(2) for x in (q, k, v))
            got = fa.token_major_attention(tq, tk, tv, h, scale)
            want = fa.attention_plain(tq, tk, tv, h, scale)
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=5e-3)


def test_narrow_f32_heads_raise(cuda):
    """f32 heads narrower than 64 have no kernel: they raise, naming the
    ROADMAP item, and launch nothing."""
    q = torch.zeros(1, 4, 9, 8, device=cuda)
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="f32 heads of 8"):
        fa.batch_resident_attention(q, q, q, 8 ** -0.5)
    assert fa.LAUNCHES == before


def test_flash_attention_kernel_at_res_448(cuda):
    """flash_attention at N = 3137 (res 448, the demo's footprint), ViT-T's
    3 heads: the online form over 25 blocks of 128 keys."""
    q, k, v = _head_major_inputs(cuda, 2, 3, 3137, seed=3)
    got = fa.flash_attention(q, k, v, 0.125).float()
    want = fa.flash_attention(q, k, v, 0.125, use_kernel=False).float()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("b,n,h", [(8, 785, 6), (2, 130, 12)])
def test_packed_attention_kernel_matches_plain(cuda, b, n, h):
    """packed_attention on the (B, N, 3, H*64) view of one qkv GEMM's
    output: one launch, token-major out."""
    g = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(b, n, 3, h * 64, generator=g, device=cuda)
    qkv[:, :, :2] *= 2
    qkv = qkv.bfloat16()
    before = fa.ENTRY_LAUNCHES["packed"]
    got = fa.packed_attention(qkv, h, 0.125)
    torch.cuda.synchronize()
    assert fa.ENTRY_LAUNCHES["packed"] == before + 1
    want = fa.packed_attention(qkv, h, 0.125, use_kernel=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=5e-3)


def test_head_major_forms_differ_where_their_rounding_does(cuda):
    """The forms are not one computation under four names: at ViT-T's
    shape the resident form (normalised p rounded to bf16) and the flash
    form (p rounded against a running max) differ from the two-pass form's
    output in many elements, each equal to its own plain version."""
    q, k, v = _head_major_inputs(cuda, 8, 3, 785, seed=11)
    two = fa.batch_resident_attention(q, k, v, 0.125)
    for fn in (fa.resident_attention, fa.flash_attention):
        other = fn(q, k, v, 0.125)
        assert int((other != two).sum()) > 1000


@pytest.mark.parametrize("n,entry", [(785, "pair"), (1601, "pair_kv")])
def test_token_major_launches_count_by_jax_entry(cuda, n, entry):
    """A token-major launch counts as the JAX entry point it stands for:
    pair_attention up to N_pad 1152, pair_kv_attention beyond."""
    q = torch.zeros(1, n, 128, device=cuda, dtype=torch.bfloat16)
    before = dict(fa.ENTRY_LAUNCHES)
    fa.token_major_attention(q, q, q, 2, 0.125)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fa.ENTRY_LAUNCHES.items()
            if v != before[k]} == {entry: 1}


def test_attention_kernel_rejects_other_head_widths(cuda):
    """Head widths other than 64 and the narrow ones (8, 16, 32)."""
    q = torch.zeros(1, 3, 9, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 64"):
        fa.batch_resident_attention(q, q, q, 0.125)


def test_attention_kernel_rejects_f32(cuda):
    """f32 q/k/v run A-f32; f32 mixed with bf16, and other dtypes, are
    refused."""
    q = torch.zeros(1, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        fa.token_major_attention(q, q.bfloat16(), q.bfloat16(), 2, 0.125)
    with pytest.raises(ValueError, match="bf16 or f32"):
        fa.token_major_attention(q.half(), q.half(), q.half(), 2, 0.125)


# every stride layout kernel A is handed: token-major (B, N, H*64),
# head-major (B, H, N, 64), a head-major view written into a token-major
# out (the ViT-T trunk), and the packed (B, N, 3, H*64) qkv
LAYOUTS = ("token_major", "head_major", "head_major_into_token_major",
           "packed")
# A-f32 against its plain version: the JAX package's f32 tolerance
# (tests/test_torch_attention.py); TF32 would fail it
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _layout_run(layout, form, qkv, h, use_kernel):
    """``form``'s attention of the (B, N, 3, H, 64) qkv in ``layout``,
    the output as (B, N, H*64)."""
    b, n = qkv.shape[:2]
    scale = 0.125
    if layout == "packed":
        return fa.packed_attention(qkv.flatten(3), h, scale,
                                   use_kernel=use_kernel)
    q, k, v = qkv.unbind(2)
    if layout == "token_major":
        q, k, v = (x.flatten(2) for x in (q, k, v))
        if not use_kernel:
            return fa.attention_plain(q, k, v, h, scale)
        return fa.token_major_attention(q, k, v, h, scale)
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    if layout == "head_major":
        q, k, v = (x.contiguous() for x in (q, k, v))
        out = None
    else:
        tok = torch.empty(b, n, h * 64, dtype=qkv.dtype, device=qkv.device)
        out = tok.unflatten(-1, (h, 64)).transpose(1, 2)
    fn = {"two_pass": fa.kv_resident_attention,
          "resident": fa.resident_attention, "flash": fa.flash_attention,
          "no_softmax": fa.no_softmax_attention}[form]
    got = fn(q, k, v, scale, out=out, use_kernel=use_kernel)
    return got.transpose(1, 2).flatten(2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [17, 200, 785, 1601, 3137])
def test_attention_kernel_layouts_at_ragged_n(cuda, n, layout, dtype):
    """Kernel A at ragged N (one partial 128-key tile and query tile, and
    the trunk's 785, 1601 and 3137) through every stride layout and every
    form the layout takes (token-major and packed: two-pass; head-major:
    each form, resident only within N_pad <= 1152), bf16 against its plain
    version at the attention tolerance (no_softmax: two bf16 ulps of its
    largest output), f32 (A-f32) at 2e-5; one launch a call. q, k ~ N(0,
    4), v ~ N(0, 1)."""
    b, h = (2, 6) if n < 3137 else (1, 2)
    g = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(b, n, 3, h, 64, generator=g, device=cuda)
    qkv[:, :, :2] *= 2
    qkv = qkv.to(dtype)
    forms = ["two_pass"]
    if layout.startswith("head_major"):
        forms += ["flash", "no_softmax"]
        if -(-n // 128) * 128 <= fa.RESIDENT_MAX_N:
            forms.append("resident")
    for form in forms:
        before = fa.LAUNCHES
        got = _layout_run(layout, form, qkv, h, True).float()
        torch.cuda.synchronize()
        assert fa.LAUNCHES == before + 1
        want = _layout_run(layout, form, qkv, h, False).float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **F32_TOL)
            continue
        name = f"{form}_attention" if form != "two_pass" else "kv"
        diff = (got - want).abs()
        assert torch.all(diff <= attention_tolerance(name, want)), \
            (form, float(diff.max()))


@pytest.mark.parametrize("form", ["two_pass", "resident", "flash",
                                  "no_softmax"])
def test_attention_f32_gate_rejects_single_tf32_pass(cuda, form):
    """A-f32 takes its products by 3xTF32 and holds the 2e-5 gate against
    its plain version; the plain version with one TF32 pass a product
    (ops/tf32.py) misses it (no_softmax: 2e-5 of its largest output).
    Head-major, B=2, H=3, N=785, q, k ~ N(0, 4), v ~ N(0, 1)."""
    from stego_torch.ops.tf32 import matmul_tf32

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(785)
    q, k, v = (torch.randn(2, 3, 785, 64, generator=g, device=cuda)
               for _ in range(3))
    q, k = 2 * q, 2 * k
    fn = {"two_pass": fa.batch_resident_attention,
          "resident": fa.resident_attention, "flash": fa.flash_attention,
          "no_softmax": fa.no_softmax_attention}[form]
    want = fn(q, k, v, 0.125, use_kernel=False)
    tol = (torch.full_like(want, 2e-5 * float(want.abs().max()))
           if form == "no_softmax" else 2e-5 + 2e-5 * want.abs())
    got = fn(q, k, v, 0.125)
    control = fa.attention_heads_plain(q, k, v, 0.125, form,
                                       matmul=matmul_tf32)
    assert bool(((got - want).abs() <= tol).all())
    assert not bool(((control - want).abs() <= tol).all())


def test_f32_trunk_runs_attention_kernel(cuda):
    """An f32 ViT-S/8-shaped trunk (6 heads, 2 blocks) with use_flash runs
    kernel A's f32 instantiation once a block, and LayerNorm stays plain,
    within the f32 tolerance of the same trunk through the plain versions."""
    from stego_torch.models.vit import ViTConfig, VisionTransformer
    from stego_torch.ops import layer_norm as ln_ops

    torch.manual_seed(0)
    vit = VisionTransformer(ViTConfig(patch_size=8, embed_dim=384, depth=2,
                                      num_heads=6, img_size=64)).to(cuda)
    img = torch.randn(2, 64, 64, 3, device=cuda)
    f32_before, ln_before = fa.F32_LAUNCHES, ln_ops.LAUNCHES
    def feats():
        return vit.get_intermediate_feat(img, 1, want_attn_qkv=False,
                                         dtype=torch.float32,
                                         use_flash=True)[0]

    got = feats()
    torch.cuda.synchronize()
    assert fa.F32_LAUNCHES == f32_before + 2
    assert ln_ops.LAUNCHES == ln_before
    vit.use_kernels = False
    want = feats()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


def _corr_inputs(dev, b, hw, cf, cc, s, neg, seed):
    """Seeded inputs of kernel C1: f32 feature and code maps, U(-1, 1)
    coordinates, super_perm negatives and the JAX package's default
    shifts."""
    from stego_torch.ops.math import super_perm

    g = torch.Generator(device=dev).manual_seed(seed)
    feats = [torch.randn(b, hw, hw, cf, generator=g, device=dev)
             for _ in range(2)]
    code = [torch.randn(b, hw, hw, cc, generator=g, device=dev)
            for _ in range(2)]
    coords = [torch.rand(b, s, s, 2, generator=g, device=dev) * 2 - 1
              for _ in range(2)]
    perms = [super_perm(b, g) for _ in range(neg)]
    shifts = [0.18, 0.12] + [0.46] * neg
    return feats, code, coords, perms, shifts


# A cd within CLAMP_TIE of a clamp bound may be clamped in one version and
# not in the other, which sum it in other orders; one such coefficient moves
# the ~560 code gradients it reaches (2 sides x 4 taps x 70 channels) by up
# to ~4e-3 at unit scale (seen on the card at 192 channels). Such inputs are
# drawn again.
CLAMP_TIE = 1e-7


def _corr_inputs_untied(dev, b, hw, cf, cc, s, neg, seed, opts):
    """:func:`_corr_inputs`, drawn again (seed + 1000 k) until no cd of the
    plain version lies within CLAMP_TIE of a bound of ``opts``' clamp."""
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops.corr_stream import clamp_bounds

    lo, hi = clamp_bounds(opts.get("zero_clamp", True),
                          opts.get("stabalize", False))
    for k in range(20):
        inputs = _corr_inputs(dev, b, hw, cf, cc, s, neg, seed + 1000 * k)
        feats, code, coords, perms, _ = inputs
        _, cd = c1.sampled_products_plain(feats[0], feats[1], code[0],
                                          code[1], coords[0], coords[1],
                                          perms)
        if float(torch.minimum((cd - lo).abs(), (cd - hi).abs()).min()) \
                > CLAMP_TIE:
            return inputs
    raise AssertionError("20 draws, each with a cd at a clamp bound")


def _corr_run(fn, feats, code, coords, perms, shifts, weights, **kw):
    """Losses, cd means and the code gradients of a fixed combination."""
    c = [x.clone().requires_grad_(True) for x in code]
    losses, cds = fn(feats[0], feats[1], c[0], c[1], coords[0], coords[1],
                     perms, shifts, **kw)
    total = (losses * weights[0]).sum() + (cds * weights[1]).sum()
    grads = torch.autograd.grad(total, c)
    return losses.detach(), cds.detach(), grads


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hw,cf,cc,s,neg,opts", [
    (16, 28, 384, 70, 11, 5, dict(pointwise=True, zero_clamp=True)),
    (16, 28, 384, 70, 11, 5, dict(pointwise=False, stabalize=True)),
    (3, 8, 40, 16, 4, 0, dict(pointwise=True, zero_clamp=False)),
    (2, 5, 8, 3, 3, 1, dict(pointwise=True, zero_clamp=True)),
    (2, 6, 200, 8, 5, 1, dict(pointwise=True, zero_clamp=True)),
    (16, 28, 192, 70, 11, 5, dict(pointwise=True, zero_clamp=True)),
    (16, 28, 768, 70, 11, 5, dict(pointwise=True, zero_clamp=True)),
    (16, 28, 768, 70, 11, 5, dict(pointwise=False, stabalize=True)),
    (2, 6, 500, 8, 5, 1, dict(pointwise=True, zero_clamp=True)),
    # past one code chunk (96) and one sample tile (128) a side: dim=100,
    # feature_samples=12, and a third tile with a ragged chunk
    (16, 28, 384, 100, 12, 5, dict(pointwise=True, zero_clamp=True)),
    (16, 28, 768, 100, 12, 5, dict(pointwise=False, stabalize=True)),
    (2, 9, 64, 200, 17, 1, dict(pointwise=True, zero_clamp=True)),
])
def test_corr_sampled_kernel_matches_plain(cuda, b, hw, cf, cc, s, neg,
                                           opts, feat_dtype):
    """Kernel C1 against its plain version at the train step's shape
    (ViT-S/8 at res 224, cocostuff27 head, 11 x 11 samples, 5 negatives)
    and at small ones (200 channels: an f32 chunk of 128 and a partial
    one; 500: a bf16 chunk of 384 and a partial one), at ViT-T's 192 and
    ViT-B's 768 channels (two bf16 chunks of 384, six f32 ones of 128),
    with bf16 features (a bf16 trunk) and f32 features (an f32 trunk).
    Losses and cd means within rtol 1e-4, atol 1e-6; code gradients, at
    weights that make the largest 1, within rtol 2e-4, atol 1e-5
    (PARITY_r05's sampled-loss rows): the two sum in other orders (the
    kernel's products are C2's, on the tensor cores); no cd at a clamp
    bound (:func:`_corr_inputs_untied`)."""
    from stego_torch.ops import corr_fused_sampling as c1

    torch.backends.cuda.matmul.allow_tf32 = False
    feats, code, coords, perms, shifts = _corr_inputs_untied(
        cuda, b, hw, cf, cc, s, neg, b + cf, opts)
    g = 2 + neg
    wts = torch.randn(2, g, generator=torch.Generator(device=cuda)
                      .manual_seed(7), device=cuda)
    opts = dict(opts, feat_dtype=feat_dtype)
    # weights that make the plain version's largest code gradient 1, so
    # that the gradient tolerance is measured against the gradient's size
    wts = wts / max(float(x.abs().max()) for x in _corr_run(
        c1.sampled_corr_plain, feats, code, coords, perms, shifts, wts,
        **opts)[2])
    f0, b0 = c1.FWD_LAUNCHES, c1.BWD_LAUNCHES
    got = _corr_run(c1.sampled_corr_fused, feats, code, coords, perms, shifts,
                    wts, **opts)
    torch.cuda.synchronize()
    assert (c1.FWD_LAUNCHES, c1.BWD_LAUNCHES) == (f0 + 1, b0 + 1)
    want = _corr_run(c1.sampled_corr_plain, feats, code, coords, perms,
                     shifts, wts, **opts)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6)
    for gg, ww in zip(got[2], want[2]):
        torch.testing.assert_close(gg, ww, rtol=2e-4, atol=1e-5)


def test_corr_sampled_f32_fd_gate_rejects_bf16_kernel(cuda):
    """The losses and gradients average fd over many elements, so a kernel
    that rounded f32 features to bf16 could pass their gates; fd itself,
    elementwise, tells them apart. At the train step's shape the f32
    kernel's fd is within 1e-5 of the f32 plain version's, and the bf16
    instantiation's on the same f32 features is not."""
    from stego_torch.ops import corr_fused_sampling as c1

    torch.backends.cuda.matmul.allow_tf32 = False
    feats, code, coords, perms, shifts = _corr_inputs(cuda, 16, 28, 384, 70,
                                                      11, 5, seed=3)
    # code that needs gradients, so that the losses keep the kernel's node
    code = [c.requires_grad_(True) for c in code]
    args = (feats[0], feats[1], code[0], code[1], coords[0], coords[1],
            perms)
    want = c1.sampled_products_plain(*args)[0]

    def fd_err(feat_dtype):
        losses, _ = c1.sampled_corr_fused(*args, shifts,
                                          feat_dtype=feat_dtype)
        return float((c1.kernel_fd(losses) - want).abs().max())

    assert fd_err(torch.float32) <= 1e-5
    assert fd_err(torch.bfloat16) > 1e-5


def test_corr_sampled_f32_fd_gate_rejects_single_tf32_pass(cuda):
    """C1's products are C2's, whose fd on f32 features is 3xTF32; one
    TF32 pass a product (the plain version's fd from TF32-rounded sets,
    ops/tf32.py) misses the 1e-5 fd gate at the train step's shape, which
    the kernel holds."""
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops.tf32 import round_tf32

    torch.backends.cuda.matmul.allow_tf32 = False
    feats, code, coords, perms, shifts = _corr_inputs(cuda, 16, 28, 384, 70,
                                                      11, 5, seed=3)
    code = [c.requires_grad_(True) for c in code]
    args = (feats[0], feats[1], code[0], code[1], coords[0], coords[1],
            perms)
    want = c1.sampled_products_plain(*args)[0]
    losses, _ = c1.sampled_corr_fused(*args, shifts,
                                      feat_dtype=torch.float32)
    assert float((c1.kernel_fd(losses) - want).abs().max()) <= 1e-5
    f = round_tf32(c1.sample_sets_plain(*args)[0])
    i1, i2 = c1.pair_rows(16, 7, cuda)
    one_pass = torch.bmm(f[i1], f[i2].transpose(1, 2))
    assert float((one_pass - want).abs().max()) > 1e-5


@pytest.mark.parametrize("feat_dtype,cf,cc,s", [
    (torch.bfloat16, 384, 70, 11), (torch.float32, 384, 70, 11),
    (torch.bfloat16, 384, 100, 12)])
def test_corr_sampled_kernel_is_deterministic(cuda, feat_dtype, cf, cc, s):
    """C1 gives the same bits twice: the losses, the cd means and both code
    gradients, which the adjoint adds a code-map row at a time in a fixed
    order, without atomics (bf16 and f32 features at ViT-S's 384 channels;
    dim=100 with 12 x 12 samples)."""
    from stego_torch.ops import corr_fused_sampling as c1

    feats, code, coords, perms, shifts = _corr_inputs(cuda, 16, 28, cf, cc,
                                                      s, 5, seed=11)
    wts = torch.randn(2, 7, generator=torch.Generator(device=cuda)
                      .manual_seed(7), device=cuda)

    def run():
        losses, cds, grads = _corr_run(c1.sampled_corr_fused, feats, code,
                                       coords, perms, shifts, wts,
                                       feat_dtype=feat_dtype)
        return (losses, cds) + tuple(grads)

    first, second = run(), run()
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("whole", [False, True])
def test_corr_sampled_out_of_range_permutation_gives_nan_sums(cuda, whole):
    """A negative whose permutation entry is out of range reads nothing: its
    group's loss and cd mean are NaN, the launches raise no fault, and the
    other groups' losses and cd means are those without it. With the whole
    permutation out of range its group adds nothing to the code gradients,
    which are then those without it."""
    from stego_torch.ops import corr_fused_sampling as c1

    feats, code, coords, perms, shifts = _corr_inputs(cuda, 16, 28, 384, 70,
                                                      11, 3, seed=5)
    bad = perms[-1].clone()
    if whole:
        bad[:] = 16
    else:
        bad[3] = -1
    wts = torch.randn(2, 5, generator=torch.Generator(device=cuda)
                      .manual_seed(7), device=cuda)
    got = _corr_run(c1.sampled_corr_fused, feats, code, coords,
                    perms[:-1] + [bad], shifts, wts,
                    feat_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    want = _corr_run(c1.sampled_corr_fused, feats, code, coords, perms[:-1],
                     shifts[:-1], wts[:, :-1], feat_dtype=torch.bfloat16)
    # the same rows and sums; the groups' means may differ in a last bit
    # (a reduction over another number of groups)
    for x, y in zip(got[:2], want[:2]):
        assert bool(torch.isnan(x[-1]))
        torch.testing.assert_close(x[:-1], y, rtol=1e-5, atol=1e-7)
    if whole:
        for x, y in zip(got[2], want[2]):
            torch.testing.assert_close(x, y, rtol=1e-5,
                                       atol=1e-6 * float(y.abs().max()))


def test_corr_sampled_kernel_rejects_one_image_batch(cuda):
    from stego_torch.ops import corr_fused_sampling as c1

    feats, code, coords, _, _ = _corr_inputs(cuda, 1, 8, 32, 8, 3, 0, seed=0)
    perm = [torch.zeros(1, dtype=torch.long, device=cuda)]
    with pytest.raises(ValueError, match="1-image batch"):
        c1.sampled_corr_fused(feats[0], feats[1], code[0], code[1],
                              coords[0], coords[1], perm, [0.1, 0.2, 0.3],
                              feat_dtype=torch.bfloat16)


def test_corr_sampled_kernel_rejects_other_feature_types(cuda):
    """A CUDA tensor never falls back to the plain version: a feature type
    the kernel has no instantiation for raises, and nothing launches."""
    from stego_torch.ops import corr_fused_sampling as c1

    feats, code, coords, perms, shifts = _corr_inputs(cuda, 2, 8, 32, 8, 3,
                                                      1, seed=0)
    before = c1.FWD_LAUNCHES
    with pytest.raises(ValueError, match="bf16 or f32 features"):
        c1.sampled_corr_fused(feats[0], feats[1], code[0], code[1],
                              coords[0], coords[1], perms, shifts,
                              feat_dtype=torch.float16)
    assert c1.FWD_LAUNCHES == before


def _stream_inputs(dev, b, hw, cf, cc, neg, seed, distinct=False,
                   feat_dtype=torch.bfloat16):
    """Seeded inputs of kernel C2: normalized feature (``feat_dtype``) and
    code (f32) maps and the pair rows of the self pair, the positive pair
    and ``neg`` negatives. Full-field (``distinct=False``): the maps of b
    images and their positives, negatives read by index, as
    ops/corr_stream.py:_full_field builds them. Grid-sampled
    (``distinct=True``): one map set a pair type, as the gather branch's
    sampled pairs are."""
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops.math import super_perm

    g = torch.Generator(device=dev).manual_seed(seed)
    m = (2 + neg if distinct else 2) * b
    feats = c2.prep(torch.randn(m, hw, hw, cf, generator=g, device=dev),
                    feat_dtype)
    code = c2.prep(torch.randn(m, hw, hw, cc, generator=g, device=dev))
    ar = torch.arange(b, device=dev)
    idx1 = ar.repeat(2 + neg)
    idx2 = (torch.arange(m, device=dev) if distinct else
            torch.cat([ar, ar + b] + [super_perm(b, g) for _ in range(neg)]))
    shifts = [0.18, 0.12] + [0.46] * neg
    return feats, code, idx1, idx2, shifts


def _stream_run(c2, feats, code, idx1, idx2, shifts, b, neg, wts, opts,
                use_kernel, code_bf16=None):
    """Losses, cd means and the code gradient of a fixed combination."""
    c = code.clone().requires_grad_(True)
    bf16 = opts.get("code_bf16", False) if code_bf16 is None else code_bf16
    losses, cds = c2.stream_loss(feats, c, idx1, idx2, shifts,
                                 [b] * (2 + neg), opts.get("pointwise", True),
                                 opts.get("zero_clamp", True),
                                 opts.get("stabalize", False), bf16,
                                 use_kernel)
    total = (losses * wts[0]).sum() + (cds * wts[1]).sum()
    (grad,) = torch.autograd.grad(total, [c])
    return losses.detach(), cds.detach(), grad


def _code_bf16_grads_agree(got, want):
    """code_bf16's gradient gate: the two versions compute cd in other
    orders, so a cd within an f32 rounding of the clamp's bound may be
    masked in one and not the other, moving a gradient row by up to ~2**-8
    of the largest gradient (the weights make it 1). All within rtol 2e-4,
    atol 2**-7, and at least 99% within the f32 tolerance (rtol 2e-4, atol
    1e-5); not rounding dL/dcd to bf16 moves nearly every element."""
    diff = (got - want).abs()
    inside = (diff <= 1e-5 + 2e-4 * want.abs()).float().mean()
    return bool((diff <= 2 ** -7 + 2e-4 * want.abs()).all()) \
        and float(inside) >= 0.99


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hw,cf,cc,neg,distinct,opts", [
    (16, 28, 384, 70, 5, False, dict(pointwise=True, zero_clamp=True)),
    (16, 28, 384, 70, 5, False, dict(pointwise=False, stabalize=True)),
    (16, 28, 384, 70, 5, False, dict(pointwise=True, zero_clamp=True,
                                     code_bf16=True)),
    (16, 11, 384, 70, 5, True, dict(pointwise=True, zero_clamp=True)),
    (16, 11, 384, 70, 5, True, dict(pointwise=True, zero_clamp=True,
                                    code_bf16=True)),
    (3, 8, 40, 16, 0, False, dict(pointwise=True, zero_clamp=False)),
    (2, 5, 8, 3, 1, False, dict(pointwise=False, zero_clamp=True,
                                code_bf16=True)),
    (4, 9, 32, 128, 2, False, dict(pointwise=True, stabalize=True)),
    (2, 7, 100, 16, 1, False, dict(pointwise=True, zero_clamp=True)),
    (16, 28, 192, 70, 5, False, dict(pointwise=True, zero_clamp=True)),
    (16, 28, 768, 70, 5, False, dict(pointwise=True, zero_clamp=True)),
    (16, 11, 768, 70, 5, True, dict(pointwise=False, stabalize=True)),
    (2, 7, 440, 16, 1, False, dict(pointwise=True, zero_clamp=True)),
    (2, 7, 768, 128, 1, False, dict(pointwise=True, zero_clamp=True)),
    # past one code chunk of 128: dim=160, and 300 (a third, ragged chunk)
    (16, 28, 384, 160, 5, False, dict(pointwise=True, zero_clamp=True)),
    (16, 11, 384, 160, 5, True, dict(pointwise=True, zero_clamp=True,
                                     code_bf16=True)),
    (16, 28, 768, 160, 5, False, dict(pointwise=False, stabalize=True)),
    (2, 7, 40, 300, 1, False, dict(pointwise=True, zero_clamp=True)),
])
def test_corr_stream_kernel_matches_plain(cuda, b, hw, cf, cc, neg, distinct,
                                          opts, feat_dtype):
    """Kernel C2 against its plain version, with bf16 features (a bf16
    trunk) and f32 features (an f32 trunk, whose tiles take the channels
    64 at a time: 100 channels are a chunk and a partial one), at ViT-T's
    192 and ViT-B's 768 channels (bf16: the other side in three chunks of
    256; f32: the own rows in chunks too), at 440 (a ragged last chunk) and
    at 768 feature with 128 code channels (the most shared memory): the
    full-field shape (ViT-S/8 at res 224, cocostuff27 head, 5 negatives,
    N = 784, 32 maps), the grid-sampled one (N = 121, 112 maps), both also
    with code_bf16, and small ragged ones (N = 64, 25, 81, 49, no
    negatives). Losses and cd means
    within rtol 1e-4, atol 1e-5; code gradients, at weights that make the
    largest 1, within rtol 2e-4, atol 1e-5 (PARITY_r05's corr rows): the
    two sum in other orders; with code_bf16 :func:`_code_bf16_grads_agree`.
    The kernel's gradient is deterministic."""
    from stego_torch.ops import corr_stream as c2

    torch.backends.cuda.matmul.allow_tf32 = False
    feats, code, idx1, idx2, shifts = _stream_inputs(
        cuda, b, hw, cf, cc, neg, seed=b + cf + cc, distinct=distinct,
        feat_dtype=feat_dtype)
    wts = torch.randn(2, 2 + neg, generator=torch.Generator(device=cuda)
                      .manual_seed(7), device=cuda)
    args = (c2, feats, code, idx1, idx2, shifts, b, neg)
    # weights that make the plain version's largest code gradient 1, so
    # that the gradient tolerance is measured against the gradient's size
    wts = wts / float(_stream_run(*args, wts, opts, False)[2].abs().max())
    f0, b0 = c2.FWD_LAUNCHES, c2.BWD_LAUNCHES
    got = _stream_run(*args, wts, opts, True)
    again = _stream_run(*args, wts, opts, True)
    torch.cuda.synchronize()
    assert (c2.FWD_LAUNCHES, c2.BWD_LAUNCHES) == (f0 + 2, b0 + 2)
    want = _stream_run(*args, wts, opts, False)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-5)
    if opts.get("code_bf16"):
        assert _code_bf16_grads_agree(got[2], want[2])
    else:
        torch.testing.assert_close(got[2], want[2], rtol=2e-4, atol=1e-5)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("hw,distinct", [(28, False), (11, True)])
def test_corr_stream_code_bf16_gate_rejects_f32_kernel(cuda, hw, distinct):
    """The control of the code_bf16 gate: the f32 kernel, which ignores
    code_bf16, on the raw and on the bf16-rounded code (the second has the
    bf16 forward and skips only the rounding of dL/dcd) fails it against
    the code_bf16 plain version."""
    from stego_torch.ops import corr_stream as c2

    torch.backends.cuda.matmul.allow_tf32 = False
    opts = dict(pointwise=True, zero_clamp=True, code_bf16=True)
    feats, code, idx1, idx2, shifts = _stream_inputs(
        cuda, 16, hw, 384, 70, 5, seed=hw, distinct=distinct)
    wts = torch.randn(2, 7, generator=torch.Generator(device=cuda)
                      .manual_seed(7), device=cuda)
    args = (c2, feats, code, idx1, idx2, shifts, 16, 5)
    wts = wts / float(_stream_run(*args, wts, opts, False)[2].abs().max())
    want = _stream_run(*args, wts, opts, False)
    for code_in in (code, code.bfloat16().float()):
        got = _stream_run(c2, feats, code_in, idx1, idx2, shifts, 16, 5, wts,
                          opts, True, code_bf16=False)
        assert not _code_bf16_grads_agree(got[2], want[2])


@pytest.mark.parametrize("hw,distinct", [(28, False), (11, True)])
def test_corr_stream_f32_row_sum_gate_rejects_bf16_kernel(cuda, hw,
                                                          distinct):
    """As for C1: at the full-field and grid-sampled shapes the f32
    kernel's fd row sums are within 1e-4 of the f32 plain version's, and
    the bf16 instantiation's on the same f32 features are not."""
    from stego_torch.ops import corr_stream as c2

    torch.backends.cuda.matmul.allow_tf32 = False
    feats, code, idx1, idx2, shifts = _stream_inputs(
        cuda, 16, hw, 384, 70, 5, seed=hw, distinct=distinct,
        feat_dtype=torch.float32)
    want = torch.bmm(feats[idx1], feats[idx2].transpose(1, 2)).sum(-1)

    def row_sum_err(feat_dtype):
        losses, _ = c2.stream_loss(feats.to(feat_dtype),
                                   code.requires_grad_(True), idx1, idx2,
                                   shifts, [16] * 7)
        return float((c2.kernel_row_sums(losses)[:, 2] - want).abs().max())

    assert row_sum_err(torch.float32) <= 1e-4
    assert row_sum_err(torch.bfloat16) > 1e-4


def test_corr_stream_f32_row_sum_gate_rejects_single_tf32_pass(cuda):
    """The kernel takes f32 products by 3xTF32; one TF32 pass a product, the
    plain version's fd from TF32-rounded features (ops/tf32.py), misses the
    1e-4 row-sum gate at the full-field shape, which the kernel holds."""
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops.tf32 import round_tf32

    torch.backends.cuda.matmul.allow_tf32 = False
    feats, code, idx1, idx2, shifts = _stream_inputs(
        cuda, 16, 28, 384, 70, 5, seed=28, feat_dtype=torch.float32)
    want = torch.bmm(feats[idx1], feats[idx2].transpose(1, 2)).sum(-1)
    losses, _ = c2.stream_loss(feats, code.requires_grad_(True), idx1, idx2,
                               shifts, [16] * 7)
    assert float((c2.kernel_row_sums(losses)[:, 2] - want).abs().max()) \
        <= 1e-4
    f = round_tf32(feats)
    tf32_sums = torch.bmm(f[idx1], f[idx2].transpose(1, 2)).sum(-1)
    assert float((tf32_sums - want).abs().max()) > 1e-4


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("code_bf16", [False, True])
def test_corr_stream_kernel_is_deterministic(cuda, feat_dtype, code_bf16):
    """Every instantiation of C2 at the full-field shape gives the same
    bits twice: the forward's row sums (all four) and the code gradient,
    which the backward sums in a fixed order without atomics."""
    from stego_torch.ops import corr_stream as c2

    feats, code, idx1, idx2, shifts = _stream_inputs(
        cuda, 16, 28, 384, 70, 5, seed=3, feat_dtype=feat_dtype)
    wts = torch.randn(2, 7, generator=torch.Generator(device=cuda)
                      .manual_seed(7), device=cuda)

    def run():
        c = code.clone().requires_grad_(True)
        losses, cds = c2.stream_loss(feats, c, idx1, idx2, shifts, [16] * 7,
                                     code_bf16=code_bf16)
        sums = c2.kernel_row_sums(losses).clone()
        total = (losses * wts[0]).sum() + (cds * wts[1]).sum()
        (grad,) = torch.autograd.grad(total, [c])
        return sums, grad

    first, second = run(), run()
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b,hw,cf,cc,neg,distinct,opts,feat_dtype", [
    (16, 28, 384, 70, 5, False, dict(pointwise=True, zero_clamp=True),
     torch.bfloat16),
    (16, 28, 384, 70, 5, False, dict(pointwise=False, stabalize=True),
     torch.float32),
    (16, 28, 384, 70, 5, False, dict(pointwise=True, zero_clamp=True,
                                     code_bf16=True), torch.bfloat16),
    (16, 11, 384, 70, 5, True, dict(pointwise=True, zero_clamp=True,
                                    code_bf16=True), torch.bfloat16),
    (16, 11, 384, 70, 5, True, dict(pointwise=True, zero_clamp=True),
     torch.float32),
    (16, 28, 384, 160, 5, False, dict(pointwise=True, zero_clamp=True),
     torch.bfloat16),
    (3, 8, 40, 16, 0, False, dict(pointwise=True, zero_clamp=False),
     torch.bfloat16),
    (2, 9, 32, 300, 1, False, dict(pointwise=False, zero_clamp=True,
                                   code_bf16=True), torch.float32),
])
@pytest.mark.parametrize("bad_row", [False, True])
def test_corr_stream_backward_matches_plain_on_stored_fd(
        cuda, b, hw, cf, cc, neg, distinct, opts, feat_dtype, bad_row):
    """The backward kernel reads the fd and clamp mask that the forward
    stored; its code gradient against stream_backward_plain on the same
    stored fd and mask, within rtol 2e-4, atol 1e-5 at weights that make
    the largest gradient 1 (the same coefficients, summed in another
    order; with code_bf16 too, since the mask is the same), at the
    full-field and grid-sampled shapes, past one code chunk (160, and 300
    in three), ragged n (64, 81) and with an extra pair row whose map index
    is out of range, in a group of its own: its row sums are NaN, and the
    backward reads none of its fd and adds nothing for it. The stored fd
    and mask agree with the plain version's wherever cd is not within 1e-6
    of a clamp bound."""
    from stego_torch.ops import corr_stream as c2

    torch.backends.cuda.matmul.allow_tf32 = False
    feats, code, idx1, idx2, shifts = _stream_inputs(
        cuda, b, hw, cf, cc, neg, seed=b + hw + cc, distinct=distinct,
        feat_dtype=feat_dtype)
    groups = [b] * (2 + neg)
    if bad_row:
        idx1 = torch.cat([idx1, idx1[:1]])
        idx2 = torch.cat([idx2, idx2.new_full((1,), code.shape[0])])
        groups, shifts = groups + [1], shifts + [0.3]
    code_bf16 = opts.get("code_bf16", False)
    wts = torch.randn(2, len(groups), generator=torch.Generator(device=cuda)
                      .manual_seed(7), device=cuda)
    c = code.clone().requires_grad_(True)
    losses, cds = c2.stream_loss(feats, c, idx1, idx2, shifts, groups,
                                 **opts)
    saved = c2.kernel_saved(losses)
    ok = torch.isfinite(losses)
    assert bool(ok[:2 + neg].all()) and not (bad_row and bool(ok[-1]))
    live = torch.where(ok, wts, torch.zeros_like(wts))
    total = (losses * live[0]).nan_to_num().sum() \
        + (cds * live[1]).nan_to_num().sum()
    (got,) = torch.autograd.grad(total, [c])
    scal = c2.backward_scalars(live[0], live[1], saved["gm"], shifts, groups,
                               code.shape[1])
    want = c2.stream_backward_plain(
        saved["fd"], saved["mask"], code, idx1, idx2, saved["acc"],
        scal[c2.row_groups(groups, cuda).long()], opts.get("pointwise", True),
        code_bf16)
    scale = float(want.abs().max())
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got / scale, want / scale, rtol=2e-4,
                               atol=1e-5)
    # what the forward stored, against the plain products
    rows = slice(0, len(idx1) - int(bad_row))
    i1, i2 = idx1[rows], idx2[rows]
    fd = torch.bmm(feats[i1].float(), feats[i2].float().transpose(1, 2))
    cq = code.bfloat16().float() if code_bf16 else code
    cd = torch.bmm(cq[i1], cq[i2].transpose(1, 2))
    lo, hi = c2.clamp_bounds(opts.get("zero_clamp", True),
                             opts.get("stabalize", False))
    torch.testing.assert_close(saved["fd"][rows], fd, rtol=0, atol=2e-5)
    clear = ((cd - lo).abs() > 1e-6) & ((cd - hi).abs() > 1e-6)
    plain_mask = (cd >= lo) & (cd <= hi)
    assert torch.equal(saved["mask"][rows][clear], plain_mask[clear])


def _near_bound_inputs(dev, cc, feat_dtype, b=4, hw=9, neg=1, cf=64,
                       seed=0):
    """C2's full-field pair rows over code maps whose cd lie many within
    1e-6 of the clamp bounds 0 and 0.8 (ops/tf32.py:near_bound_code) and
    seeded normalized features; and the clamp mask of each bound pair of
    the FMA chain in channel order (ops/tf32.py:cd_fma, emulated exactly)."""
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops import tf32
    from stego_torch.ops.math import super_perm

    g = torch.Generator(device=dev).manual_seed(seed)
    m = 2 * b
    code = tf32.near_bound_code(m, hw * hw, cc, seed).to(dev)
    feats = c2.prep(torch.randn(m, hw, hw, cf, generator=g, device=dev),
                    feat_dtype)
    ar = torch.arange(b, device=dev)
    idx1 = ar.repeat(2 + neg)
    idx2 = torch.cat([ar, ar + b] + [super_perm(b, g) for _ in range(neg)])
    cd = tf32.cd_fma(code[idx1], code[idx2])
    masks = {}
    for zero_clamp, stabalize in ((True, False), (False, True)):
        lo, hi = c2.clamp_bounds(zero_clamp, stabalize)
        near = ((cd - (lo if zero_clamp else hi)).abs() < 1e-6).sum()
        assert int(near) > 100
        masks[(zero_clamp, stabalize)] = (cd >= lo) & (cd <= hi)
    return feats, code, idx1, idx2, [0.18, 0.12] + [0.46] * neg, masks


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("zero_clamp,stabalize", [(True, False),
                                                  (False, True)])
@pytest.mark.parametrize("cc", [70, 160])
def test_corr_stream_stored_mask_is_the_fma_mask_near_bounds(
        cuda, cc, zero_clamp, stabalize, feat_dtype):
    """The forward takes the f32 cd by 3xTF32 and recomputes by FMA in
    channel order every entry within fixup_eps of a clamp bound: its
    stored clamp mask equals the FMA chain's bit for bit on code built to
    put many cd within 1e-6 of 0 and 0.8, at 70 code channels and past one
    chunk of 128 (160), with bf16 and f32 features."""
    from stego_torch.ops import corr_stream as c2

    feats, code, idx1, idx2, shifts, masks = _near_bound_inputs(
        cuda, cc, feat_dtype, seed=cc)
    c = code.clone().requires_grad_(True)
    losses, _ = c2.stream_loss(feats, c, idx1, idx2, shifts,
                               [4] * len(shifts), zero_clamp=zero_clamp,
                               stabalize=stabalize)
    assert torch.equal(c2.kernel_saved(losses)["mask"],
                       masks[(zero_clamp, stabalize)])


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("zero_clamp,stabalize", [(True, False),
                                                  (False, True)])
def test_corr_stream_fma_mask_control_without_fixup_fails(
        cuda, zero_clamp, stabalize, feat_dtype):
    """The control of the near-bound mask check: a build of the forward
    without the fix-up (STEGO_C2_FWD_ABLATION=8, as tools/c2_ablation.py
    builds its variants), its cd by 3xTF32 alone, stores masks that differ
    from the FMA chain's on the same inputs."""
    from stego_torch.kernels import build
    from stego_torch.ops import corr_stream as c2

    lib = build.load(build.build(("-DSTEGO_C2_FWD_ABLATION=8",)))
    feats, code, idx1, idx2, _, masks = _near_bound_inputs(
        cuda, 70, feat_dtype, seed=70)
    _, _, mask = c2.forward_launch(lib, feats, code, idx1.int(), idx2.int(),
                                   zero_clamp, stabalize, False, True)
    got = c2.unpack_mask(mask, code.shape[1])
    assert not torch.equal(got, masks[(zero_clamp, stabalize)])


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cc", [70, 160])
def test_corr_stream_fixup_margin_holds_on_the_tensor_cores(cuda, cc,
                                                           feat_dtype):
    """The fix-up's margin is wide enough for the card's 3xTF32: a build
    that records the entries it recomputes (STEGO_C2_FWD_ABLATION=16)
    finds |cd by 3xTF32 - cd by FMA| below fixup_eps / 8 over every one,
    at the full-field shape (B=16, 28x28, five negatives, 384 feature
    channels, seeded normalized code, zero_clamp) and on the near-bound
    inputs at both clamp bounds."""
    from stego_torch.kernels import build
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops import tf32
    from stego_torch.ops.math import super_perm

    lib = build.load(build.build(("-DSTEGO_C2_FWD_ABLATION=16",)))
    g = torch.Generator(device=cuda).manual_seed(cc)
    b, hw, neg = 16, 28, 5
    feats = c2.prep(torch.randn(2 * b, hw, hw, 384, generator=g,
                                device=cuda), feat_dtype)
    code = c2.prep(torch.randn(2 * b, hw, hw, cc, generator=g, device=cuda))
    ar = torch.arange(b, device=cuda)
    idx1 = ar.repeat(2 + neg)
    idx2 = torch.cat([ar, ar + b] + [super_perm(b, g) for _ in range(neg)])
    runs = [(feats, code, idx1, idx2, True, False)]
    nb_feats, nb_code, nb_idx1, nb_idx2, _, _ = _near_bound_inputs(
        cuda, cc, feat_dtype, seed=cc)
    runs += [(nb_feats, nb_code, nb_idx1, nb_idx2, zero_clamp, stabalize)
             for zero_clamp, stabalize in ((True, False), (False, True))]
    eps = tf32.fixup_eps(cc)
    c2.fixup_stats(lib, cuda)
    for f, c, i1, i2, zero_clamp, stabalize in runs:
        c2.forward_launch(lib, f, c, i1.int(), i2.int(), zero_clamp,
                          stabalize, False, True)
        torch.cuda.synchronize()
        count, gap = c2.fixup_stats(lib, cuda)
        assert count > 0
        assert gap < eps / 8, (count, gap, eps)


def test_corr_stream_forward_keeps_fd_only_for_a_gradient(cuda):
    """At the full-field shape the forward allocates fd (112 x 784 x 784
    f32, 275 MB) and the mask only when a gradient can be taken: under
    torch.no_grad() (the val steps) its peak device memory stays below a
    tenth of fd's bytes above what it started from; with a code that
    requires grad it rises by at least fd's bytes."""
    from stego_torch.ops import corr_stream as c2

    feats, code, idx1, idx2, shifts = _stream_inputs(cuda, 16, 28, 384, 70,
                                                     5, seed=5)
    fd_bytes = idx1.numel() * 784 * c2.fd_pitch(784) * 4
    c = code.clone().requires_grad_(True)

    def peak_rise(grad):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.set_grad_enabled(grad):
            out = c2.stream_loss(feats, c, idx1, idx2, shifts, [16] * 7)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        del out
        return rise

    peak_rise(False)  # the library is loaded and the allocator warm
    assert peak_rise(False) < fd_bytes / 10
    assert peak_rise(True) >= fd_bytes


def test_corr_stream_kernel_rejects_other_feature_types(cuda):
    """A CUDA tensor never falls back to the plain version: f16 features,
    and features wider than the kernel takes, raise before a launch."""
    from stego_torch.ops import corr_stream as c2

    feats, code, idx1, idx2, shifts = _stream_inputs(cuda, 2, 4, 16, 8, 1,
                                                     seed=0)
    before = c2.FWD_LAUNCHES
    with pytest.raises(ValueError, match="bf16 or f32 features"):
        c2.stream_loss(feats.half(), code, idx1, idx2, shifts, [2] * 3, True,
                       True, False, False, True)
    wide = torch.zeros(4, 16, c2.MAX_FEAT_CHANNELS + 8, device=cuda)
    with pytest.raises(ValueError, match="feature and"):
        c2.stream_loss(wide, code, idx1, idx2, shifts, [2] * 3, True, True,
                       False, False, True)
    assert c2.FWD_LAUNCHES == before


@pytest.mark.parametrize("kw,kernel", [
    (dict(), "C1"),
    (dict(full_field_loss=True), "C2"),
    (dict(fused_sampling="off"), "C2"),
])
def test_cached_f32_step_matches_plain_loss_step(cuda, kw, kernel):
    """One cached train step of an f32 trunk's cache (ViT patch 8, width
    128, depth 2, res 64, 8 images, dim 6, 3 x 3 samples, 2 negatives)
    with the loss's kernel, f32 tiles, against the same step with its plain
    version: metrics within rtol 1e-4, atol 1e-6, updated parameters within
    rtol 2e-4, atol 1e-5; one forward and one backward launch of the loss's
    kernel, none of the other."""
    import copy

    import numpy as np

    from stego_torch.config import Config
    from stego_torch.models.vit import ViTConfig
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import corr_stream as c2
    from stego_torch.train.feat_cache import build_feat_cache
    from stego_torch.train.segmenter import (UnsupervisedSegmenter,
                                             draw_step_randomness,
                                             make_cached_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(dataset_name="directory", dim=6, res=64, feature_samples=3,
                 neg_samples=2, batch_size=4, backbone_dtype="float32",
                 cache_backbone_feats=True, **kw)
    vit = ViTConfig(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                    img_size=64)
    seg = UnsupervisedSegmenter(5, cfg, vit_cfg=vit).to(cuda)
    rng = np.random.default_rng(0)

    class Contrastive:
        dataset = [(rng.standard_normal((64, 64, 3)).astype(np.float32),
                    rng.integers(-1, 5, (64, 64))) for _ in range(8)]

    cache = build_feat_cache(seg, Contrastive(), cfg)
    batch = {"ind": torch.tensor([0, 3, 5, 6], device=cuda),
             "ind_pos": torch.tensor([2, 1, 7, 4], device=cuda)}
    rand = draw_step_randomness(
        seg, 4, torch.Generator(device=cuda).manual_seed(1))
    out = {}
    for use_kernel in (True, False):
        twin = copy.deepcopy(seg)
        twin.use_corr_kernel = use_kernel
        before = (c1.FWD_LAUNCHES, c1.BWD_LAUNCHES, c2.FWD_LAUNCHES,
                  c2.BWD_LAUNCHES)
        metrics = make_cached_train_step(twin, with_hist=False)(cache, batch,
                                                                rand)
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(
            (c1.FWD_LAUNCHES, c1.BWD_LAUNCHES, c2.FWD_LAUNCHES,
             c2.BWD_LAUNCHES), before))
        want = ((1, 1, 0, 0) if kernel == "C1" else (0, 0, 1, 1)) \
            if use_kernel else (0, 0, 0, 0)
        assert delta == want
        out[use_kernel] = (metrics, dict(twin.named_parameters()))
    (mk, pk), (mp, pp) = out[True], out[False]
    for k in mp:
        torch.testing.assert_close(mk[k], mp[k], rtol=1e-4, atol=1e-6,
                                   msg=k)
    for n in pp:
        torch.testing.assert_close(pk[n], pp[n], rtol=2e-4, atol=1e-5,
                                   msg=n)


# A first Adam step moves a parameter by lr g / (|g| + 1e-8): below ~1e-7 it
# turns a gradient difference of a rounding into a parameter difference of
# the order of the gradient tolerance (-3.3e-9 against -4.3e-9 plain moved
# one by 2.6e-5 on the card, at ViT-B's cluster head with its largest
# gradient 5.8e-4). There the gradients are held instead.
ADAM_LIVE = 1e-7


@pytest.mark.parametrize("kw,kernel", [
    (dict(), "C1"),
    (dict(full_field_loss=True), "C2"),
])
def test_vit_base_train_step_runs_through_the_loss_kernels(cuda, kw, kernel):
    """The repaired fault: with ViT-B's 768 channels (the
    cocostuff27_vit_base preset, bf16 trunk at full width and depth, batch
    4, res 64) make_train_step raised on the card, because C1 and C2 took
    at most 384 and 512 feature channels. Now one step launches the loss's
    kernel and matches the same step with its plain version: metrics within
    rtol 1e-4, atol 1e-6; the gradients, |g_kernel - g_plain| / |g_plain|
    over every parameter, within 1e-5 (chip_smoke's ViT-B steps at res 224
    show 9e-8 with C1 and 4e-6 with C2; a wrong coefficient gives ~1e-1);
    updated parameters within rtol 2e-4, atol 1e-5 where the gradient is at
    least ADAM_LIVE."""
    import copy

    from stego_torch.config import Config, apply_preset
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import corr_stream as c2
    from stego_torch.train.segmenter import (UnsupervisedSegmenter,
                                             draw_step_randomness,
                                             make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert c1.MAX_FEAT_CHANNELS >= 768 and c2.MAX_FEAT_CHANNELS >= 768
    cfg = apply_preset(Config(dino_patch_size=8, res=64, batch_size=4,
                              backbone_dtype="bfloat16", run_crf=False, **kw),
                       "cocostuff27_vit_base")
    seg = UnsupervisedSegmenter(27, cfg, generator=torch.Generator()
                                .manual_seed(0)).to(cuda)
    seg.net.model.cast_blocks(torch.bfloat16)
    assert seg.net.n_feats == 768
    g = torch.Generator(device=cuda).manual_seed(2)
    img = torch.randn(4, 64, 64, 3, generator=g, device=cuda)
    batch = {"img": img, "img_pos": img + 0.05,
             "label": torch.randint(-1, 27, (4, 64, 64), generator=g,
                                    device=cuda)}
    rand = draw_step_randomness(seg, 4, g)
    out = {}
    for use_kernel in (True, False):
        twin = copy.deepcopy(seg)
        twin.use_corr_kernel = use_kernel
        before = (c1.FWD_LAUNCHES, c2.FWD_LAUNCHES)
        metrics = make_train_step(twin, with_hist=False)(batch, rand)
        torch.cuda.synchronize()
        launched = (c1.FWD_LAUNCHES - before[0], c2.FWD_LAUNCHES - before[1])
        want = ((1, 0) if kernel == "C1" else (0, 1)) if use_kernel \
            else (0, 0)
        assert launched == want
        out[use_kernel] = (metrics, dict(twin.named_parameters()),
                           {n: p.grad for n, p in twin.named_parameters()})
    (mk, pk, gk), (mp, pp, gp) = out[True], out[False]
    for k in mp:
        torch.testing.assert_close(mk[k], mp[k], rtol=1e-4, atol=1e-6,
                                   msg=k)
    names = [n for n in gp if gp[n] is not None]
    gap = math.sqrt(sum(float(((gk[n] - gp[n]) ** 2).sum()) for n in names)
                    / sum(float((gp[n] ** 2).sum()) for n in names))
    assert gap <= 1e-5, gap
    for n in names:
        live = gp[n].abs() >= ADAM_LIVE
        torch.testing.assert_close(pk[n][live], pp[n][live], rtol=2e-4,
                                   atol=1e-5, msg=lambda m, n=n: f"{n}: {m}")


def test_vit_tiny_trunk_launches_head_major_kernels(cuda):
    """A bf16 ViT-T/8 trunk at full width (192, 3 heads, 12 blocks): 12
    head-major attention launches (batch-resident at res 224, kv-resident
    at res 320) and 25 LayerNorm launches at D = 192 a call. Its last
    block's tokens, whose largest is ~10 with random weights (one bf16 ulp
    there is 0.0625), against the plain versions': max abs diff within
    2**-5 of the largest token value, mean within 2**-9 of it (12 blocks of
    bf16 rounding; a wrong head or key would move values by their own
    size)."""
    from stego_torch.models.vit import VIT_CONFIGS, VisionTransformer

    vit = VisionTransformer(VIT_CONFIGS["vit_tiny"][8],
                            torch.Generator().manual_seed(0)).to(cuda)
    vit.cast_blocks(torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    for res, entry in ((224, "batch_resident"), (320, "kv_resident")):
        img = torch.randn(2, res, res, 3, generator=g, device=cuda)
        kw = dict(n=1, want_attn_qkv=False, dtype=torch.bfloat16,
                  use_flash=True)
        before = (dict(fa.ENTRY_LAUNCHES), ln.LAUNCHES)
        with torch.no_grad():
            got = vit.get_intermediate_feat(img, **kw)[0][0]
            torch.cuda.synchronize()
            assert fa.ENTRY_LAUNCHES[entry] - before[0][entry] == 12
            assert sum(fa.ENTRY_LAUNCHES.values()) \
                - sum(before[0].values()) == 12
            assert ln.LAUNCHES - before[1] == 25
            vit.use_kernels = False
            want = vit.get_intermediate_feat(img, **kw)[0][0]
            vit.use_kernels = True
        diff = (got - want).abs()
        scale = float(want.abs().max())
        assert float(diff.max()) <= 2 ** -5 * scale \
            and float(diff.mean()) <= 2 ** -9 * scale, (
                float(diff.max()), float(diff.mean()), scale)


def test_f32_checkpoint_eval_runs_in_full_f32(cuda, tmp_path):
    """An f32 trunk's checkpoint through ``load_model_for_eval`` (the dataset
    eval's, the demo's and serving's loader), from torch's default flags (a
    fresh process: cuDNN TF32 on, matmul TF32 off), gives the flip-TTA code
    of the same step in full f32 at the f32 trunk's gates (rtol 1e-4, atol
    1e-5): loading an f32 trunk turns TF32 off. With cuDNN's TF32 the patch
    embedding moved that code by ~6.5e-4 on an H100 (ViT-S/8, res 320)."""
    from stego_torch.config import Config
    from stego_torch.eval.evaluate import flip_tta_code, load_model_for_eval
    from stego_torch.models.convert import save_stego_checkpoint
    from stego_torch.train.segmenter import UnsupervisedSegmenter

    kept = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        seg = UnsupervisedSegmenter(
            27, Config(dataset_name="cocostuff27", backbone_dtype="float32",
                       res=224),
            generator=torch.Generator().manual_seed(0))
        path = str(tmp_path / "f32.ckpt")
        save_stego_checkpoint(path, seg)
        loaded = load_model_for_eval(path, cuda)
        img = torch.randn(2, 224, 224, 3, device=cuda, generator=torch
                          .Generator(device=cuda).manual_seed(1))
        with torch.inference_mode():
            got = flip_tta_code(loaded, img)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.inference_mode():
            want = flip_tta_code(loaded, img)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = kept
