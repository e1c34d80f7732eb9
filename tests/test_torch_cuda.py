"""stego_torch CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

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
                                    (3, 768), (13, 384)])
def test_layer_norm_kernel_bf16_within_one_ulp(cuda, rows, d):
    """Trunk shapes (ViT-S/8 b=8 at res 224 and 320) and ragged ones."""
    x, w, b = _ln_inputs(rows, d, cuda, torch.bfloat16)
    before = ln.LAUNCHES
    got = ln.fused_layer_norm(x, w, b, EPS)
    torch.cuda.synchronize()
    assert ln.LAUNCHES == before + 1
    want = ln.layer_norm_plain(x, w, b, EPS)
    assert torch.all((got.float() - want.float()).abs()
                     <= ln.bf16_ulp_tolerance(want))


def test_layer_norm_kernel_rejects_other_widths(cuda):
    x, w, b = _ln_inputs(4, 256, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
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


def test_attention_kernel_is_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 300, 128, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    a = fa.token_major_attention(q, k, v, 2, 0.125)
    b = fa.token_major_attention(q, k, v, 2, 0.125)
    assert torch.equal(a, b)


def test_attention_kernel_rejects_f32(cuda):
    q = torch.zeros(1, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        fa.token_major_attention(q, q, q, 2, 0.125)


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


def _corr_run(fn, feats, code, coords, perms, shifts, weights, **kw):
    """Losses, cd means and the code gradients of a fixed combination."""
    c = [x.clone().requires_grad_(True) for x in code]
    losses, cds = fn(feats[0], feats[1], c[0], c[1], coords[0], coords[1],
                     perms, shifts, feat_dtype=torch.bfloat16, **kw)
    total = (losses * weights[0]).sum() + (cds * weights[1]).sum()
    grads = torch.autograd.grad(total, c)
    return losses.detach(), cds.detach(), grads


@pytest.mark.parametrize("b,hw,cf,cc,s,neg,opts", [
    (16, 28, 384, 70, 11, 5, dict(pointwise=True, zero_clamp=True)),
    (16, 28, 384, 70, 11, 5, dict(pointwise=False, stabalize=True)),
    (3, 8, 40, 16, 4, 0, dict(pointwise=True, zero_clamp=False)),
    (2, 5, 8, 3, 3, 1, dict(pointwise=True, zero_clamp=True)),
])
def test_corr_sampled_kernel_matches_plain(cuda, b, hw, cf, cc, s, neg,
                                           opts):
    """Kernel C1 against its plain version at the train step's shape
    (ViT-S/8 at res 224, cocostuff27 head, 11 x 11 samples, 5 negatives)
    and at small ones. Losses and cd means within rtol 1e-4, atol 1e-6;
    code gradients within rtol 2e-4, atol 1e-5 (PARITY_r05's sampled-loss
    rows): the two sum in other orders, and the kernel's gradient adds with
    f32 atomics."""
    from stego_torch.ops import corr_fused_sampling as c1

    torch.backends.cuda.matmul.allow_tf32 = False
    feats, code, coords, perms, shifts = _corr_inputs(cuda, b, hw, cf, cc, s,
                                                      neg, seed=b + cf)
    g = 2 + neg
    wts = torch.randn(2, g, generator=torch.Generator(device=cuda)
                      .manual_seed(7), device=cuda)
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


def test_corr_sampled_kernel_rejects_one_image_batch(cuda):
    from stego_torch.ops import corr_fused_sampling as c1

    feats, code, coords, _, _ = _corr_inputs(cuda, 1, 8, 32, 8, 3, 0, seed=0)
    perm = [torch.zeros(1, dtype=torch.long, device=cuda)]
    with pytest.raises(ValueError, match="1-image batch"):
        c1.sampled_corr_fused(feats[0], feats[1], code[0], code[1],
                              coords[0], coords[1], perm, [0.1, 0.2, 0.3],
                              feat_dtype=torch.bfloat16)


def test_corr_sampled_kernel_rejects_f32_features(cuda):
    from stego_torch.ops import corr_fused_sampling as c1

    feats, code, coords, perms, shifts = _corr_inputs(cuda, 2, 8, 32, 8, 3,
                                                      1, seed=0)
    with pytest.raises(ValueError, match="bf16 features"):
        c1.sampled_corr_fused(feats[0], feats[1], code[0], code[1],
                              coords[0], coords[1], perms, shifts,
                              feat_dtype=torch.float32)


def _stream_inputs(dev, b, hw, cf, cc, neg, seed, distinct=False):
    """Seeded inputs of kernel C2: normalized feature (bf16) and code (f32)
    maps and the pair rows of the self pair, the positive pair and ``neg``
    negatives. Full-field (``distinct=False``): the maps of b images and
    their positives, negatives read by index, as ops/corr_stream.py:
    _full_field builds them. Grid-sampled (``distinct=True``): one map set
    a pair type, as the gather branch's sampled pairs are."""
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops.math import super_perm

    g = torch.Generator(device=dev).manual_seed(seed)
    m = (2 + neg if distinct else 2) * b
    feats = c2.prep(torch.randn(m, hw, hw, cf, generator=g, device=dev),
                    torch.bfloat16)
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
])
def test_corr_stream_kernel_matches_plain(cuda, b, hw, cf, cc, neg, distinct,
                                          opts):
    """Kernel C2 against its plain version: the full-field shape (ViT-S/8
    at res 224, cocostuff27 head, 5 negatives, N = 784, 32 maps), the
    grid-sampled one (N = 121, 112 maps), both also with code_bf16, and
    small ragged ones (N = 64, 25, 81, no negatives). Losses and cd means
    within rtol 1e-4, atol 1e-5; code gradients, at weights that make the
    largest 1, within rtol 2e-4, atol 1e-5 (PARITY_r05's corr rows): the
    two sum in other orders; with code_bf16 :func:`_code_bf16_grads_agree`.
    The kernel's gradient is deterministic."""
    from stego_torch.ops import corr_stream as c2

    torch.backends.cuda.matmul.allow_tf32 = False
    feats, code, idx1, idx2, shifts = _stream_inputs(
        cuda, b, hw, cf, cc, neg, seed=b + cf + cc, distinct=distinct)
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


def test_corr_stream_kernel_rejects_f32_features(cuda):
    """A CUDA tensor never falls back to the plain version: f32 features
    raise."""
    from stego_torch.ops import corr_stream as c2

    feats, code, idx1, idx2, shifts = _stream_inputs(cuda, 2, 4, 16, 8, 1,
                                                     seed=0)
    before = c2.FWD_LAUNCHES
    with pytest.raises(ValueError, match="bf16 features"):
        c2.stream_loss(feats.float(), code, idx1, idx2, shifts, [2] * 3, True,
                   True, False, False, True)
    assert c2.FWD_LAUNCHES == before
    f = torch.randn(2, 4, 4, 16, device=cuda)
    c = torch.randn(2, 4, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="bf16 features"):
        c2.fused_correlation_loss_multi([(f, f, c, c)], [0.1])
