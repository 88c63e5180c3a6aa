"""The hand-written CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU; every test skips without one. This file imports no JAX, so it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(tests/conftest.py configures JAX, hence --noconftest there.)"""

import numpy as np
import pytest
import torch

from indextts_tpu_torch.ops.cuda import aa_conv_branch as k2
from indextts_tpu_torch.ops.cuda import antialias as k1
from indextts_tpu_torch.ops.cuda import antialias_folded as k4
from indextts_tpu_torch.ops.cuda import antialias_tmajor as k3
from indextts_tpu_torch.ops.cuda import decode_attn as k6
from indextts_tpu_torch.ops.cuda import qmatmul as k5

# (K, N) of the GPT matmuls at the published IndexTTS-1.5 width: qkv, proj,
# mlp fc, mlp proj, mel head
K5_SHAPES = [(1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280), (1280, 8194)]


# the vocoder's six stages at ~100 codes, (C, T)
STAGE_SHAPES = [(768, 1600), (384, 6400), (192, 12800), (96, 25600), (48, 51200), (24, 102400)]
# T of no 16-byte vector, of no chunk, shorter than the stencil, one frame; on C = 7
RAGGED_T = [1, 5, 11, 255, 256, 257, 1003, 1600]
K1_SHAPES = ([(b, c, t) for c, t in STAGE_SHAPES for b in (1, 4)] + [(2, 7, t) for t in RAGGED_T]
             + [(2, 130, 517)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,t", K1_SHAPES)
def test_k1_matches_plain(dtype, b, c, t):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, c, t, device="cuda", generator=g).to(dtype)
    alpha = 0.3 * torch.randn(c, device="cuda", generator=g)
    beta = 0.3 * torch.randn(c, device="cuda", generator=g)
    before = k1.launches
    out = k1.fused_anti_alias_snake(x, alpha, beta, alpha_logscale=True)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = k1.anti_alias_snake_plain(x, alpha, beta, True).float()
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    # f32: summation order only; bf16: the final rounding of either side
    bound = 1e-5 * scale if dtype == torch.float32 else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert err <= bound, (err, bound)


@pytest.mark.cuda
def test_k1_raises_instead_of_falling_back():
    """On a CUDA tensor the wrapper launches or raises; it never takes the plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    alpha = torch.zeros(8, device="cuda")
    with pytest.raises(TypeError):
        k1.fused_anti_alias_snake(torch.zeros(1, 8, 64, device="cuda", dtype=torch.float16), alpha, alpha)
    with pytest.raises(ValueError):
        k1.fused_anti_alias_snake(torch.zeros(1, 64, 8, device="cuda").transpose(1, 2), alpha, alpha)


def _k2_inputs(b, c, t, k, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (0.5 * torch.randn(b, c, t, device="cuda", generator=g)).to(dtype)
    alpha = 0.3 * torch.randn(c, device="cuda", generator=g)
    beta = 0.3 * torch.randn(c, device="cuda", generator=g)
    w = (torch.randn(c, c, k, device="cuda", generator=g) / (c * k) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(c, device="cuda", generator=g)).to(dtype)
    return x, alpha, beta, w, bias


def _assert_within(out, ref, bound):
    err = (out.float() - ref.float()).abs()
    worst = int((err / bound).argmax())
    assert bool((err <= bound).all()), (f"max err {err.max().item():.3e}; worst err/bound at flat index {worst}: "
                                        f"err {err.flatten()[worst].item():.3e} bound {bound.flatten()[worst].item():.3e} "
                                        f"out {out.flatten()[worst].item():.6f} ref {ref.flatten()[worst].item():.6f}")


K2_KD = [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,t", [(128, 517), (192, 640), (384, 800), (768, 400)])
@pytest.mark.parametrize("k,d", K2_KD)
def test_k2_matches_plain(dtype, c, t, k, d):
    """Every (k, d) of the vocoder at the wide stages' widths; the T's are
    ragged (not multiples of the 128-frame tile) apart from 640."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, alpha, beta, w, bias = _k2_inputs(1, c, t, k, dtype, seed=k * 10 + d)
    before = k2.launches
    out = k2.fused_aa_snake_dconv(x, alpha, beta, w, bias, d, alpha_logscale=True)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    ref = k2.aa_snake_dconv_plain(x, alpha, beta, w, bias, d, alpha_logscale=True)
    _assert_within(out, ref, k2.aa_snake_dconv_bound(x, alpha, beta, w, d, ref, alpha_logscale=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,k,d", [(2, 9, 11, 5), (1, 1, 3, 1), (3, 30, 7, 3)])
def test_k2_short_t_and_batch(dtype, b, t, k, d):
    """T shorter than the conv's halo (h = 25 at k = 11, d = 5) and than K1's
    stencil, and B > 1: the conv's zero padding and the replicate clamps of
    the activation at both ends in one tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    x, alpha, beta, w, bias = _k2_inputs(b, 128, t, k, dtype, seed=t)
    out = k2.fused_aa_snake_dconv(x, alpha, beta, w, bias, d, alpha_logscale=True)
    ref = k2.aa_snake_dconv_plain(x, alpha, beta, w, bias, d, alpha_logscale=True)
    _assert_within(out, ref, k2.aa_snake_dconv_bound(x, alpha, beta, w, d, ref, alpha_logscale=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,t,k,d", [(768, 400, 7, 3), (384, 800, 3, 1), (192, 1600, 11, 5), (130, 517, 7, 1)])
def test_k2_batch_of_four(dtype, c, t, k, d):
    """B = 4 at the wide stages' widths (64- and 128-frame tiles, blocks in
    pairs and alone), and at C = 130: zero rows of the packed weight and of
    the activation, T of no 16-byte vector."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, alpha, beta, w, bias = _k2_inputs(4, c, t, k, dtype, seed=c + k)
    out = k2.fused_aa_snake_dconv(x, alpha, beta, w, bias, d, alpha_logscale=True)
    ref = k2.aa_snake_dconv_plain(x, alpha, beta, w, bias, d, alpha_logscale=True)
    _assert_within(out, ref, k2.aa_snake_dconv_bound(x, alpha, beta, w, d, ref, alpha_logscale=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_repacks_a_changed_weight(dtype):
    """The packed weight is cached per weight tensor: after an in-place
    update, and after the tensor is replaced, the kernel must see the new
    values (a stale cache is a wrong result)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    x, alpha, beta, w, bias = _k2_inputs(1, 192, 300, 7, dtype, seed=9)

    def check(weight):
        out = k2.fused_aa_snake_dconv(x, alpha, beta, weight, bias, 3, alpha_logscale=True)
        ref = k2.aa_snake_dconv_plain(x, alpha, beta, weight, bias, 3, alpha_logscale=True)
        _assert_within(out, ref, k2.aa_snake_dconv_bound(x, alpha, beta, weight, 3, ref, alpha_logscale=True))
        return out

    first = check(w)
    assert k2.packed_weight(w) is k2.packed_weight(w)
    w.copy_(torch.flip(w, dims=(0,)))
    second = check(w)
    assert not torch.equal(first, second)
    check(_k2_inputs(1, 192, 300, 7, dtype, seed=10)[3])


@pytest.mark.cuda
def test_k2_raises_instead_of_falling_back():
    """On a CUDA tensor the wrapper launches or raises; it never takes the plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    x, alpha, beta, w, bias = _k2_inputs(1, 128, 64, 3, torch.bfloat16)
    before = k2.launches
    with pytest.raises(TypeError):
        k2.fused_aa_snake_dconv(x.half(), alpha, beta, w.half(), bias.half(), 1)
    with pytest.raises(TypeError):
        k2.fused_aa_snake_dconv(x, alpha, beta, w.float(), bias, 1)  # weight not in x's dtype
    with pytest.raises(ValueError):
        k2.fused_aa_snake_dconv(x, alpha, beta, w[:, :, :2].contiguous(), bias, 1)  # even k
    with pytest.raises(ValueError):
        k2.fused_aa_snake_dconv(x.transpose(1, 2).contiguous().transpose(1, 2), alpha, beta, w, bias, 1)
    assert k2.launches == before


def _k5_inputs(m, k, n, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
    wq = torch.randint(-127, 128, (n, k), device="cuda", generator=g, dtype=torch.int32).to(torch.int8)
    scale = torch.rand(n, device="cuda", generator=g) * 1e-3 + 1e-4
    bias = (0.1 * torch.randn(n, device="cuda", generator=g)).to(dtype)
    return x, wq, scale, bias


def k5_bound(x, wq, scale, ref):
    """Both sides sum exact bf16 x int8 products in float32: the bound is the
    summation order, 1e-5 of (|bf16(x)| @ |wq|) * scale. A bf16 output is
    rounded twice, before and after the bias add (as the JAX kernel does), so
    either side may round the other way each time: one bf16 ulp of the
    pre-bias value and two of the output on top."""
    xb, w = x.to(torch.bfloat16).float(), wq.float()
    bound = 1e-5 * (xb.abs() @ w.abs().t()) * scale
    if ref.dtype == torch.bfloat16:
        ulp = lambda v: torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)
        bound = bound + ulp((xb @ w.t()) * scale) + 2 * ulp(ref.float())
    return bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 3, 4, 8, 15, 16])
@pytest.mark.parametrize("k,n", K5_SHAPES + [(300, 700)])
def test_k5_matches_plain(dtype, m, k, n):
    """The decode batches of the engine's paths: greedy (1), three beams (3),
    slots (4), 8, five rows x three beams (15) and a full pair of x tiles
    (16); (300, 700) has K of no whole step and not a multiple of 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, wq, scale, bias = _k5_inputs(m, k, n, dtype)
    before = k5.launches
    out = k5.int8_matmul(x, wq, scale, bias)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    ref = k5.int8_matmul_plain(x, wq, scale, bias)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= k5_bound(x, wq, scale, ref)).all()), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [13, 37])
@pytest.mark.parametrize("k,n", [(1280, 1280), (300, 700)])
def test_k5_more_rows_than_a_block(dtype, k, n, m):
    """M = 13: the second 8-row tile of x, partly filled. M = 37: a block
    takes 16 rows, so three blocks along the grid's z axis, the last partly
    filled."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, wq, scale, bias = _k5_inputs(m, k, n, dtype, seed=1)
    out = k5.int8_matmul(x, wq, scale, bias)
    ref = k5.int8_matmul_plain(x, wq, scale, bias)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= k5_bound(x, wq, scale, ref)).all()), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4, 1280, 1280), (16, 5120, 1280), (3, 1280, 8194)])
def test_k5_two_runs_are_bit_equal(dtype, m, k, n):
    """Split-K sums its partial tiles in a fixed order (no atomics): the same
    input gives the same bits, launch after launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    x, wq, scale, bias = _k5_inputs(m, k, n, dtype, seed=2)
    first = k5.int8_matmul(x, wq, scale, bias)
    for _ in range(5):
        assert torch.equal(k5.int8_matmul(x, wq, scale, bias), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [3, 16])
@pytest.mark.parametrize("k,n,offset", [(1288, 1280, 0), (50, 70, 0), (1280, 1280, 1), (1280, 70, 3)])
def test_k5_odd_k_and_unaligned_weight(dtype, m, k, n, offset):
    """K not a multiple of 16 (rows that no 16-byte load can take), and a
    contiguous weight view whose pointer is not 16-byte aligned: both take the
    byte loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, wq, scale, bias = _k5_inputs(m, k, n, dtype, seed=3)
    flat = torch.zeros(n * k + offset, dtype=torch.int8, device="cuda")
    flat[offset:] = wq.reshape(-1)
    view = flat[offset:].view(n, k)
    assert view.is_contiguous() and (offset == 0 or view.data_ptr() % 16 != 0)
    out = k5.int8_matmul(x, view, scale, bias)
    ref = k5.int8_matmul_plain(x, view, scale, bias)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= k5_bound(x, view, scale, ref)).all()), err.max().item()


@pytest.mark.cuda
def test_k5_raises_instead_of_falling_back():
    """On a CUDA tensor the wrapper launches or raises; it never takes the plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    x, wq, scale, bias = _k5_inputs(2, 64, 32, torch.bfloat16)
    before = k5.launches
    with pytest.raises(TypeError):
        k5.int8_matmul(x, wq.to(torch.bfloat16), scale, bias)  # not an int8 weight
    with pytest.raises(ValueError):
        k5.int8_matmul(x[None], wq, scale, bias)  # 3-D x
    with pytest.raises(TypeError):
        k5.int8_matmul(x.half(), wq, scale, bias)
    with pytest.raises(ValueError):
        k5.int8_matmul(torch.zeros(64, 2, device="cuda", dtype=torch.bfloat16).t(), wq, scale, bias)
    assert k5.launches == before


# K3 at the three wide stages of a ~100-code vocoder call (B = 1 and 4), and at
# odd shapes: C of no row tile with T of no tile; T of no 16-byte vector; T
# shorter than the stencil; ragged T on C = 7 and 9 (a row tile of 16 mostly
# past the last row): one frame, odd, one n-block, of no 32-frame step; T = 4
# mod 8, where a tensor-core up n-block ends at sample T - 1 exactly
K3_SHAPES = ([(1, 768, 1600), (4, 768, 1600), (1, 384, 6400), (4, 384, 6400), (1, 192, 12800), (4, 192, 12800),
              (1, 130, 1000), (2, 130, 1003), (2, 130, 1004), (1, 8, 5)] + [(2, 7, t) for t in RAGGED_T]
             + [(2, 9, t) for t in (7, 8, 241, 4, 12, 244, 1004)])
# the three bodies as the wrapper's keywords
K3_BODIES = {"taps": {}, "mma": {"mxu": True}, "ident": {"probe": "ident"}}


def _k3_inputs(b, c, t, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, c, t, device="cuda", generator=g).to(dtype)
    return x, 0.3 * torch.randn(c, device="cuda", generator=g), 0.3 * torch.randn(c, device="cuda", generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("b,c,t", K3_SHAPES)
def test_k3_bodies_match_plain(b, c, t, mxu, dtype):
    """The CUDA-core and the tensor-core body within
    anti_alias_snake_tmajor_bound of their plain versions; float32 also within
    2e-5 of the composed path with the exact sin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from indextts_tpu_torch.ops.antialias import activation1d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, alpha, beta = _k3_inputs(b, c, t, dtype)
    before = k3.launches
    out = k3.fused_anti_alias_snake_tmajor(x, alpha, beta, True, mxu=mxu)
    torch.cuda.synchronize()
    assert k3.launches == before + 1 and out.shape == x.shape and out.dtype == dtype
    ref = k3.anti_alias_snake_tmajor_plain(x, alpha, beta, True, mxu=mxu)
    err = (out.float() - ref.float()).abs()
    ratio = (err / k3.anti_alias_snake_tmajor_bound(x, alpha, beta, ref, True, mxu=mxu)).max().item()
    assert ratio <= 1.0, (ratio, err.max().item())
    if dtype == torch.float32:
        composed = activation1d(x, alpha, beta, True, approx_sin_=False)
        assert (out - composed).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,t", K3_SHAPES)
def test_k3_ident_is_bit_equal(b, c, t, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    x, alpha, beta = _k3_inputs(b, c, t, dtype)
    before = k3.launches
    out = k3.fused_anti_alias_snake_tmajor(x, alpha, beta, True, probe="ident")
    torch.cuda.synchronize()
    assert k3.launches == before + 1 and torch.equal(out, x)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", [False, True])
def test_k3_poly_sin_and_snake_without_beta(mxu):
    """poly_sin forced on float32 input (within the polynomial's error of the
    exact sin, and equal to its own plain version), and Snake with beta=None
    on a contiguous view whose data pointer is not 16-byte aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    x, alpha, _ = _k3_inputs(2, 192, 777, torch.float32, seed=3)
    alpha = alpha.abs() + 0.1
    exact = k3.fused_anti_alias_snake_tmajor(x, alpha, None, False, mxu=mxu)
    poly = k3.fused_anti_alias_snake_tmajor(x, alpha, None, False, mxu=mxu, poly_sin=True)
    ref = k3.anti_alias_snake_tmajor_plain(x, alpha, None, False, mxu=mxu, poly_sin=True)
    torch.cuda.synchronize()
    assert (poly - ref).abs().max().item() <= 2e-5
    assert 1e-7 < (poly - exact).abs().max().item() <= 5e-4
    # a slice whose data pointer is not 16-byte aligned takes the element-wise path
    xb = torch.randn(16 * 256 + 1, device="cuda").to(torch.bfloat16)[1:].view(1, 16, 256)
    assert xb.is_contiguous() and xb.data_ptr() % 16 != 0
    a16 = alpha[:16].contiguous()
    out = k3.fused_anti_alias_snake_tmajor(xb, a16, None, False, mxu=mxu)
    refb = k3.anti_alias_snake_tmajor_plain(xb, a16, None, False, mxu=mxu)
    ratio = ((out.float() - refb.float()).abs() / k3.anti_alias_snake_tmajor_bound(xb, a16, None, refb, False, mxu=mxu))
    assert ratio.max().item() <= 1.0
    assert torch.equal(k3.fused_anti_alias_snake_tmajor(xb, a16, None, False, probe="ident"), xb)


@pytest.mark.cuda
def test_k3_raises_instead_of_falling_back():
    """On a CUDA tensor the wrapper launches or raises; it never takes the plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    alpha = torch.zeros(8, device="cuda")
    before = k3.launches
    with pytest.raises(TypeError):
        k3.fused_anti_alias_snake_tmajor(torch.zeros(1, 8, 64, device="cuda", dtype=torch.float16), alpha, alpha)
    with pytest.raises(ValueError):
        k3.fused_anti_alias_snake_tmajor(torch.zeros(1, 64, 8, device="cuda").transpose(1, 2), alpha, alpha)
    with pytest.raises(ValueError):
        k3.fused_anti_alias_snake_tmajor(torch.zeros(8, 64, device="cuda"), alpha, alpha)
    with pytest.raises(ValueError):
        k3.fused_anti_alias_snake_tmajor(torch.zeros(1, 8, 64, device="cuda"), alpha[:4], alpha)
    with pytest.raises(ValueError):
        k3.fused_anti_alias_snake_tmajor(torch.zeros(1, 8, 64, device="cuda"), alpha.cpu(), alpha)
    with pytest.raises(ValueError, match="probe"):
        k3.fused_anti_alias_snake_tmajor(torch.zeros(1, 8, 64, device="cuda"), alpha, alpha, probe="wrapper")
    assert k3.launches == before


def _k3_check(body, x, alpha, beta, logscale=True):
    """out, and whether it is within the body's tolerance of its plain version
    (the pass-through: equal to x)."""
    out = k3.fused_anti_alias_snake_tmajor(x, alpha, beta, logscale, **K3_BODIES[body])
    if body == "ident":
        return out, torch.equal(out, x)
    mxu = body == "mma"
    ref = k3.anti_alias_snake_tmajor_plain(x, alpha, beta, logscale, mxu=mxu)
    ratio = (out.float() - ref.float()).abs() / k3.anti_alias_snake_tmajor_bound(x, alpha, beta, ref, logscale, mxu=mxu)
    return out, ratio.max().item() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body", list(K3_BODIES))
@pytest.mark.parametrize("t", [241, 244, 1003, 1600])
def test_k3_unaligned_input(t, body, dtype):
    """A contiguous input whose data pointer is one element past a 16-byte
    boundary: every body takes its element-wise loads and stores, within
    tolerance (the pass-through bit-equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    c = 130
    flat = torch.randn(2 * c * t + 1, device="cuda", generator=torch.Generator(device="cuda").manual_seed(t))
    x = flat.to(dtype)[1:].view(2, c, t)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _, alpha, beta = _k3_inputs(1, c, 8, torch.float32, seed=t)
    _, ok = _k3_check(body, x, alpha, beta)
    assert ok


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body", list(K3_BODIES))
@pytest.mark.parametrize("b,c,t", [(1, 768, 1600), (4, 384, 6400), (1, 192, 12800), (2, 9, 1003), (2, 9, 1004)])
def test_k3_two_runs_are_bit_equal(b, c, t, body, dtype):
    """No atomics and no order that changes between runs: the same input
    gives the same bits, from every body."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    x, alpha, beta = _k3_inputs(b, c, t, dtype, seed=c)
    first, ok = _k3_check(body, x, alpha, beta)
    second, _ = _k3_check(body, x, alpha, beta)
    torch.cuda.synchronize()
    assert ok and torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body", list(K3_BODIES))
def test_k3_call_launches_one_kernel(body, dtype):
    """Each body's call is one launch of its own kernel and nothing else (the
    tensor-core body on float32 input is the CUDA-core body's kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    name = {"taps": "tmajor_taps_kernel", "ident": "tmajor_ident_kernel",
            "mma": "tmajor_mma_kernel" if dtype == torch.bfloat16 else "tmajor_taps_kernel"}[body]
    x, alpha, beta = _k3_inputs(1, 384, 6400, dtype, seed=2)
    events = _profiled_kernels(k3, lambda: k3.fused_anti_alias_snake_tmajor(x, alpha, beta, True, **K3_BODIES[body]))
    assert sum(e.count for e in events) == 1 and name in events[0].key, [(e.key, e.count) for e in events]


# K4 at the three narrow stages of a ~100-code vocoder call (B = 1 and 4), and at
# odd shapes: C of no tile with T of no 256-frame chunk; T of no 16-byte vector
# (1003: neither dtype; 1004: float32 only); T shorter than the stencil; T = 1
K4_SHAPES = ([(1, 96, 25600), (4, 96, 25600), (1, 48, 51200), (4, 48, 51200), (1, 24, 102400), (4, 24, 102400),
              (1, 25, 1000), (2, 25, 1003), (1, 25, 1004), (1, 8, 5), (1, 3, 1)]
             + [(b, c, t) for c, t in STAGE_SHAPES[:3] for b in (1, 4)] + [(2, 7, t) for t in RAGGED_T])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,t", K4_SHAPES)
def test_k4_matches_plain(b, c, t, dtype):
    """Within fused_folded_aa_bound of the plain version; float32 also within
    2e-5 of the composed path with the exact sin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from indextts_tpu_torch.ops.antialias import activation1d

    x, alpha, beta = _k3_inputs(b, c, t, dtype, seed=4)
    before = k4.launches
    out = k4.fused_folded_aa(x, alpha, beta, True)
    torch.cuda.synchronize()
    assert k4.launches == before + 1 and out.shape == x.shape and out.dtype == dtype
    ref = k4.fused_folded_aa_plain(x, alpha, beta, True)
    err = (out.float() - ref.float()).abs()
    ratio = (err / k4.fused_folded_aa_bound(x, alpha, beta, ref, True)).max().item()
    assert ratio <= 1.0, (ratio, err.max().item())
    if dtype == torch.float32:
        composed = activation1d(x, alpha, beta, True, approx_sin_=False)
        assert (out - composed).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_k4_poly_sin_snake_without_beta_and_unaligned_pointer():
    """poly_sin forced on float32 input (equal to its own plain version, and
    within the polynomial's error of the exact sin), Snake with beta=None, and
    a contiguous view whose data pointer is not 16-byte aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    x, alpha, _ = _k3_inputs(2, 96, 777, torch.float32, seed=5)
    alpha = alpha.abs() + 0.1
    exact = k4.fused_folded_aa(x, alpha, None, False)
    poly = k4.fused_folded_aa(x, alpha, None, False, poly_sin=True)
    ref = k4.fused_folded_aa_plain(x, alpha, None, False, poly_sin=True)
    torch.cuda.synchronize()
    assert (poly - ref).abs().max().item() <= 2e-5
    assert 1e-7 < (poly - exact).abs().max().item() <= 5e-4
    xb = torch.randn(16 * 512 + 1, device="cuda").to(torch.bfloat16)[1:].view(1, 16, 512)
    assert xb.is_contiguous() and xb.data_ptr() % 16 != 0
    a16 = alpha[:16].contiguous()
    out = k4.fused_folded_aa(xb, a16, None, False)
    refb = k4.fused_folded_aa_plain(xb, a16, None, False)
    ratio = (out.float() - refb.float()).abs() / k4.fused_folded_aa_bound(xb, a16, None, refb, False)
    assert ratio.max().item() <= 1.0


@pytest.mark.cuda
def test_k4_raises_instead_of_falling_back():
    """On a CUDA tensor the wrapper launches or raises; it never takes the plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    alpha = torch.zeros(8, device="cuda")
    before = k4.launches
    with pytest.raises(TypeError):
        k4.fused_folded_aa(torch.zeros(1, 8, 64, device="cuda", dtype=torch.float16), alpha, alpha)
    with pytest.raises(ValueError):
        k4.fused_folded_aa(torch.zeros(1, 64, 8, device="cuda").transpose(1, 2), alpha, alpha)
    with pytest.raises(ValueError):
        k4.fused_folded_aa(torch.zeros(8, 64, device="cuda"), alpha, alpha)
    with pytest.raises(ValueError):
        k4.fused_folded_aa(torch.zeros(1, 8, 0, device="cuda"), alpha, alpha)
    with pytest.raises(ValueError):
        k4.fused_folded_aa(torch.zeros(1, 8, 64, device="cuda"), alpha[:4], alpha)
    with pytest.raises(ValueError):
        k4.fused_folded_aa(torch.zeros(1, 8, 64, device="cuda"), alpha.cpu(), alpha)
    assert k4.launches == before


def _k1_k4_check(kernel, x, alpha, beta, logscale=True):
    """out, and whether it is within the kernel's tolerance of its plain version."""
    if kernel == "k1":
        out = k1.fused_anti_alias_snake(x, alpha, beta, logscale)
        ref = k1.anti_alias_snake_plain(x, alpha, beta, logscale).float()
        scale = ref.abs().max().item()
        bound = 1e-5 * scale if x.dtype == torch.float32 else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)
        return out, (out.float() - ref).abs().max().item() <= bound
    out = k4.fused_folded_aa(x, alpha, beta, logscale)
    ref = k4.fused_folded_aa_plain(x, alpha, beta, logscale)
    ratio = (out.float() - ref.float()).abs() / k4.fused_folded_aa_bound(x, alpha, beta, ref, logscale)
    return out, ratio.max().item() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["k1", "k4"])
@pytest.mark.parametrize("t", [1003, 1600])
def test_k1_k4_unaligned_input(t, kernel, dtype):
    """A contiguous input whose data pointer is one element past a 16-byte
    boundary (a flat buffer sliced at an offset of one): the element-wise
    loads and stores, within tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    c = 24
    flat = torch.randn(2 * c * t + 1, device="cuda", generator=torch.Generator(device="cuda").manual_seed(t))
    x = flat.to(dtype)[1:].view(2, c, t)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _, alpha, beta = _k3_inputs(1, c, 8, torch.float32, seed=t)
    _, ok = _k1_k4_check(kernel, x, alpha, beta)
    assert ok


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["k1", "k4"])
@pytest.mark.parametrize("b,c,t", [(1, 768, 1600), (4, 96, 25600), (1, 24, 102400), (2, 7, 1003)])
def test_k1_k4_two_runs_are_bit_equal(b, c, t, kernel, dtype):
    """No atomics and no order that changes between runs: the same input
    gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    x, alpha, beta = _k3_inputs(b, c, t, dtype, seed=c)
    first, ok = _k1_k4_check(kernel, x, alpha, beta)
    second, _ = _k1_k4_check(kernel, x, alpha, beta)
    torch.cuda.synchronize()
    assert ok and torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["k1", "k3", "k4"])
def test_activation_call_launches_one_kernel(kernel, dtype):
    """On log-scale parameters the wrapper's call is one launch of its own
    kernel and nothing else (the exp of alpha and beta is made once per
    parameter): one more on its counter, one kernel under the profiler."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    mod, fn, name = {"k1": (k1, k1.fused_anti_alias_snake, "anti_alias_snake_kernel"),
                     "k3": (k3, k3.fused_anti_alias_snake_tmajor, "tmajor_taps_kernel"),
                     "k4": (k4, k4.fused_folded_aa, "folded_aa_kernel")}[kernel]
    x, alpha, beta = _k3_inputs(1, 192, 6400, dtype, seed=1)
    events = _profiled_kernels(mod, lambda: fn(x, alpha, beta, True))
    assert sum(e.count for e in events) == 1 and name in events[0].key, [(e.key, e.count) for e in events]


def _profiled_kernels(mod, call):
    """The device events of one `call` under torch.profiler, after a first call
    that derives the wrapper's parameters; the call adds one to mod.launches.
    A trace now and then comes back without device records (several in a row
    in a long test run): it is taken again, up to 8 times."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(8):
        before = mod.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        assert mod.launches == before + 1
        events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
        if events:
            return events
    return []


@pytest.mark.cuda
def test_block_graph_runs_only_the_steps_its_predicate_allows():
    """A decode block of graphs.BLOCK conditional steps (csrc/graph_block.cu)
    on a toy counter loop whose condition is t < 10: budgets 3, 16 and 16
    run 3 steps (warm, then captured), 7 (stopped mid-block on the card) and
    0 (replays), the same steps and state as the blocks run eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the block graph has no CPU mode)")
    import contextlib

    from indextts_tpu_torch.graphs import BLOCK, Graphs

    class Toy:
        def __init__(self):
            self.t = torch.zeros(1, dtype=torch.long, device="cuda")
            self.x = torch.zeros(4, device="cuda")
            self.u = torch.arange(4 * BLOCK, dtype=torch.float32, device="cuda").reshape(BLOCK, 4)

    out = {}
    for mode in ("eager", "graph"):
        graphs, st = Graphs("cuda"), Toy()
        lane = graphs.decode.bind(("toy",), st, [(st, ("t", "x", "u"))])

        def step():
            st.x.add_(st.u.index_select(0, lane.ctl.ran)[0])
            st.t.add_(1)

        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            runs = [graphs.decode.run(lane, step, lambda: st.t < 10, n) for n in (3, 16, 16)]
        out[mode] = (runs, st.t.item(), st.x.cpu(), lane)
    assert out["eager"][0] == out["graph"][0] == [(3, True), (7, False), (0, False)]
    assert out["graph"][1] == out["eager"][1] == 10 and torch.equal(out["graph"][2], out["eager"][2])
    assert out["graph"][3].graph is not None and out["graph"][3].replays == 2


def _event_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The event record and event wait nodes of a captured graph
    (torch.cuda.CUDAGraph(keep_graph=True)), through the driver API."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(g, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(0)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return sum(k in (6, 7) for k in kinds)  # CU_GRAPH_NODE_TYPE_WAIT_EVENT, CU_GRAPH_NODE_TYPE_EVENT_RECORD


@pytest.mark.cuda
def test_block_graph_drops_a_steps_event_nodes():
    """A step that records an external event and waits on it, as PyTorch's
    ProcessGroupNCCL does around each collective it captures: the captured
    step holds event nodes, which a conditional body refuses, so the
    block's bodies are copies of it without them (csrc/graph_block.cu).
    Budgets 3, 16 and 16 run 3, 7 and 0 steps to the same state as the
    blocks run eagerly, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the block graph has no CPU mode)")
    import contextlib

    from indextts_tpu_torch.graphs import BLOCK, Graphs

    class Toy:
        def __init__(self):
            self.t = torch.zeros(1, dtype=torch.long, device="cuda")
            self.x = torch.zeros(4, device="cuda")
            self.u = torch.rand(BLOCK, 4, device="cuda", generator=torch.Generator("cuda").manual_seed(0))

    out = {}
    for mode in ("eager", "graph"):
        graphs, st, ev = Graphs("cuda"), Toy(), torch.cuda.Event(external=True)
        lane = graphs.decode.bind(("toy",), st, [(st, ("t", "x", "u"))])

        def step():
            st.x.add_(st.u.index_select(0, lane.ctl.ran)[0])
            ev.record()
            ev.wait()
            st.x.mul_(0.75)
            st.t.add_(1)

        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            runs = [graphs.decode.run(lane, step, lambda: st.t < 10, n) for n in (3, 16, 16)]
        out[mode] = (runs, st.t.item(), st.x.cpu(), lane)
    assert out["eager"][0] == out["graph"][0] == [(3, True), (7, False), (0, False)]
    assert out["graph"][1] == out["eager"][1] == 10 and torch.equal(out["graph"][2], out["eager"][2])
    block = out["graph"][3].graph
    assert out["graph"][3].replays == 2 and _event_nodes(block.step) >= 2


@pytest.mark.cuda
def test_capture_rule_on_the_card():
    """graphs.stage_captures on real stages on the card: one card and an
    NCCL mesh capture every stage; ranks that share a card over gloo
    capture the vocoder and conditioning stages only, so a vocoder call is
    captured and replayed there while a decode loop runs its blocks
    without capture; Graphs.eager() turns every stage off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (capture has no CPU mode)")
    from indextts_tpu_torch.graphs import Graphs

    every = {"dec", "slot", "voc", "lat", "cond"}
    for backend, want in ((None, every), ("nccl", every), ("gloo", {"voc", "cond"})):
        g = Graphs("cuda", backend=backend)
        assert {s.name for s in g.stages() if s.capturing} == want
        with g.eager():
            assert not any(s.capturing for s in g.stages())

    g = Graphs("cuda", backend="gloo")
    x = torch.randn(4, 8, device="cuda")
    fn = lambda t: (t * 2).sum(1)
    first, again = (g.vocoder.call(("toy",), fn, (x,)) for _ in range(2))
    voc = g.vocoder.lanes[(("toy",), 0)]
    assert voc.graph is not None and voc.replays == 1 and torch.equal(first, again)

    class Toy:
        def __init__(self):
            self.t = torch.zeros(1, dtype=torch.long, device="cuda")

    st = Toy()
    lane = g.decode.bind(("toy",), st, [(st, ("t",))])
    runs = [g.decode.run(lane, lambda: st.t.add_(1), lambda: st.t < 10, 16) for _ in range(2)]
    assert runs == [(10, False), (0, False)] and lane.graph is None
    events = {(stage, event) for stage, event, *_ in g.log}
    assert {("voc", "warm"), ("voc", "capture"), ("voc", "replay"), ("dec", "bind"), ("dec", "run")} <= events


# K6 (ops/cuda/decode_attn.py): the decode step's attention over one layer's
# KV cache, at the main path's shapes: (cache, B, H, S) of the batch and beam
# loops (bf16) and the slot loop (int8, 32 slots), at the model's 20 heads and
# a tensor-parallel shard's 10; Dh = 64. S = 351 leaves a ragged last block
# of the cluster's split.
K6_SHAPES = ([("bf16", b, h, 320) for b in (1, 3, 8) for h in (20, 10)] + [("bf16", 3, 20, 351)]
             + [("int8", 32, h, 320) for h in (20, 10)])


@pytest.fixture
def card():
    """The CUDA device, with float32 products in full float32; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k6_inputs(kind, b, h, s_len, dtype=torch.bfloat16, dh=64, pos=200, seed=0):
    """q, k, v as the qkv projection's thirds (views of one [B, 3 H Dh]
    tensor), the cache, the bias and pos. Rows attend different spans: a
    left pad of 7 b columns, the columns up to pos, and on the slot cache
    (int8) also columns past pos, as a circular cache's rows do; column pos
    is masked in every row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn(b, 3 * h * dh, device="cuda", generator=g).to(dtype)
    q, k, v = (t.reshape(b, h, dh) for t in y.split(h * dh, dim=-1))
    kv = [torch.randn(b, h, s_len, dh, device="cuda", generator=g).to(dtype) for _ in range(2)]
    cols = torch.arange(s_len, device="cuda")[None, :]
    valid = (cols >= 7 * torch.arange(b, device="cuda")[:, None] % pos) & (cols < pos)
    if kind == "int8":
        (k8, ks), (v8, vs) = k6.quant_cols(kv[0]), k6.quant_cols(kv[1])
        cache = (k8, ks, v8, vs)
        valid |= (cols > pos) & (torch.rand(b, s_len, device="cuda", generator=g) < 0.7)
    else:
        cache = tuple(kv)
    valid &= cols != pos
    bias = torch.where(valid, torch.zeros((), device="cuda"), torch.finfo(torch.float32).min)[:, None, :]
    return q, k, v, cache, torch.tensor([pos], device="cuda"), bias


def _k6_run(q, k, v, cache, pos, bias):
    """K6 on a copy of the cache: (out, the cache after the write)."""
    mine = tuple(c.clone() for c in cache)
    out = k6.decode_attn(q, k, v, mine, pos, bias)
    torch.cuda.synchronize()
    return out, mine


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,h,s_len", K6_SHAPES)
def test_k6_is_no_farther_from_float64_than_the_plain_path(card, kind, b, h, s_len):
    """Against the formula in float64, K6's largest error is at most the
    plain path's on the card (which rounds the scores and the weighted sums
    to bf16 between its products; K6 rounds once, at the output), and each
    output is within one bf16 ulp of the float64 value, plus 1e-5 for
    float32's sums: half an ulp for the one rounding, the rest for the sums
    and exponentials in float32. One launch, and two runs give the same bits
    (no atomics; the cluster merges in rank order)."""
    q, k, v, cache, pos, bias = _k6_inputs(kind, b, h, s_len)
    ref = k6.decode_attn_f64(q, k, v, cache, bias)
    before = k6.launches
    out, _ = _k6_run(q, k, v, cache, pos, bias)
    again, _ = _k6_run(q, k, v, cache, pos, bias)
    assert k6.launches == before + 2 and out.shape == (b, h * 64) and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    plain = k6.decode_attn_plain(q, k, v, tuple(c.clone() for c in cache), pos, bias)
    err = (out.double() - ref).abs()
    err_plain = (plain.double() - ref).abs().max().item()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp(min=2.0 ** -126))) - 7)
    assert (err <= ulp + 1e-5).all(), (err.max().item(), (err / (ulp + 1e-5)).max().item())
    assert err.max().item() <= err_plain, (err.max().item(), err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
@pytest.mark.parametrize("kind,b,h,s_len", [("int8", 32, 20, 320), ("int8", 3, 10, 351), ("bf16", 8, 20, 320)])
def test_k6_writes_column_pos_as_the_plain_path(card, kind, b, h, s_len, pos_kind):
    """Column pos after the launch: the int8 bytes and scales of _quant_cols
    on the card, exactly; bf16 K / V as they are. Every other column keeps
    its bytes."""
    q, k, v, cache, pos, bias = _k6_inputs(kind, b, h, s_len, seed=1)
    _, mine = _k6_run(q, k, v, cache, 200 if pos_kind == "int" else pos, bias)
    rest = [j for j in range(s_len) if j != 200]
    if kind == "int8":
        from indextts_tpu_torch.models.gpt_decode import _quant_cols

        for new, c8, cs in ((k, mine[0], mine[1]), (v, mine[2], mine[3])):
            q8, qs = _quant_cols(new[:, :, None])
            assert torch.equal(c8[:, :, 200], q8[:, :, 0]) and torch.equal(cs[:, :, 200], qs[:, :, 0])
    else:
        assert torch.equal(mine[0][:, :, 200], k) and torch.equal(mine[1][:, :, 200], v)
    for c, was in zip(mine, cache):
        assert torch.equal(c[..., rest, :] if c.dim() == 4 else c[..., rest], was[..., rest, :] if was.dim() == 4
                           else was[..., rest])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,h,s_len", [("int8", 32, 20, 320), ("bf16", 3, 20, 351), ("bf16", 8, 10, 320)])
def test_k6_never_reads_column_pos_or_masked_columns(card, kind, b, h, s_len):
    """NaN, inf and the extreme int8 bytes in column pos and in every masked
    column (and NaN in their scales) give the same bits as zeros there."""
    q, k, v, cache, pos, bias = _k6_inputs(kind, b, h, s_len, seed=2)
    masked = (bias[:, 0] <= torch.finfo(torch.float32).min)  # [B, S], column pos included
    assert masked[:, 200].all()

    def filled(how):
        out = []
        for c in cache:
            c = c.clone()
            sel = masked[:, None, :].expand(c.shape[:3]) if c.dim() == 4 else masked[:, None, :].expand(c.shape)
            if c.dtype == torch.int8:
                c[sel] = 0 if how == "zero" else -128
            elif c.dim() == 4:
                c[sel] = 0 if how == "zero" else float("nan")
                if how != "zero":
                    c[:, :, 200, ::2] = float("inf")
            else:
                c[sel] = 0 if how == "zero" else float("nan")
            out.append(c)
        return tuple(out)

    zero, _ = _k6_run(q, k, v, filled("zero"), pos, bias)
    junk, _ = _k6_run(q, k, v, filled("junk"), pos, bias)
    assert torch.isfinite(junk.float()).all() and torch.equal(zero, junk)


@pytest.mark.cuda
def test_k6_raises_instead_of_falling_back(card):
    """On a CUDA tensor the wrapper launches or raises; it never takes the plain path."""
    q, k, v, cache, pos, bias = _k6_inputs("bf16", 2, 4, 64, pos=40)
    before = k6.launches
    with pytest.raises(TypeError):
        k6.decode_attn(q.half(), k.half(), v.half(), cache, pos, bias)
    with pytest.raises(ValueError):
        k6.decode_attn(q, k, v, tuple(c[..., :48].contiguous() for c in cache), pos, bias)  # another head size
    with pytest.raises(ValueError):
        k6.decode_attn(q, k, v, (cache[0].transpose(2, 3).contiguous().transpose(2, 3), cache[1]), pos, bias)
    with pytest.raises(ValueError):
        k6.decode_attn(q, k, v, cache, pos.int(), bias)
    with pytest.raises(ValueError):
        k6.decode_attn(q, k, v, cache, 64, bias)
    with pytest.raises(ValueError):
        k6.decode_attn(q, k, v, cache, pos, bias.to(torch.bfloat16))
    with pytest.raises(ValueError):
        k6.decode_attn(q.contiguous(), k, v, cache, pos, bias)  # q no longer a third of the qkv projection
    q3, k3, v3, cache3, _, bias3 = _k6_inputs("int8", 2, 4, 64, pos=40)
    with pytest.raises(ValueError):
        k6.decode_attn(q3[:, :3], k3[:, :3], v3[:, :3], (cache3[0][:, :3].contiguous(), cache3[1],
                                                         cache3[2][:, :3].contiguous(), cache3[3]), 40, bias3)
    assert k6.launches == before


# a child process: one launch at a valid device pos, then one at pos = S
_K6_TRAP_CHILD = """
import torch
from indextts_tpu_torch.ops.cuda import decode_attn as k6
b, h, s, dh = 2, 4, 64, 64
q, k, v = torch.randn(b, 3, h, dh, device="cuda", dtype=torch.bfloat16).unbind(1)
cache = tuple(torch.randn(b, h, s, dh, device="cuda", dtype=torch.bfloat16) for _ in range(2))
bias = torch.zeros(b, 1, s, device="cuda")
for at in (s - 1, s):
    k6.decode_attn(q, k, v, cache, torch.tensor([at], device="cuda"), bias)
    torch.cuda.synchronize()
    print("ran pos", at, flush=True)
"""


@pytest.mark.cuda
def test_k6_traps_on_a_device_pos_outside_the_cache(card):
    """A device pos outside [0, S) stops the kernel (a trap) instead of
    skipping the write, as index_copy_ fails on such an index; in a child
    process, since a trap loses the CUDA context."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _K6_TRAP_CHILD], cwd=repo, capture_output=True, text=True, timeout=600)
    assert "ran pos 63" in r.stdout, r.stderr[-2000:]
    assert "ran pos 64" not in r.stdout and r.returncode != 0, (r.stdout, r.stderr[-2000:])


def _k6_model(quant_heads=4):
    """A tiny UnifiedVoice on the card in bf16 (Dh = 64, so the step runs K6
    at the model's head size), random weights from a fixed seed, the stop
    code's logit lowered so that every loop runs its whole budget."""
    from indextts_tpu_torch.config import ConditionModuleConfig, GPTConfig
    from indextts_tpu_torch.models.gpt import UnifiedVoice

    cfg = GPTConfig(layers=2, model_dim=64 * quant_heads, heads=quant_heads, max_text_tokens=60, max_mel_tokens=48,
                    number_text_tokens=50, number_mel_codes=66, start_mel_token=64, stop_mel_token=65,
                    condition_num_latent=8,
                    condition_module=ConditionModuleConfig(output_size=32, linear_units=64, attention_heads=4,
                                                           num_blocks=1, input_layer="conv2d2", perceiver_mult=2))
    model = UnifiedVoice(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.mel_head.bias[cfg.stop_mel_token] = -1e4
    return cfg, model.to("cuda", torch.bfloat16).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["decode", "decode_int8", "beam", "slot"])
def test_k6_replayed_blocks_equal_eager(card, loop):
    """A decode loop's blocks captured and replayed (graphs.py) against the
    same blocks run eagerly: token for token over more than one block, and
    K6's `launches` counts layers x steps run in both (a replay adds the
    captured step's launch per layer times the steps the block ran)."""
    from indextts_tpu_torch.graphs import BLOCK, Graphs
    from indextts_tpu_torch.models import gpt_decode as tdec
    from indextts_tpu_torch.models import gpt_slots as tslots

    cfg, model = _k6_model()
    g = torch.Generator(device="cuda").manual_seed(3)
    b = 3
    conds = (0.1 * torch.randn(b, 8, cfg.model_dim, device="cuda", generator=g)).to(torch.bfloat16)
    text = torch.randint(2, 50, (b, 12), device="cuda", generator=g)
    lens = torch.tensor([12, 9, 5], device="cuda")

    def run(graphs):
        before = k6.launches
        with torch.no_grad():
            if loop in ("decode", "decode_int8"):
                gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=40)
                codes, lengths = tdec.generate_speech(model, cfg, gen, conds, text, lens, torch.Generator(),
                                                      quant_kv=loop == "decode_int8", graphs=graphs.decode)
                steps = int(lengths.max()) - 1
            elif loop == "beam":
                gen = tdec.GenerationConfig(do_sample=False, num_beams=3, max_new_tokens=40, early_stopping=False)
                stats = {}
                codes, lengths = tdec.generate_speech_beam(model, cfg, gen, conds[:1], text[:1], lens[:1],
                                                           torch.Generator(), stats=stats, graphs=graphs.decode)[:2]
                steps = stats["steps"]
            else:
                gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=40)
                st = tslots.slot_state_init(cfg, gen, 4, 128, torch.bfloat16, device="cuda", quant_kv=True)
                for slot in range(b):
                    prod = tslots.slot_prefill(model, cfg, gen, conds[slot : slot + 1], text[slot : slot + 1, :12],
                                               lens[slot : slot + 1], torch.Generator(), quant_kv=True)
                    tslots.slot_admit(st, prod, slot, cfg)
                tslots.slot_steps(model, cfg, gen, st, 45, torch.Generator(), graphs=graphs.slot)
                codes, steps = st.codes, int(st.tick)
        torch.cuda.synchronize()
        return codes.cpu(), steps, k6.launches - before

    graphs = Graphs("cuda")
    eager_graphs = Graphs("cuda")
    with eager_graphs.eager():
        want, want_steps, want_launches = run(eager_graphs)
    got, got_steps, got_launches = run(graphs)
    assert torch.equal(got, want)
    assert got_steps == want_steps > BLOCK and want_launches == got_launches == cfg.layers * want_steps
    stage = graphs.slot if loop == "slot" else graphs.decode
    assert any(lane.replays > 0 for lane in stage.lanes.values())


# ---------------------------------------------------------------------------
# K6 with grouped-query attention, and K7 (the Mamba-2 decode step)
# ---------------------------------------------------------------------------

from indextts_tpu_torch.ops.cuda import ssm_step as k7  # noqa: E402

GRANITE_SCALE = 0.015625  # granite-4.0-h's attention_multiplier


def _k6_gqa_inputs(kind, b, hq, hk, s_len, dh=64, pos=None, seed=0):
    """q [B, Hq, Dh], k, v [B, Hkv, Dh] as views of one qkv projection (so
    they share its stride), the KV-head cache, the bias (as _k6_inputs') and
    pos."""
    pos = min(200, s_len - 20) if pos is None else pos
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn(b, (hq + 2 * hk) * dh, device="cuda", generator=g).to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (-1, dh)) for t in y.split([hq * dh, hk * dh, hk * dh], dim=-1))
    kv = [torch.randn(b, hk, s_len, dh, device="cuda", generator=g).to(torch.bfloat16) for _ in range(2)]
    cols = torch.arange(s_len, device="cuda")[None, :]
    valid = (cols >= 7 * torch.arange(b, device="cuda")[:, None] % pos) & (cols < pos)
    if kind == "int8":
        cache = k6.quant_cols(kv[0]) + k6.quant_cols(kv[1])
        cache = (cache[0], cache[1], cache[2], cache[3])
        valid |= (cols > pos) & (torch.rand(b, s_len, device="cuda", generator=g) < 0.7)
    else:
        cache = tuple(kv)
    valid &= cols != pos
    bias = torch.where(valid, torch.zeros((), device="cuda"), torch.finfo(torch.float32).min)[:, None, :]
    return q, k, v, cache, torch.tensor([pos], device="cuda"), bias


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,hq,hk,s_len,dh", [("int8", 32, 32, 8, 320, 64), ("bf16", 8, 32, 8, 331, 64),
                                                   ("bf16", 3, 32, 8, 351, 64), ("int8", 4, 4, 2, 96, 16),
                                                   ("int8", 1, 32, 8, 320, 64), ("bf16", 1, 32, 8, 331, 64)])
def test_k6_gqa_is_no_farther_from_float64_than_the_plain_path(card, kind, b, hq, hk, s_len, dh):
    """K6 with Hq / Hkv query heads a KV head and granite's scale: against
    the formula in float64, as test_k6_is_no_farther_from_float64_than_the_plain_path
    holds the multi-head instance; column pos is written as the plain path
    writes it, the int8 bytes and scales exactly, and every other column
    keeps its bytes. One row too (infer's): its q, k and v views of the
    projection carry different strides on their size-1 batch dimension."""
    q, k, v, cache, pos, bias = _k6_gqa_inputs(kind, b, hq, hk, s_len, dh)
    ref = k6.decode_attn_f64(q, k, v, cache, bias, GRANITE_SCALE)
    before = k6.launches
    mine = tuple(c.clone() for c in cache)
    out = k6.decode_attn(q, k, v, mine, pos, bias, GRANITE_SCALE)
    again = k6.decode_attn(q, k, v, tuple(c.clone() for c in cache), pos, bias, GRANITE_SCALE)
    theirs = tuple(c.clone() for c in cache)
    plain = k6.decode_attn_plain(q, k, v, theirs, pos, bias, GRANITE_SCALE)
    torch.cuda.synchronize()
    assert k6.launches == before + 2 and out.shape == (b, hq * dh) and torch.equal(out, again)
    err = (out.double() - ref).abs()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp(min=2.0 ** -126))) - 7)
    assert (err <= ulp + 1e-5).all(), (err.max().item(), (err / (ulp + 1e-5)).max().item())
    assert err.max().item() <= (plain.double() - ref).abs().max().item()
    for c, t in zip(mine, theirs):
        assert torch.equal(c, t)


@pytest.mark.cuda
def test_k6_gqa_raises_on_a_group_it_was_not_built_for(card):
    q, k, v, cache, pos, bias = _k6_gqa_inputs("bf16", 2, 24, 8, 64, pos=40)
    before = k6.launches
    with pytest.raises(ValueError):
        k6.decode_attn(q, k, v, cache, pos, bias, GRANITE_SCALE)  # 3 query heads a KV head
    assert k6.launches == before


def _k7_inputs(b, h, p, n, dtype, seed=0, k=4):
    g = torch.Generator(device="cuda").manual_seed(seed)
    di, cd = h * p, h * p + 2 * n
    rnd = lambda *shape, s=1.0: (s * torch.randn(*shape, device="cuda", generator=g))
    zx = rnd(b, di + cd + h).to(dtype)
    conv = rnd(b, cd, k - 1).to(dtype)
    state = rnd(b, h, p, n)
    params = (rnd(cd, 1, k, s=0.3).to(dtype), rnd(cd, s=0.01).to(dtype), rnd(h, s=2.0).to(dtype),
              rnd(h, s=0.5).to(dtype), (1 + rnd(h, s=0.05)).to(dtype))
    return zx, conv, state, params


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,p,n", [(1, 64, 64, 128), (3, 64, 64, 128), (32, 64, 64, 128), (5, 4, 16, 16)])
def test_k7_matches_plain(card, dtype, b, h, p, n):
    """K7 against its plain version on the card: the gated output and the
    SSM state within float32's rounding of a 128-term sum (relative 1e-5),
    the conv state exactly (a shift of the stored values); one launch, two
    runs bit-equal, and the rows' last-block counters back at zero."""
    zx, conv, state, (w, wb, dtb, alog, dsk) = _k7_inputs(b, h, p, n, dtype)
    before = k7.launches
    outs = []
    for _ in range(2):
        c, s = conv.clone(), state.clone()
        outs.append((k7.ssm_step(zx, c, w, wb, dtb, alog, dsk, s, h, p, n), c, s))
    c, s = conv.clone(), state.clone()
    plain = k7.ssm_step_plain(zx, c, w, wb, dtb, alog, dsk, s, h, p, n)
    torch.cuda.synchronize()
    assert k7.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(outs[0], outs[1]))
    out, c_k, s_k = outs[0]
    assert out.dtype == torch.float32 and out.shape == (b, h * p)
    assert torch.equal(c_k, c)
    assert ((out - plain).abs().max() <= 1e-5 * plain.abs().max()).item(), (out - plain).abs().max().item()
    assert ((s_k - s).abs().max() <= 1e-5 * s.abs().max()).item(), (s_k - s).abs().max().item()
    assert not k7._counters[zx.device][:b].any()


@pytest.mark.cuda
def test_k7_raises_instead_of_falling_back(card):
    zx, conv, state, (w, wb, dtb, alog, dsk) = _k7_inputs(2, 64, 64, 128, torch.bfloat16)
    before = k7.launches
    with pytest.raises(TypeError):
        k7.ssm_step(zx.half(), conv, w, wb, dtb, alog, dsk, state, 64, 64, 128)
    with pytest.raises(ValueError):
        k7.ssm_step(zx, conv, w, wb, dtb, alog, dsk, state, 32, 128, 128)  # a head size it was not built for
    with pytest.raises(ValueError):
        k7.ssm_step(zx, conv.float(), w, wb, dtb, alog, dsk, state, 64, 64, 128)
    with pytest.raises(ValueError):
        k7.ssm_step(zx, conv, w, wb, dtb, alog, dsk, state.transpose(2, 3).contiguous().transpose(2, 3), 64, 64, 128)
    assert k7.launches == before


def _hybrid_model():
    """A tiny granite hybrid UnifiedVoice on the card in bf16 (Mamba heads of
    16 x 16, K7's tiny instance; attention heads of 64 with 4 query heads a
    KV head, K6-GQA's published one), the stop code's logit lowered."""
    from indextts_tpu_torch.config import ConditionModuleConfig, GPTConfig
    from indextts_tpu_torch.models.gpt import UnifiedVoice

    cfg = GPTConfig(layers=4, model_dim=512, heads=8, kv_heads=2, max_text_tokens=60, max_mel_tokens=48,
                    number_text_tokens=50, number_mel_codes=66, start_mel_token=64, stop_mel_token=65,
                    condition_num_latent=8, block="granite_hybrid",
                    layer_types=("mamba", "mamba", "attention", "mamba"), intermediate_size=768, mamba_heads=64,
                    mamba_head_dim=16, mamba_d_state=16, mamba_chunk_size=8, embedding_multiplier=12.0,
                    residual_multiplier=0.22, attention_multiplier=GRANITE_SCALE, logits_scaling=8.0,
                    condition_module=ConditionModuleConfig(output_size=32, linear_units=64, attention_heads=4,
                                                           num_blocks=1, input_layer="conv2d2", perceiver_mult=2))
    model = UnifiedVoice(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.mel_head.bias[cfg.stop_mel_token] = -1e4
    return cfg, model.to("cuda", torch.bfloat16).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["decode", "decode_int8", "beam", "slot"])
def test_k7_replayed_hybrid_blocks_equal_eager(card, loop):
    """The hybrid decoder's loops, captured and replayed, against the same
    blocks run eagerly: token for token over more than one block, and K7's
    `launches` counts Mamba layers x steps in both (K6's attention layers x
    steps)."""
    from indextts_tpu_torch.graphs import BLOCK, Graphs
    from indextts_tpu_torch.models import gpt_decode as tdec
    from indextts_tpu_torch.models import gpt_slots as tslots

    cfg, model = _hybrid_model()
    g = torch.Generator(device="cuda").manual_seed(3)
    b = 3
    conds = (0.1 * torch.randn(b, 8, cfg.model_dim, device="cuda", generator=g)).to(torch.bfloat16)
    text = torch.randint(2, 50, (b, 12), device="cuda", generator=g)
    lens = torch.tensor([12, 9, 5], device="cuda")

    def run(graphs):
        before, before6 = k7.launches, k6.launches
        with torch.no_grad():
            if loop in ("decode", "decode_int8"):
                gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=40)
                codes, lengths = tdec.generate_speech(model, cfg, gen, conds, text, lens, torch.Generator(),
                                                      quant_kv=loop == "decode_int8", graphs=graphs.decode)
                steps = int(lengths.max()) - 1
            elif loop == "beam":
                gen = tdec.GenerationConfig(do_sample=False, num_beams=3, max_new_tokens=40, early_stopping=False)
                stats = {}
                codes, lengths = tdec.generate_speech_beam(model, cfg, gen, conds[:1], text[:1], lens[:1],
                                                           torch.Generator(), stats=stats, graphs=graphs.decode)[:2]
                steps = stats["steps"]
            else:
                gen = tdec.GenerationConfig(do_sample=False, max_new_tokens=40)
                st = tslots.slot_state_init(cfg, gen, 4, 128, torch.bfloat16, device="cuda", quant_kv=True)
                for slot in range(b):
                    prod = tslots.slot_prefill(model, cfg, gen, conds[slot : slot + 1], text[slot : slot + 1, :12],
                                               lens[slot : slot + 1], torch.Generator(), quant_kv=True)
                    tslots.slot_admit(st, prod, slot, cfg)
                tslots.slot_steps(model, cfg, gen, st, 45, torch.Generator(), graphs=graphs.slot)
                codes, steps = st.codes, int(st.tick)
        torch.cuda.synchronize()
        return codes.cpu(), steps, k7.launches - before, k6.launches - before6

    graphs = Graphs("cuda")
    eager_graphs = Graphs("cuda")
    with eager_graphs.eager():
        want, want_steps, want_k7, want_k6 = run(eager_graphs)
    got, got_steps, got_k7, got_k6 = run(graphs)
    assert torch.equal(got, want)
    assert got_steps == want_steps > BLOCK
    assert want_k7 == got_k7 == cfg.mamba_layers * want_steps and want_k6 == got_k6 == cfg.attn_layers * want_steps
    stage = graphs.slot if loop == "slot" else graphs.decode
    assert any(lane.replays > 0 for lane in stage.lanes.values())
