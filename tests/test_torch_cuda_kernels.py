"""The hand-written CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU; every test skips without one. This file imports no JAX, so it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(tests/conftest.py configures JAX, hence --noconftest there.)"""

import numpy as np
import pytest
import torch

from indextts_tpu_torch.ops.cuda import antialias as k1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,t", [(1, 768, 1600), (4, 24, 102400), (2, 130, 517)])
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
