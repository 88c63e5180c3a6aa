"""K1, the fused anti-aliased Snake/SnakeBeta: the port's plain version
against the JAX composed path and against the JAX Pallas kernel (interpret
mode, as tests/test_pallas.py runs it), in float32 on the CPU, and the
wrapper's CPU route. The CUDA kernel itself is held against this plain
version in tests/test_torch_cuda_kernels.py.

The port's K1 takes the vocoder trunk's [B, C, T]; the JAX functions take
[B, T, C], so inputs are transposed on the way in. Tolerance 1e-5 absolute
(summation order differs between the composed convolutions and the Pallas
polyphase sums)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from indextts_tpu.ops.antialias import anti_aliased_activation as jax_composed
from indextts_tpu.ops.pallas.antialias import fused_anti_alias_snake as jax_pallas
from indextts_tpu_torch.ops import antialias as taa
from indextts_tpu_torch.ops.cuda import antialias as k1

TOL = 1e-5
rng = np.random.default_rng(3)

# T not a multiple of any tile (the Pallas 128/256, the CUDA kernel's 512),
# C = 24 (the last vocoder stage) and C >= 128
SHAPES = [(2, 300, 24), (1, 1000, 130), (1, 64, 8), (1, 517, 128), (2, 1, 3)]


def _inputs(b, t, c, beta=True):
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    alpha = (rng.standard_normal(c) * 0.3).astype(np.float32)
    bt = (rng.standard_normal(c) * 0.3).astype(np.float32) if beta else None
    return x, alpha, bt


def _port(x, alpha, beta, logscale):
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    out = k1.anti_alias_snake_plain(
        xt, torch.from_numpy(alpha), None if beta is None else torch.from_numpy(beta), logscale
    )
    return out.numpy().transpose(0, 2, 1)


def _jax(fn, x, alpha, beta, logscale, **kw):
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(alpha), None if beta is None else jnp.asarray(beta),
                         alpha_logscale=logscale, **kw))


@pytest.mark.parametrize("b,t,c", SHAPES)
def test_plain_matches_jax_composed(b, t, c):
    x, alpha, beta = _inputs(b, t, c)
    np.testing.assert_allclose(_port(x, alpha, beta, True), _jax(jax_composed, x, alpha, beta, True),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("b,t,c", [s for s in SHAPES if s[1] >= 64])
def test_plain_matches_jax_pallas_interpret(b, t, c):
    x, alpha, beta = _inputs(b, t, c)
    gold = _jax(jax_pallas, x, alpha, beta, True, tile_t=256, interpret=True)
    np.testing.assert_allclose(_port(x, alpha, beta, True), gold, atol=TOL, rtol=0)


def test_snake_without_beta():
    x, alpha, _ = _inputs(1, 200, 16, beta=False)
    alpha = np.abs(alpha) + 0.1
    mine = _port(x, alpha, None, False)
    np.testing.assert_allclose(mine, _jax(jax_composed, x, alpha, None, False), atol=TOL, rtol=0)
    np.testing.assert_allclose(mine, _jax(jax_pallas, x, alpha, None, False, tile_t=128, interpret=True),
                               atol=TOL, rtol=0)


def test_composed_jax_layout_matches_jax():
    x, alpha, beta = _inputs(2, 77, 5)
    mine = taa.anti_aliased_activation(torch.from_numpy(x), torch.from_numpy(alpha), torch.from_numpy(beta), True)
    np.testing.assert_allclose(mine.numpy(), _jax(jax_composed, x, alpha, beta, True), atol=TOL, rtol=0)


def test_kaiser_filter_matches_jax():
    from indextts_tpu.ops.antialias import kaiser_sinc_filter1d

    np.testing.assert_array_equal(taa.kaiser_sinc_filter1d(0.25, 0.3, 12), kaiser_sinc_filter1d(0.25, 0.3, 12))


def test_wrapper_on_cpu_takes_plain_path_without_launching(monkeypatch):
    monkeypatch.setattr(k1, "launches", 0)
    x = torch.from_numpy(rng.standard_normal((2, 6, 50)).astype(np.float32))
    alpha, beta = torch.zeros(6), torch.full((6,), 0.2)
    out = k1.fused_anti_alias_snake(x, alpha, beta, alpha_logscale=True)
    torch.testing.assert_close(out, k1.anti_alias_snake_plain(x, alpha, beta, True), rtol=0, atol=0)
    assert k1.launches == 0


def test_plain_bf16_uses_poly_sin_in_f32():
    """bf16 in: f32 math with the polynomial sin on the bf16 values, bf16 out."""
    x = torch.from_numpy(rng.standard_normal((1, 4, 64)).astype(np.float32)).to(torch.bfloat16)
    alpha, beta = torch.full((4,), 0.5), torch.full((4,), -0.3)
    out = k1.anti_alias_snake_plain(x, alpha, beta, True)
    want = taa.activation1d(x.float(), alpha, beta, True, approx_sin_=True).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, want, rtol=0, atol=0)
