"""Activation functions (port of indextts_tpu/ops/activations.py).

Snake/SnakeBeta follow indextts/BigVGAN/activations.py:9-122 (x + 1/(a+1e-9)·
sin²(ax), optional exp() for log-scale parameters); gelu_new is HF GPT-2's
tanh-approximated GELU. The trivial ones (relu, silu, sigmoid, tanh, glu) are
torch's own and are called directly where they are used.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NO_DIV_BY_ZERO = 1e-9

# degree-9 odd minimax polynomial for sin on [-pi, pi]: the same constants as
# the JAX package, so bf16 snake computes the same function on both sides
_SIN_C0 = 9.9999728997e-01
_SIN_C1 = -1.6665146137e-01
_SIN_C2 = 8.3198438631e-03
_SIN_C3 = -1.9424185428e-04
_SIN_C4 = 2.2248903691e-06
_INV_TWO_PI = 1.0 / (2.0 * math.pi)
_TWO_PI = 2.0 * math.pi


def approx_sin(u: torch.Tensor) -> torch.Tensor:
    """Range-reduced polynomial sin, f32 in/out. Max abs error 3.64e-5, far
    below bf16 resolution; bf16 snake uses it by default."""
    k = torch.round(u * _INV_TWO_PI)
    r = u - k * _TWO_PI
    r2 = r * r
    p = _SIN_C0 + r2 * (_SIN_C1 + r2 * (_SIN_C2 + r2 * (_SIN_C3 + r2 * _SIN_C4)))
    return r * p


def _sin_for(x: torch.Tensor, approx: Optional[bool]):
    use_approx = (x.dtype == torch.bfloat16) if approx is None else approx
    return approx_sin if use_approx else torch.sin


def snake(x, alpha, alpha_logscale: bool = False, approx_sin_: Optional[bool] = None):
    """x: [..., C] with per-channel alpha [C]. approx_sin_: None = approximate
    iff bf16; force with True/False."""
    return snake_beta(x, alpha, None, alpha_logscale, approx_sin_)


def snake_beta(x, alpha, beta, alpha_logscale: bool = False, approx_sin_: Optional[bool] = None):
    """x + 1/(b+eps)·sin²(ax) with per-channel alpha/beta [C]; beta=None is
    plain Snake (b = a). The per-channel axis is the last one."""
    sin_fn = _sin_for(x, approx_sin_)
    b = alpha if beta is None else beta
    a, b = alpha.float(), b.float()
    if alpha_logscale:
        a, b = torch.exp(a), torch.exp(b)
    xf = x.float()
    out = xf + (1.0 / (b + _NO_DIV_BY_ZERO)) * sin_fn(xf * a) ** 2
    return out.to(x.dtype)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF 'gelu_new' (GPT-2 tanh approximation)."""
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf**3)))
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in float32 (the perceiver's GEGLU)."""
    return torch.nn.functional.gelu(x.float()).to(x.dtype)
