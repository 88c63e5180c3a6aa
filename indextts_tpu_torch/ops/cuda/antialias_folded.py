"""K4: the fused anti-aliased Snake/SnakeBeta of the vocoder's narrow stages, a
CUDA kernel written for Hopper (csrc/anti_alias_snake_folded.cu), and its
plain PyTorch version.

Replaces indextts_tpu/ops/pallas/antialias_folded.py:fused_folded_aa. The
vocoder calls it at every resblock activation of a stage with C <= 96 under
INDEXTTS_FUSED_AA=1 (models/bigvgan.py). The layout is the vocoder trunk's
[B, C, T]: the JAX kernel's phase-folded grid [B, N, s*C] is a TPU lane
layout and is not carried over. What it computes is, with its rounding
points: the filter taps (2 f up, f down) and the activated 2x-rate samples
rounded to x's dtype, float32 sums, the snake in float32, and the composed
path's edges.

`fused_folded_aa` takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. The JAX wrapper hands shapes
its block picker cannot take to the XLA path; the kernel here takes every
[B, C, T] with T >= 1, so that fallback has no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from indextts_tpu_torch.ops.antialias import activation1d, kaiser_sinc_filter1d
from indextts_tpu_torch.ops.cuda.antialias_tmajor import (
    _down,
    _params,
    _phase_samples,
    anti_alias_snake_tmajor_bound,
)
from indextts_tpu_torch.ops.cuda.common import launch, sm_count, snake_parameters

SOURCE = "anti_alias_snake_folded.cu"

# kernel launches in this process; one per launch, nowhere else
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _poly(x: torch.Tensor, poly_sin: Optional[bool]) -> bool:
    return x.dtype == torch.bfloat16 if poly_sin is None else bool(poly_sin)


def fused_folded_aa_plain(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    alpha_logscale: bool = False,
    poly_sin: Optional[bool] = None,
) -> torch.Tensor:
    """K4's function in plain PyTorch on x [B, C, T]. float32: the composed
    path. bf16: the stacked-tap products' rounding points, i.e. the taps (2 f
    up, f down) rounded to bf16, float32 sums, the snake in float32, the
    activated samples rounded to bf16 before the down taps. poly_sin None:
    the polynomial sin iff x is bf16."""
    poly = _poly(x, poly_sin)
    if x.dtype != torch.bfloat16:
        return activation1d(x.float(), alpha, beta, alpha_logscale, approx_sin_=poly).to(x.dtype)
    se, so = _phase_samples(x, *_params(alpha, beta, alpha_logscale), poly)
    return _down(se.to(x.dtype).float(), so.to(x.dtype).float(), x.dtype).to(x.dtype)


def fused_folded_aa_bound(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor],
    ref: torch.Tensor,
    alpha_logscale: bool = False,
    poly_sin: Optional[bool] = None,
) -> torch.Tensor:
    """Elementwise bound on |K4 - fused_folded_aa_plain| ([B, C, T]; ref is
    the plain version's output). float32: the two sides sum the same products
    in different orders and take the sin by different routines, 2e-5 of (1 +
    the |taps|-weighted |samples|). bf16: two output ulps on top, and a
    sample whose float32 value lies next to a bf16 rounding midpoint may
    round the other way and move the output by its ulp times a down tap. The
    rounding points are those of K3's tensor-core body, so is the bound."""
    return anti_alias_snake_tmajor_bound(x, alpha, beta, ref, alpha_logscale, mxu=True, poly_sin=poly_sin)


_fn = None  # the bound C function, argtypes set once


def _library() -> ctypes.CDLL:
    global _fn
    from indextts_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if _fn is None:
        fn = lib.indextts_anti_alias_snake_folded
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _fn = fn
    return lib


@functools.lru_cache(maxsize=None)
def _taps(dtype: torch.dtype):
    """The 12 up taps (2 f) and down taps (f), rounded to `dtype`, as C float
    arrays; built once per dtype (the kernel only reads them)."""
    f = torch.as_tensor(kaiser_sinc_filter1d(0.25, 0.3, 12))
    as_c = lambda t: (ctypes.c_float * 12)(*t.to(dtype).float().tolist())
    return as_c(2.0 * f), as_c(f)


def fused_folded_aa(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    alpha_logscale: bool = False,
    poly_sin: Optional[bool] = None,
) -> torch.Tensor:
    """x: [B, C, T] float32 or bf16, T >= 1; per-channel alpha [C] (and beta
    [C] for SnakeBeta; None is Snake). Returns [B, C, T] in x's dtype.
    poly_sin: None takes the polynomial sin iff x is bf16; True / False force
    it. On the card it launches the kernel and nothing else: alpha and beta
    as the kernel reads them are made once per parameter
    (common.snake_parameters), the taps once per dtype."""
    global launches
    name = "fused_folded_aa"
    if x.device.type == "cpu":
        return fused_folded_aa_plain(x, alpha, beta, alpha_logscale, poly_sin)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, C, T], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    b, c, t = x.shape
    if min(b, c, t) < 1:
        raise ValueError(f"{name}: x must have B, C, T >= 1, got shape {tuple(x.shape)}")
    for label, p in (("alpha", alpha), ("beta", beta)):
        if p is not None and (p.shape != (c,) or p.device != x.device):
            raise ValueError(f"{name}: {label} must be [{c}] on {x.device}, got {tuple(p.shape)} on {p.device}")
    a, bt = snake_parameters(alpha, beta, alpha_logscale)
    out = torch.empty_like(x)
    if _fn is None:
        _library()
    up, dn = _taps(x.dtype)
    args = (x.data_ptr(), out.data_ptr(), a.data_ptr(), bt.data_ptr(), b, c, t, _DTYPE_CODE[x.dtype],
            int(_poly(x, poly_sin)), sm_count(x.device.index), ctypes.addressof(up), ctypes.addressof(dn))
    err = launch(_fn, x, *args)
    if err != 0:
        raise RuntimeError(f"anti_alias_snake_folded kernel launch failed: CUDA error {err} (shape {tuple(x.shape)})")
    launches += 1
    return out
