"""K1: the fused anti-aliased Snake/SnakeBeta, a CUDA kernel written for
Hopper (csrc/anti_alias_snake.cu), and its plain PyTorch version.

Replaces indextts_tpu/ops/pallas/antialias.py:fused_anti_alias_snake. The
vocoder calls it at every activation (models/bigvgan.py). The layout is the
vocoder trunk's [B, C, T]: the stencil runs along the contiguous axis.

`fused_anti_alias_snake` takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from indextts_tpu_torch.ops.antialias import activation1d, kaiser_sinc_filter1d
from indextts_tpu_torch.ops.cuda.common import launch, sm_count, snake_parameters

SOURCE = "anti_alias_snake.cu"

# kernel launches in this process; one per launch, nowhere else
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def anti_alias_snake_plain(
    x: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor] = None, alpha_logscale: bool = False
) -> torch.Tensor:
    """K1's function in plain PyTorch: the composed path on x's values in
    float32, returned in x's dtype. The sin is the polynomial approx_sin for
    bf16 input and torch.sin otherwise, as in the kernel."""
    y = activation1d(x.float(), alpha, beta, alpha_logscale, approx_sin_=x.dtype == torch.bfloat16)
    return y.to(x.dtype)


_fn = None  # the bound C function, argtypes set once


def _library() -> ctypes.CDLL:
    global _fn
    from indextts_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if _fn is None:
        fn = lib.indextts_anti_alias_snake
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return lib


@functools.lru_cache(maxsize=None)
def _taps() -> "ctypes.Array":
    """The 12 filter taps as a C float array, built once (the kernels only read it)."""
    f = kaiser_sinc_filter1d(0.25, 0.3, 12)
    return (ctypes.c_float * 12)(*[float(v) for v in f])


def fused_anti_alias_snake(
    x: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor] = None, alpha_logscale: bool = False
) -> torch.Tensor:
    """x: [B, C, T] float32 or bf16; per-channel alpha [C] (and beta [C] for
    SnakeBeta; None is Snake). Returns [B, C, T] in x's dtype. On the card
    it launches the kernel and nothing else: alpha and beta as the kernel
    reads them are made once per parameter (common.snake_parameters)."""
    global launches
    if x.device.type == "cpu":
        return anti_alias_snake_plain(x, alpha, beta, alpha_logscale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_anti_alias_snake: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"fused_anti_alias_snake: x must be [B, C, T], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_anti_alias_snake: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_anti_alias_snake: x must be contiguous")
    b, c, t = x.shape
    if min(b, c, t) < 1:
        raise ValueError(f"fused_anti_alias_snake: x must have B, C, T >= 1, got shape {tuple(x.shape)}")
    for name, p in (("alpha", alpha), ("beta", beta)):
        if p is not None and (p.shape != (c,) or p.device != x.device):
            raise ValueError(f"fused_anti_alias_snake: {name} must be [{c}] on {x.device}, "
                             f"got {tuple(p.shape)} on {p.device}")
    a, bt = snake_parameters(alpha, beta, alpha_logscale)
    out = torch.empty_like(x)
    if _fn is None:
        _library()
    args = (x.data_ptr(), out.data_ptr(), a.data_ptr(), bt.data_ptr(), b, c, t, _DTYPE_CODE[x.dtype],
            sm_count(x.device.index), ctypes.addressof(_taps()))
    err = launch(_fn, x, *args)
    if err != 0:
        raise RuntimeError(f"anti_alias_snake kernel launch failed: CUDA error {err} (shape {tuple(x.shape)})")
    launches += 1
    return out
