"""K5: the int8-weight matmul, a CUDA kernel written for Hopper
(csrc/int8_matmul.cu), and its plain PyTorch version.

Replaces indextts_tpu/ops/pallas/qmatmul.py:int8_matmul. The quantized GPT
linears (ops/quant.py:QuantLinear) call it for every
2-D product: the decode step's four block matmuls per layer and the mel
head. The weight is in torch Linear's layout, wq [N, K] int8, one output
channel per row (the JAX kernel takes [K, N]); the kernel reads it as it is,
no packed copy. chip_smoke.py's k5 phase holds the kernel against the plain
version and times it (per decode step, M = 1 .. 16, with F.linear on bf16
weights as a yardstick); the alternatives the source's header note lists
were timed with the same phase.

`int8_matmul` takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from indextts_tpu_torch.ops.cuda.common import launch

SOURCE = "int8_matmul.cu"

# kernel launches in this process; one per launch, nowhere else
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5's function in plain PyTorch: bf16(x) @ wq^T accumulated in float32,
    times scale, cast to x's dtype, plus bias in x's dtype (qmatmul.py:24-38,
    84-86)."""
    y = (x.to(torch.bfloat16).float() @ wq.float().t()) * scale.float()
    out = y.to(x.dtype)
    return out if bias is None else out + bias.to(x.dtype)


_fn = None  # the bound C function, argtypes set once


def _library() -> ctypes.CDLL:
    global _fn
    from indextts_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if _fn is None:
        fn = lib.indextts_int8_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return lib


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [M, K] float32 or bf16; wq: [N, K] int8; scale: [N] (any float
    dtype, read as float32); bias: [N] or None. Returns [M, N] in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"int8_matmul: x must be [M, K], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"int8_matmul: x must be float32 or bfloat16, got {x.dtype}")
    if wq.dtype != torch.int8 or wq.dim() != 2:
        raise TypeError(f"int8_matmul: wq must be a 2-D int8 tensor, got {wq.dtype} {tuple(wq.shape)}")
    m, k = x.shape
    n = wq.shape[0]
    if wq.shape[1] != k:
        raise ValueError(f"int8_matmul: wq {tuple(wq.shape)} does not take x {tuple(x.shape)} (want [N, {k}])")
    if not (x.is_contiguous() and wq.is_contiguous()):
        raise ValueError("int8_matmul: x and wq must be contiguous")
    # QuantLinear's buffers are already float32 [N] / x's dtype [N], contiguous: no copies then
    if scale.dtype != torch.float32 or scale.dim() != 1 or not scale.is_contiguous():
        scale = scale.float().reshape(-1).contiguous()
    if scale.numel() != n:
        raise ValueError(f"int8_matmul: scale has {scale.numel()} entries for N = {n}")
    if bias is not None:
        if bias.dtype != x.dtype or not bias.is_contiguous():
            bias = bias.to(x.dtype).contiguous()
        if bias.shape != (n,):
            raise ValueError(f"int8_matmul: bias must be [{n}], got {tuple(bias.shape)}")
    for name, t in (("wq", wq), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, x on {x.device}")
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if _fn is None:
        _library()
    args = (x.data_ptr(), wq.data_ptr(), scale.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr(), m, n, k, _DTYPE_CODE[x.dtype])
    err = launch(_fn, x, *args)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err} (x {tuple(x.shape)}, "
                           f"wq {tuple(wq.shape)})")
    launches += 1
    return out
