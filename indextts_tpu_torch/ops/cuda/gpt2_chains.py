"""K8: the GPT-2 block's residual adds and LayerNorms as one CUDA kernel
written for Hopper (csrc/gpt2_chains.cu), and its plain PyTorch version;
beside it the block's gelu_new.

Replaces no TPU kernel: the JAX package leaves these chains to XLA
(indextts_tpu/models/gpt.py). `add_layer_norm` is a residual add and the
LayerNorm that follows it: x + d rounded to the working dtype, then the
LayerNorm of that sum computed in float64 and rounded once (without d, a
plain LayerNorm). Every GPT-2 pass of the port runs it (models/gpt.py
GPT2Block, gpt2_apply and the decode step's ln_f): per layer one into ln_2
and one of the MLP's output into the next layer's ln_1 (ln_f after the
last), so 2 x layers + 1 launches a decode step or a whole-sequence pass,
49 at 24 layers. `gelu_new` is HF GPT-2's tanh GELU: on the card PyTorch's
own (F.gelu, approximate="tanh"), which computes the same formula in
float32 and rounds once, in one launch.

The plain versions are the composition the block ran before: the add in
the working dtype, ops/norms.layer_norm and ops/activations.gelu_new. Each
function takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from indextts_tpu_torch.ops import activations, norms
from indextts_tpu_torch.ops.cuda.common import launch

SOURCE = "gpt2_chains.cu"

# add_layer_norm's kernel launches in this process; one per launch, nowhere else
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def add_layer_norm_plain(x: torch.Tensor, d: Optional[torch.Tensor], gamma: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + d, layer_norm(x + d)) as the block composed them (x itself
    without d)."""
    x = x if d is None else x + d
    return x, norms.layer_norm(x, gamma, beta, eps)


gelu_new_plain = activations.gelu_new


def add_layer_norm_f64(x: torch.Tensor, d: Optional[torch.Tensor], gamma: torch.Tensor, beta: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """The LayerNorm of the sum x + d (rounded to x's dtype, as both versions
    round it) in float64: the yardstick of the kernel's and the plain
    version's error (the card tests, chip_smoke.py)."""
    s = (x if d is None else x + d).double()
    mean = s.mean(-1, keepdim=True)
    var = ((s - mean) ** 2).mean(-1, keepdim=True)
    return (s - mean) / torch.sqrt(var + eps) * gamma.double() + beta.double()


def gelu_new_f64(x: torch.Tensor) -> torch.Tensor:
    """gelu_new in float64, the yardstick of its error."""
    xd = x.double()
    return 0.5 * xd * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xd + 0.044715 * xd ** 3)))


_fns = {}  # the bound C functions, argtypes set once


def _library() -> ctypes.CDLL:
    from indextts_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if not _fns:
        ln = lib.indextts_add_layer_norm
        ln.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_double, ctypes.c_int,
                                               ctypes.c_void_p]
        ln.restype = ctypes.c_int
        _fns.update(add_layer_norm=ln)
    return lib


def _on_card(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA one
    the kernel takes: float32 or bf16, contiguous, 16-byte aligned, the last
    dimension a multiple of 8. Raises on anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() == 0 or x.numel() == 0 or x.shape[-1] % 8:
        raise ValueError(f"{name}: x must be non-empty with its last dimension a multiple of 8, got "
                         f"{tuple(x.shape)}")
    return True


def _check(name: str, what: str, t: torch.Tensor, shape: tuple, x: torch.Tensor) -> None:
    if t.dtype != x.dtype or tuple(t.shape) != shape or t.device != x.device:
        raise ValueError(f"{name}: {what} must be {x.dtype} {shape} on {x.device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be contiguous and start on a 16-byte boundary")


def _raise_on(err: int, name: str, x: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} (x {x.dtype} {tuple(x.shape)})")


def add_layer_norm(x: torch.Tensor, d: Optional[torch.Tensor], gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_new, y): x_new = x + d in x's dtype (x itself when d is None) and
    y = LayerNorm(x_new) * gamma + beta, correctly rounded, in one launch
    on a CUDA tensor. x, d [..., D] of one dtype, float32 or bf16,
    contiguous, D a multiple of 8; gamma, beta [D] of that dtype."""
    global launches
    if not _on_card("add_layer_norm", x):
        return add_layer_norm_plain(x, d, gamma, beta, eps)
    dim = x.shape[-1]
    _check("add_layer_norm", "x", x, tuple(x.shape), x)
    if d is not None:
        _check("add_layer_norm", "d", d, tuple(x.shape), x)
    for what, t in (("gamma", gamma), ("beta", beta)):
        _check("add_layer_norm", what, t, (dim,), x)
    x_new = x if d is None else torch.empty_like(x)
    y = torch.empty_like(x)
    if not _fns:
        _library()
    err = launch(_fns["add_layer_norm"], x, x.data_ptr(), None if d is None else d.data_ptr(),
                 None if d is None else x_new.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 x.numel() // dim, dim, float(eps), _DTYPE_CODE[x.dtype])
    _raise_on(err, "add_layer_norm", x)
    launches += 1
    return x_new, y


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF GPT-2's tanh GELU of x: the plain version on the CPU; on a CUDA
    tensor PyTorch's tanh GELU, one launch, float32 inside, one rounding."""
    if x.device.type == "cpu":
        return gelu_new_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"gelu_new: unsupported device {x.device}")
    return F.gelu(x, approximate="tanh")
