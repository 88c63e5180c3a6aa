"""K2: the anti-aliased Snake/SnakeBeta followed by a dilated Conv1d + bias,
fused into one CUDA kernel written for Hopper (csrc/aa_snake_dconv.cu), and
its plain PyTorch version.

Replaces indextts_tpu/ops/pallas/aa_conv_branch.py:fused_aa_snake_dconv_tmajor.
It is one AMPBlock1 half-branch (models/bigvgan.py under INDEXTTS_WIDE_BRANCH=1,
stages with C >= 128), on the trunk's [B, C, T] layout with torch's
[Cout, Cin, k] Conv1d weight. The kernel reads the weight in a packed order
(pack_weight: 64 x 64 tiles laid out as the tensor cores' shared-memory
operand); the wrapper packs a weight once and keeps the packed copy for as
long as the weight tensor lives and is unchanged (packed_weight).

`fused_aa_snake_dconv` takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from indextts_tpu_torch.ops.antialias import activation1d
from indextts_tpu_torch.ops.cuda.antialias import _taps, anti_alias_snake_plain
from indextts_tpu_torch.ops.cuda.common import _cached, launch, snake_parameters

SOURCE = "aa_snake_dconv.cu"

# kernel launches in this process; one per launch, nowhere else
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

TILE = 64  # the packed weight's tile: 64 output x 64 input channels


def aa_snake_dconv_plain(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    dilation: int,
    alpha_logscale: bool = False,
) -> torch.Tensor:
    """K2's function in plain PyTorch: K1's plain version (the composed
    activation, rounded to x's dtype), then F.conv1d with zero padding
    (k*d - d)/2 in float32 on the rounded activation and weight, the float32
    bias added, the result rounded to x's dtype. The JAX oracle
    aa_snake_dconv_ref on the [B, C, T] layout. On the card the caller turns
    TF32 off (torch.backends.cudnn.allow_tf32) for a float32 reference."""
    act = anti_alias_snake_plain(x, alpha, beta, alpha_logscale)
    k = weight.shape[-1]
    y = F.conv1d(act.float(), weight.to(x.dtype).float(), bias.to(x.dtype).float(),
                 padding=(k * dilation - dilation) // 2, dilation=dilation)
    return y.to(x.dtype)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(v.float().abs().clamp_min(1e-30))) - 7)


def aa_snake_dconv_bound(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor],
    weight: torch.Tensor,
    dilation: int,
    ref: torch.Tensor,
    alpha_logscale: bool = False,
) -> torch.Tensor:
    """Elementwise bound on |K2 - aa_snake_dconv_plain| ([B, C, T]; ref is
    the plain version's output).

    Both sides sum the products of the same rounded activation and weight in
    float32, in different orders: 2e-5 of (|act| conv |w|). In bf16 the
    kernel's float32 activation and the composed path's differ in the last
    bits (measured <= 5e-7), so an activation whose float32 value lies within
    eps = 1e-5 + 2^-19 |act| of a bf16 rounding midpoint may round the other
    way, moving the output by |w| times its ulp: such near-ties, conv |w|.
    And the output's own rounding to bf16: two ulps."""
    k = weight.shape[-1]
    w_abs = weight.float().abs()

    def conv(a):
        return F.conv1d(a, w_abs, padding=(k * dilation - dilation) // 2, dilation=dilation)

    act32 = activation1d(x.float(), alpha, beta, alpha_logscale, approx_sin_=x.dtype == torch.bfloat16)
    bound = 2e-5 * conv(act32.abs())
    if x.dtype == torch.bfloat16:
        ulp = _bf16_ulp(act32.abs() * (1 + 2.0 ** -8))  # the upper binade's ulp next to a power of two
        to_midpoint = ulp / 2 - (act32 - act32.to(torch.bfloat16).float()).abs()
        near_tie = to_midpoint <= 1e-5 + 2.0 ** -19 * act32.abs()
        bound = bound + conv(torch.where(near_tie, ulp, torch.zeros((), device=x.device))) + 2 * _bf16_ulp(ref)
    return bound


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch's Conv1d weight [Cout, Cin, k] in the order the kernel reads it:
    channels zero-padded to a multiple of 64, then [k, Cout/64, Cin/64] tiles
    of 64 x 64, each tile as 8 planes (one per 8 input channels) of 64
    output-channel rows of 8 values, so a tile is one contiguous block laid
    out as the tensor cores' no-swizzle K-major operand. Returns
    [k, Cout/64, Cin/64, 8, 64, 8], contiguous."""
    co, ci, k = weight.shape
    nco, nci = -(-co // TILE), -(-ci // TILE)
    w = torch.zeros(k, nco * TILE, nci * TILE, dtype=weight.dtype, device=weight.device)
    w[:, :co, :ci] = weight.permute(2, 0, 1)
    # [k, tile_o, o, tile_i, plane, i8] -> [k, tile_o, tile_i, plane, o, i8]
    return w.view(k, nco, TILE, nci, 8, 8).permute(0, 1, 3, 4, 2, 5).contiguous()


def packed_weight(weight: torch.Tensor) -> torch.Tensor:
    """pack_weight(weight), made once per weight (see _cached): a stale packed
    copy would be a wrong result, so an updated or replaced weight is packed
    again."""
    return _cached(weight, "packed", pack_weight)


_fn = None  # the bound C function, argtypes set once


def _library() -> ctypes.CDLL:
    global _fn
    from indextts_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if _fn is None:
        fn = lib.indextts_aa_snake_dconv
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return lib


def fused_aa_snake_dconv(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    dilation: int,
    alpha_logscale: bool = False,
) -> torch.Tensor:
    """x: [B, C, T] float32 or bf16; alpha (and beta, None for Snake) [C];
    weight [C, C, k] with k odd and bias [C], both in x's dtype. Returns
    conv1d(activation(x), weight, bias, 'same', dilation) [B, C, T] in x's
    dtype."""
    global launches
    if x.device.type == "cpu":
        return aa_snake_dconv_plain(x, alpha, beta, weight, bias, dilation, alpha_logscale)
    name = "fused_aa_snake_dconv"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, C, T], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    b, c, t = x.shape
    k = weight.shape[-1] if weight.dim() == 3 else 0
    if weight.shape != (c, c, k) or k % 2 == 0 or bias.shape != (c,):
        raise ValueError(f"{name}: weight must be [{c}, {c}, k] with k odd and bias [{c}], "
                         f"got {tuple(weight.shape)} and {tuple(bias.shape)}")
    if weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"{name}: weight and bias must be {x.dtype}, got {weight.dtype} and {bias.dtype}")
    if dilation < 1 or (k - 1) * dilation % 2:
        raise ValueError(f"{name}: dilation {dilation} with k = {k} has no 'same' padding")
    for label, tensor in (("x", x), ("weight", weight), ("bias", bias)):
        if not tensor.is_contiguous() or tensor.device != x.device:
            raise ValueError(f"{name}: {label} must be contiguous on {x.device}")
    for label, p in (("alpha", alpha), ("beta", beta)):
        if p is not None and (p.shape != (c,) or p.device != x.device):
            raise ValueError(f"{name}: {label} must be [{c}] on {x.device}, got {tuple(p.shape)} on {p.device}")
    a, bt = snake_parameters(alpha, beta, alpha_logscale)
    wp = packed_weight(weight)  # made once per weight
    out = torch.empty_like(x)
    if _fn is None:
        _library()
    args = (x.data_ptr(), wp.data_ptr(), bias.data_ptr(), out.data_ptr(), a.data_ptr(), bt.data_ptr(),
            b, c, t, k, int(dilation), _DTYPE_CODE[x.dtype], ctypes.addressof(_taps()))
    err = launch(_fn, x, *args)
    if err != 0:
        raise RuntimeError(f"aa_snake_dconv kernel launch failed: CUDA error {err} "
                           f"(shape {tuple(x.shape)}, k {k}, dilation {dilation})")
    launches += 1
    return out
