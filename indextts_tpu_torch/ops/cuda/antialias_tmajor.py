"""K3: the fused anti-aliased Snake/SnakeBeta in three bodies (filter taps on
the CUDA cores, filter taps on the tensor cores, a pass-through), a CUDA
kernel written for Hopper (csrc/anti_alias_snake_tmajor.cu), and their plain
PyTorch versions.

Replaces indextts_tpu/ops/pallas/antialias_tmajor.py:
fused_anti_alias_snake_tmajor. The vocoder calls it at every activation of a
stage with C >= 128 under INDEXTTS_WIDE_TMAJOR=1 (models/bigvgan.py). The
layout is the vocoder trunk's [B, C, T]; the JAX kernel's time-major blocking
is a TPU layout and is not carried over, what each body computes is. On the
card the CUDA-core body and the pass-through are K1's lane scheme
(csrc/aa_lanes.cuh), and the tensor-core body is a chain of mma.sync whose
2x-rate samples stay in registers between the up and the down product.

`fused_anti_alias_snake_tmajor` takes the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises. The JAX
wrapper's probe="wrapper" times the XLA ops around its pallas_call (transpose,
pad, halo stack); nothing surrounds this kernel, so it has no counterpart
here and raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from indextts_tpu_torch.ops.activations import snake_beta
from indextts_tpu_torch.ops.antialias import activation1d, kaiser_sinc_filter1d
from indextts_tpu_torch.ops.cuda.antialias import _taps
from indextts_tpu_torch.ops.cuda.common import launch, snake_parameters

SOURCE = "anti_alias_snake_tmajor.cu"

# kernel launches in this process; one per launch, nowhere else
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BODY = {"taps": 0, "mma": 1, "ident": 2}


def _phase_samples(x: torch.Tensor, a: torch.Tensor, bt: torch.Tensor, poly_sin: bool):
    """The tensor-core body's two phases in float32, before their rounding:
    se[i] = a[2i] and so[i] = a[2i+1], the activated 2x-rate samples, from x
    [B, C, T] (values of x's dtype) with the up taps 2 f rounded to x's
    dtype. a, bt: [C] float32, already exponentiated."""
    b, c, t = x.shape
    f = torch.as_tensor(kaiser_sinc_filter1d(0.25, 0.3, 12), device=x.device)
    up = (2.0 * f).to(x.dtype).float()
    xp = F.pad(x.float().reshape(b * c, 1, t), (3, 3), mode="replicate")
    # ue[i] = sum_{o=-3..2} 2 f[5 - 2o] x[i + o]; uo[i] = sum_{o=-2..3} 2 f[6 - 2o] x[i + o]
    ue = F.conv1d(xp[..., :-1], up[[11, 9, 7, 5, 3, 1]].view(1, 1, 6)).reshape(b, c, t)
    uo = F.conv1d(xp[..., 1:], up[[10, 8, 6, 4, 2, 0]].view(1, 1, 6)).reshape(b, c, t)
    act = lambda u: snake_beta(u, a[:, None], bt[:, None], False, poly_sin)
    return act(ue), act(uo)


def _down(se: torch.Tensor, so: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """z[t] = sum_j f[j] a[clamp(2t + j - 5)] in float32 from the two phases,
    the taps rounded to `dtype`."""
    b, c, t = se.shape
    f = torch.as_tensor(kaiser_sinc_filter1d(0.25, 0.3, 12), device=se.device).to(dtype).float()
    a2 = torch.stack([se, so], dim=-1).reshape(b * c, 1, 2 * t)
    return F.conv1d(F.pad(a2, (5, 6), mode="replicate"), f.view(1, 1, 12), stride=2).reshape(b, c, t)


def _params(alpha, beta, alpha_logscale):
    """alpha and beta as float32 [C], exponentiated for log-scale parameters,
    for the plain versions (the wrappers take common.snake_parameters)."""
    a = alpha.float()
    bt = a if beta is None else beta.float()
    if alpha_logscale:
        a, bt = torch.exp(a), torch.exp(bt)
    return a.contiguous(), bt.contiguous()


def anti_alias_snake_tmajor_plain(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    alpha_logscale: bool = False,
    mxu: bool = False,
    probe: Optional[str] = None,
    poly_sin: Optional[bool] = None,
) -> torch.Tensor:
    """K3's bodies in plain PyTorch on x [B, C, T]. The CUDA-core body is the
    composed path on x's values in float32, returned in x's dtype. The
    tensor-core body repeats the banded products' rounding points: the taps
    (2 f up, f down) rounded to x's dtype, float32 sums, the snake in
    float32, the activated samples rounded to x's dtype before the down
    taps. probe="ident" returns a copy of x. poly_sin None: the polynomial
    sin iff x is bf16."""
    if probe == "ident":
        return x.clone()
    if probe is not None:
        raise ValueError(f"anti_alias_snake_tmajor: unknown probe {probe!r}")
    poly = x.dtype == torch.bfloat16 if poly_sin is None else bool(poly_sin)
    if not mxu:
        return activation1d(x.float(), alpha, beta, alpha_logscale, approx_sin_=poly).to(x.dtype)
    se, so = _phase_samples(x, *_params(alpha, beta, alpha_logscale), poly)
    return _down(se.to(x.dtype).float(), so.to(x.dtype).float(), x.dtype).to(x.dtype)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(v.float().abs().clamp_min(1e-30))) - 7)


def anti_alias_snake_tmajor_bound(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor],
    ref: torch.Tensor,
    alpha_logscale: bool = False,
    mxu: bool = False,
    poly_sin: Optional[bool] = None,
) -> torch.Tensor:
    """Elementwise bound on |K3 - anti_alias_snake_tmajor_plain| ([B, C, T];
    ref is the plain version's output).

    float32: both sides sum the same products in different orders and take
    the sin by different routines: 2e-5 of (1 + the |taps|-weighted |samples|).
    bf16, CUDA-core body: the output's own rounding on top, two ulps. bf16,
    tensor-core body: besides, a sample whose float32 value lies within eps =
    2e-5 + 2^-17 |sample| of a bf16 rounding midpoint (the tensor cores'
    float32 sum is not the plain version's) may round the other way and move
    the output by its ulp times a down tap: such near-ties, |taps|-weighted."""
    poly = x.dtype == torch.bfloat16 if poly_sin is None else bool(poly_sin)
    se, so = _phase_samples(x, *_params(alpha, beta, alpha_logscale), poly)
    bound = 2e-5 * (1.0 + _down(se.abs(), so.abs(), torch.float32).abs())
    if x.dtype != torch.bfloat16:
        return bound
    bound = bound + 2 * _bf16_ulp(ref)
    if mxu:
        flips = []
        for s in (se, so):
            # the two bf16 neighbours of |s|: lo by truncating the float32 bits, lo + ulp
            # (exact also just below a power of two, where the spacing halves)
            sa = s.abs()
            lo = (sa.view(torch.int32) & -65536).view(torch.float32)
            ulp = _bf16_ulp(lo)
            to_midpoint = (sa - (lo + ulp / 2)).abs()
            flips.append(torch.where(to_midpoint <= 2e-5 + 2.0 ** -17 * sa, ulp, torch.zeros((), device=x.device)))
        f_abs = torch.as_tensor(kaiser_sinc_filter1d(0.25, 0.3, 12), device=x.device).abs()
        b, c, t = se.shape
        a2 = torch.stack(flips, dim=-1).reshape(b * c, 1, 2 * t)
        bound = bound + F.conv1d(F.pad(a2, (5, 6), mode="replicate"), f_abs.view(1, 1, 12), stride=2).reshape(b, c, t)
    return bound


_fn = None  # the bound C function, argtypes set once


def _library() -> ctypes.CDLL:
    global _fn
    from indextts_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if _fn is None:
        fn = lib.indextts_anti_alias_snake_tmajor
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return lib


def fused_anti_alias_snake_tmajor(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    alpha_logscale: bool = False,
    mxu: bool = False,
    probe: Optional[str] = None,
    poly_sin: Optional[bool] = None,
) -> torch.Tensor:
    """x: [B, C, T] float32 or bf16; per-channel alpha [C] (and beta [C] for
    SnakeBeta; None is Snake). Returns [B, C, T] in x's dtype. mxu: the filter
    taps as banded products on the tensor cores (bf16; float32 input takes the
    CUDA-core body, whose float32 FMAs sum the same products: the tensor cores
    have no full float32 mode). probe="ident": the pass-through body.
    poly_sin: None takes the polynomial sin iff x is bf16; True / False force
    it."""
    global launches
    name = "fused_anti_alias_snake_tmajor"
    if probe not in (None, "ident"):
        raise ValueError(f"{name}: probe must be None or 'ident', got {probe!r} (the JAX wrapper's probe='wrapper' "
                         "times XLA ops around its kernel and has no counterpart)")
    if x.device.type == "cpu":
        return anti_alias_snake_tmajor_plain(x, alpha, beta, alpha_logscale, mxu, probe, poly_sin)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, C, T], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    b, c, t = x.shape
    for label, p in (("alpha", alpha), ("beta", beta)):
        if p is not None and (p.shape != (c,) or p.device != x.device):
            raise ValueError(f"{name}: {label} must be [{c}] on {x.device}, got {tuple(p.shape)} on {p.device}")
    a, bt = snake_parameters(alpha, beta, alpha_logscale)
    poly = x.dtype == torch.bfloat16 if poly_sin is None else bool(poly_sin)
    body = "ident" if probe == "ident" else ("mma" if mxu and x.dtype == torch.bfloat16 else "taps")
    out = torch.empty_like(x)
    if _fn is None:
        _library()
    args = (x.data_ptr(), out.data_ptr(), a.data_ptr(), bt.data_ptr(), b, c, t, _DTYPE_CODE[x.dtype], _BODY[body],
            int(poly), ctypes.addressof(_taps()))
    err = launch(_fn, x, *args)
    if err != 0:
        raise RuntimeError(f"anti_alias_snake_tmajor kernel launch failed: CUDA error {err} "
                           f"(shape {tuple(x.shape)}, body {body})")
    launches += 1
    return out
