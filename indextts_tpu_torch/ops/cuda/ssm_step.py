"""K7: one Mamba-2 decode step of one layer, a CUDA kernel written for Hopper
(csrc/ssm_step.cu), and its plain PyTorch version.

Replaces no TPU kernel: the JAX package runs no state-space layer. The
hybrid decoder (models/granite.py) runs it once a Mamba layer a decode step,
in every decode loop, eager and replayed: from the in_proj output of one
token per row, [z | x, B, C | dt], it shifts the layer's conv state, takes
the depthwise causal convolution and SiLU of x, B and C, then per head
dt = softplus(dt + dt_bias), h = exp(dt A) h + dt x B^T, y = h C + D x, and
returns the gated y * silu(z) in float32 (the gated RMSNorm over all heads
follows in the caller). The conv state (the last d_conv - 1 inputs, in the
model's dtype) and the SSM state ([B, heads, head_dim, d_state] float32) are
read and written in place.

`ssm_step` takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch
import torch.nn.functional as F

from indextts_tpu_torch.ops.cuda.common import _cached, launch

SOURCE = "ssm_step.cu"

# kernel launches in this process; one per launch, nowhere else
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (head_dim, d_state) of the kernel's instances: the tiny test models' and granite-4.0-h's
_SHAPES = ((16, 16), (64, 128))

# per device: one int32 counter a row, the kernel's last-block election (zero between launches);
# a captured step keeps reading the buffer it was captured with, so a buffer outgrown is kept
_counters: Dict[torch.device, torch.Tensor] = {}
_outgrown: List[torch.Tensor] = []


def ssm_step_plain(zxbcdt: torch.Tensor, conv_state: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                   dt_bias: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor, state: torch.Tensor,
                   heads: int, head_dim: int, d_state: int) -> torch.Tensor:
    """K7's function in plain PyTorch, in float32. zxbcdt [B, 2 DI + 2 N + H]
    (DI = heads x head_dim, N = d_state): z, then the conv channels x, B, C,
    then dt; conv_state [B, DI + 2 N, K - 1] in zxbcdt's dtype; conv_w [DI +
    2 N, 1, K], conv_b [DI + 2 N]; dt_bias, a_log, d_skip [heads]; state [B,
    heads, head_dim, d_state] float32. Writes both states; returns y * silu(z)
    [B, DI] float32."""
    b = zxbcdt.shape[0]
    di, cd = heads * head_dim, heads * head_dim + 2 * d_state
    z, xbc, dt = zxbcdt.float().split([di, cd, heads], dim=-1)
    win = torch.cat([conv_state.float(), xbc[:, :, None]], dim=-1)  # [B, C, K]
    conv_state.copy_(win[:, :, 1:].to(conv_state.dtype))
    xc = F.silu((win * conv_w.float().reshape(cd, -1)).sum(-1) + conv_b.float())
    xs, bm, cm = xc.split([di, d_state, d_state], dim=-1)
    dt = F.softplus(dt + dt_bias.float())  # [B, H]
    da = torch.exp(dt * -torch.exp(a_log.float()))
    xs = xs.reshape(b, heads, head_dim)
    state.mul_(da[:, :, None, None]).add_((dt[:, :, None] * xs)[..., None] * bm[:, None, None, :])
    y = (state * cm[:, None, None, :]).sum(-1) + d_skip.float()[:, None] * xs
    return (y * F.silu(z.reshape(b, heads, head_dim))).reshape(b, di)


_fn = None  # the bound C function, argtypes set once


def _library() -> ctypes.CDLL:
    global _fn
    from indextts_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if _fn is None:
        fn = lib.indextts_ssm_step
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return lib


def _params(dt_bias: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor):
    """dt_bias, A = -exp(A_log) and D as the kernel reads them: float32,
    contiguous; made once per parameter (ops/cuda/common._cached)."""
    return (_cached(dt_bias, "f32", lambda t: t.float().contiguous()),
            _cached(a_log, "neg_exp", lambda t: (-torch.exp(t.float())).contiguous()),
            _cached(d_skip, "f32", lambda t: t.float().contiguous()))


def ssm_step(zxbcdt: torch.Tensor, conv_state: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
             dt_bias: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor, state: torch.Tensor,
             heads: int, head_dim: int, d_state: int) -> torch.Tensor:
    """One Mamba-2 decode step of one layer: ssm_step_plain's function, in
    one launch on a CUDA tensor. zxbcdt [B, 2 DI + 2 N + H] float32 or bf16
    with its last dimension contiguous (rows may be apart, as a slice's);
    conv_state [B, DI + 2 N, K - 1] in its dtype and state [B, H, P, N]
    float32, both contiguous, written in place; conv_w [DI + 2 N, 1, K] and
    conv_b in its dtype. Returns y * silu(z) [B, DI] float32."""
    global launches
    if zxbcdt.device.type == "cpu":
        return ssm_step_plain(zxbcdt, conv_state, conv_w, conv_b, dt_bias, a_log, d_skip, state, heads, head_dim,
                              d_state)
    if zxbcdt.device.type != "cuda":
        raise ValueError(f"ssm_step: unsupported device {zxbcdt.device}")
    if zxbcdt.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssm_step: zxbcdt must be float32 or bfloat16, got {zxbcdt.dtype}")
    if (head_dim, d_state) not in _SHAPES:
        raise ValueError(f"ssm_step: (head_dim, d_state) = ({head_dim}, {d_state}) is not one of {_SHAPES}")
    b = zxbcdt.shape[0]
    di, cd = heads * head_dim, heads * head_dim + 2 * d_state
    k = conv_w.shape[-1]
    if zxbcdt.dim() != 2 or zxbcdt.shape[1] != di + cd + heads or zxbcdt.stride(1) != 1:
        raise ValueError(f"ssm_step: zxbcdt must be [B, {di + cd + heads}] with contiguous rows, got "
                         f"{tuple(zxbcdt.shape)} strides {zxbcdt.stride()}")
    for name, t, shape, dtype in (("conv_state", conv_state, (b, cd, k - 1), zxbcdt.dtype),
                                  ("conv_w", conv_w, (cd, 1, k), zxbcdt.dtype), ("conv_b", conv_b, (cd,), zxbcdt.dtype),
                                  ("state", state, (b, heads, head_dim, d_state), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != zxbcdt.device or not t.is_contiguous():
            raise ValueError(f"ssm_step: {name} must be contiguous {dtype} {shape} on {zxbcdt.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if state.data_ptr() % 16:
        raise ValueError("ssm_step: state must start on a 16-byte boundary")
    dtb, a, dsk = _params(dt_bias, a_log, d_skip)
    counter = _counters.get(zxbcdt.device)
    if counter is None or counter.numel() < b:
        if counter is not None:
            _outgrown.append(counter)
        counter = _counters[zxbcdt.device] = torch.zeros(max(b, 1024), dtype=torch.int32, device=zxbcdt.device)
    out = torch.empty(b, di, dtype=torch.float32, device=zxbcdt.device)
    if _fn is None:
        _library()
    err = launch(_fn, zxbcdt, zxbcdt.data_ptr(), zxbcdt.stride(0), conv_state.data_ptr(), conv_w.data_ptr(),
                 conv_b.data_ptr(), dtb.data_ptr(), a.data_ptr(), dsk.data_ptr(), state.data_ptr(), out.data_ptr(),
                 counter.data_ptr(), b, heads, head_dim, d_state, k, _DTYPE_CODE[zxbcdt.dtype])
    if err != 0:
        raise RuntimeError(f"ssm_step kernel launch failed: CUDA error {err} (zxbcdt {tuple(zxbcdt.shape)} "
                           f"{zxbcdt.dtype}, state {tuple(state.shape)})")
    launches += 1
    return out
