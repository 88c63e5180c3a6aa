"""Anti-aliased resampling and activation, composed from torch convolutions
(port of indextts_tpu/ops/antialias.py, composed path only).

Activation1d of the reference (alias_free_torch/act.py:9-28): 2x upsample by a
Kaiser-windowed-sinc transposed depthwise conv, pointwise snake, then 2x
low-pass depthwise downsample, with the replicate edge pads of
resample.py:10-48 (5 up, cropped 15/15; 5/6 down). This composed path is the
plain version of the fused kernel K1 (ops/cuda/antialias.py) and its oracle.

The work happens in torch's [B, C, T] layout (activation1d);
anti_aliased_activation keeps the JAX signature on [B, T, C].
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from indextts_tpu_torch.ops.activations import snake_beta


def kaiser_beta(half_size: int, half_width: float) -> float:
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


@lru_cache(maxsize=16)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Normalized kaiser-windowed sinc lowpass, length `kernel_size` [K]."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    beta = kaiser_beta(half_size, half_width)
    window = np.kaiser(kernel_size, beta)  # == torch.kaiser_window(periodic=False)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


@lru_cache(maxsize=64)
def _filter_tensor(ratio: int, kernel_size: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The resampling filter on `device`, made once (a captured vocoder call
    copies nothing from the host)."""
    return torch.as_tensor(kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size), dtype=dtype, device=device)


def _depthwise_filter(x: torch.Tensor, ratio: int, kernel_size: int) -> torch.Tensor:
    """The resampling filter as a depthwise weight [C, 1, K] in x's dtype."""
    w = _filter_tensor(ratio, kernel_size, x.dtype, x.device)
    return w.view(1, 1, -1).expand(x.shape[1], 1, kernel_size)


def upsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: Optional[int] = None) -> torch.Tensor:
    """[B, C, T] -> [B, C, T*ratio] anti-aliased upsample (resample.py:10-33)."""
    kernel_size = kernel_size or int(6 * ratio // 2) * 2
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    xp = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(xp, _depthwise_filter(x, ratio, kernel_size), stride=ratio, groups=x.shape[1])
    return y[..., pad_left : y.shape[-1] - pad_right]


def downsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: Optional[int] = None) -> torch.Tensor:
    """[B, C, T] -> [B, C, T//ratio] lowpass + decimate (resample.py:36-48)."""
    kernel_size = kernel_size or int(6 * ratio // 2) * 2
    even = kernel_size % 2 == 0
    pad_left = kernel_size // 2 - int(even)
    pad_right = kernel_size // 2
    xp = F.pad(x, (pad_left, pad_right), mode="replicate")
    return F.conv1d(xp, _depthwise_filter(x, ratio, kernel_size), stride=ratio, groups=x.shape[1])


def activation1d(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    alpha_logscale: bool = False,
    approx_sin_: Optional[bool] = None,
) -> torch.Tensor:
    """upsample -> snake(/beta) -> downsample on x [B, C, T]; alpha/beta [C].
    approx_sin_ as in snake_beta (None: the polynomial sin iff x is bf16)."""
    y = upsample1d(x)
    y = snake_beta(y, alpha[:, None], None if beta is None else beta[:, None], alpha_logscale, approx_sin_)
    return downsample1d(y)


def anti_aliased_activation(
    x: torch.Tensor,
    alpha: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    alpha_logscale: bool = False,
    approx_sin_: Optional[bool] = None,
) -> torch.Tensor:
    """activation1d on the JAX layout: x [B, T, C] -> [B, T, C]."""
    return activation1d(x.transpose(1, 2), alpha, beta, alpha_logscale, approx_sin_).transpose(1, 2)
