"""Normalization functions (port of indextts_tpu/ops/norms.py).

All compute in float32 and return the input dtype, as the JAX versions do.
Tensors are channels-last: the normalized axis is the last one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    out = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(), eps)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, gamma: Optional[torch.Tensor], scale: float, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(x, dim=-1) * scale * gamma (torch eps clamps the norm)."""
    out = F.normalize(x.float(), dim=-1, eps=eps) * scale
    if gamma is not None:
        out = out * gamma.float()
    return out.to(x.dtype)


def batch_norm_inference(x, gamma, beta, running_mean, running_var, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm1d over the channel axis of [..., C]."""
    inv = torch.rsqrt(running_var.float() + eps)
    out = (x.float() - running_mean.float()) * inv * gamma.float() + beta.float()
    return out.to(x.dtype)
