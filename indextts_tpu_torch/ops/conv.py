"""1D/2D convolutions with torch semantics on channels-last tensors
(port of indextts_tpu/ops/conv.py).

The public functions keep the JAX package's layout — x is [B, T, C] or
[B, H, W, C] — so the port's modules and the parity tests compare like with
like. Weights are in torch's own layout (the weight bridge transposes the JAX
ones once): Conv1d [Cout, Cin/g, K], ConvTranspose1d [Cin, Cout/g, K],
Conv2d [Cout, Cin, Kh, Kw]. Code that runs many convolutions in a row (the
vocoder trunk) works in [B, C, T] and calls torch.nn.functional directly.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: Union[int, Tuple[int, int]] = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """x: [B, T, Cin]; weight: [Cout, Cin/groups, K] -> [B, T', Cout].
    padding: zeros on both sides, or (left, right)."""
    pl, pr = (padding, padding) if isinstance(padding, int) else padding
    xc = F.pad(x.transpose(1, 2), (pl, pr))
    b = None if bias is None else bias.to(x.dtype)
    out = F.conv1d(xc, weight.to(x.dtype), b, stride=stride, dilation=dilation, groups=groups)
    return out.transpose(1, 2)


def conv_transpose1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """torch.nn.ConvTranspose1d on x: [B, T, Cin]; weight: [Cin, Cout/groups, K].
    Output length (T-1)*stride - 2*padding + K + output_padding."""
    b = None if bias is None else bias.to(x.dtype)
    out = F.conv_transpose1d(
        x.transpose(1, 2), weight.to(x.dtype), b, stride=stride, padding=padding,
        output_padding=output_padding, groups=groups,
    )
    return out.transpose(1, 2)


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: Union[int, Tuple[int, int]] = 1,
    padding: Union[int, Tuple[int, int]] = 0,
    dilation: Union[int, Tuple[int, int]] = 1,
) -> torch.Tensor:
    """x: [B, H, W, Cin]; weight: [Cout, Cin, Kh, Kw] -> [B, H', W', Cout]."""
    b = None if bias is None else bias.to(x.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), b, stride=stride, padding=padding, dilation=dilation)
    return out.permute(0, 2, 3, 1)


def pad1d(x: torch.Tensor, pad: Tuple[int, int], mode: str = "constant", value: float = 0.0) -> torch.Tensor:
    """Pad the time axis of [B, T, C] with torch F.pad semantics
    (constant / reflect / replicate)."""
    if mode == "constant":
        return F.pad(x, (0, 0, pad[0], pad[1]), value=value)
    if mode not in ("reflect", "replicate"):
        raise ValueError(mode)
    return F.pad(x.transpose(1, 2), tuple(pad), mode=mode).transpose(1, 2)


def sb_same_pad(x: torch.Tensor, kernel_size: int, dilation: int, mode: str = "reflect") -> torch.Tensor:
    """SpeechBrain Conv1d 'same' padding (reference: nnet/CNN.py:430-446):
    symmetric dilation*(kernel-1)//2 pads, reflect by default."""
    total = dilation * (kernel_size - 1)
    return pad1d(x, (total // 2, total - total // 2), mode=mode)


def weight_norm_fold(weight_v, weight_g):
    """Fold torch weight_norm (g * v/||v||, norm over all dims except dim=0)
    at conversion time, in numpy, as the reference folds at load with
    remove_weight_norm(). Torch layout [Cout, ...]; the norm is accumulated in
    float64 and the result keeps v's dtype."""
    import numpy as np

    v = np.asarray(weight_v)
    g = np.asarray(weight_g)
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
    return (g * (v / norm)).astype(v.dtype)
