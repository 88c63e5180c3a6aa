"""ECAPA-TDNN speaker encoder (port of indextts_tpu/models/ecapa.py).

Behavioral reference: indextts/BigVGAN/ECAPA_TDNN.py:429-581 — TDNN blocks
with reflect 'same' padding, Res2Net with dilation, SE blocks, multi-layer
feature aggregation, attentive statistics pooling with global context,
eval-mode BatchNorm, and a final 1x1 conv. Tensors are channels-last
[B, T, C], as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from indextts_tpu_torch.ops.conv import conv1d, sb_same_pad
from indextts_tpu_torch.ops.norms import batch_norm_inference
from indextts_tpu_torch.weights import default_init_

# fixed architecture hyperparameters (reference: ECAPA_TDNN.py:470-484)
CHANNELS = (512, 512, 512, 512, 1536)
KERNEL_SIZES = (5, 3, 3, 3, 1)
DILATIONS = (1, 2, 3, 4, 1)
ATTENTION_CHANNELS = 128
RES2NET_SCALE = 8
SE_CHANNELS = 128


def _bn(m: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    return batch_norm_inference(x, m.weight, m.bias, m.running_mean, m.running_var)


class TDNNBlock(nn.Module):
    """conv (same, reflect) -> relu -> batchnorm (reference: ECAPA_TDNN.py:79-128)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.conv = nn.Conv1d(cin, cout, kernel_size, dilation=dilation)
        self.bn = nn.BatchNorm1d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_size > 1:
            x = sb_same_pad(x, self.kernel_size, self.dilation)
        x = torch.relu(conv1d(x, self.conv.weight, self.conv.bias, dilation=self.dilation))
        return _bn(self.bn, x)


class SERes2NetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int):
        super().__init__()
        hid = cout // RES2NET_SCALE
        self.tdnn1 = TDNNBlock(cin, cout, 1)
        self.res2net = nn.ModuleList(TDNNBlock(hid, hid, kernel_size, dilation) for _ in range(RES2NET_SCALE - 1))
        self.tdnn2 = TDNNBlock(cout, cout, 1)
        self.se_conv1 = nn.Conv1d(cout, SE_CHANNELS, 1)
        self.se_conv2 = nn.Conv1d(SE_CHANNELS, cout, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        residual = x
        h = self.tdnn1(x)
        # Res2Net split-accumulate over channel chunks (ECAPA_TDNN.py:131-191)
        chunks = h.chunk(RES2NET_SCALE, dim=-1)
        outs: List[torch.Tensor] = [chunks[0]]
        y = None
        for i in range(1, RES2NET_SCALE):
            y = self.res2net[i - 1](chunks[i] if i == 1 else chunks[i] + y)
            outs.append(y)
        h = self.tdnn2(torch.cat(outs, dim=-1))
        # squeeze-and-excitation with a masked mean (ECAPA_TDNN.py:194-242)
        total = mask.sum(dim=1, keepdim=True).clamp(min=1.0)
        s = (h * mask).sum(dim=1, keepdim=True) / total
        s = torch.relu(conv1d(s, self.se_conv1.weight, self.se_conv1.bias))
        s = torch.sigmoid(conv1d(s, self.se_conv2.weight, self.se_conv2.bias).float()).to(h.dtype)
        return s * h + residual


class ECAPA(nn.Module):
    def __init__(self, input_size: int = 100, lin_neurons: int = 512):
        super().__init__()
        self.block0 = TDNNBlock(input_size, CHANNELS[0], KERNEL_SIZES[0], DILATIONS[0])
        for i in range(1, 4):
            setattr(self, f"block{i}", SERes2NetBlock(CHANNELS[i - 1], CHANNELS[i], KERNEL_SIZES[i], DILATIONS[i]))
        self.mfa = TDNNBlock(CHANNELS[-2] * 3, CHANNELS[-1], KERNEL_SIZES[-1], DILATIONS[-1])
        self.asp_tdnn = TDNNBlock(CHANNELS[-1] * 3, ATTENTION_CHANNELS, 1)
        self.asp_conv = nn.Conv1d(ATTENTION_CHANNELS, CHANNELS[-1], 1)
        self.asp_bn = nn.BatchNorm1d(CHANNELS[-1] * 2)
        self.fc = nn.Conv1d(CHANNELS[-1] * 2, lin_neurons, 1)

    def reset_parameters(self, g: torch.Generator) -> None:
        """init_ecapa's distributions: torch default convs, identity BatchNorm."""
        default_init_(self, g)

    def _asp(self, x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
        """Attentive statistics pooling -> [B, 1, 2C] (ECAPA_TDNN.py:245-338)."""
        m = mask / mask.sum(dim=1, keepdim=True).clamp(min=1.0)
        mean = (m * x).sum(dim=1, keepdim=True)
        std = torch.sqrt(((m * (x - mean) ** 2).sum(dim=1, keepdim=True)).clamp(min=eps))
        attn_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
        attn = conv1d(torch.tanh(self.asp_tdnn(attn_in)), self.asp_conv.weight, self.asp_conv.bias)
        attn = attn.masked_fill(mask == 0, float("-inf"))
        attn = torch.softmax(attn.float(), dim=1).to(x.dtype)
        mean = (attn * x).sum(dim=1)
        std = torch.sqrt(((attn * (x - mean[:, None, :]) ** 2).sum(dim=1)).clamp(min=eps))
        return torch.cat([mean, std], dim=-1)[:, None, :]

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ecapa_apply: x [B, T, n_mels] -> speaker embedding [B, 1, lin_neurons].
        lengths: relative lengths in (0, 1] (fractions of the padded T).
        Computes in float32 whatever the weights' dtype: the masked sums over
        hundreds of frames are not exact in bf16."""
        x = x.float()
        b, t, _ = x.shape
        if lengths is None:
            mask = torch.ones(b, t, 1, dtype=torch.float32, device=x.device)
        else:
            # strict float < as the reference's length_to_mask (ECAPA_TDNN.py:16-61)
            frames = torch.arange(t, dtype=torch.float32, device=x.device)[None, :]
            mask = (frames < lengths.float().to(x.device)[:, None] * t).float()[:, :, None]
        h = self.block0(x)
        feats = []
        for i in range(1, 4):
            h = getattr(self, f"block{i}")(h, mask)
            feats.append(h)
        h = self.mfa(torch.cat(feats, dim=-1))
        h = _bn(self.asp_bn, self._asp(h, mask))
        return conv1d(h, self.fc.weight, self.fc.bias)
