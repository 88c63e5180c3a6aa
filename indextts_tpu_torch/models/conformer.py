"""Conformer conditioning encoder (port of indextts_tpu/models/conformer.py).

Behavioral reference: indextts/gpt/conformer_encoder.py (wenet-style conformer
over the prompt mel) with Transformer-XL relative-position attention (u/v
biases, rel_shift disabled, attention.py:300-310), sinusoidal PE with sqrt(d)
input scaling, and the conv2d2 subsampling input layer that IndexTTS-1.5 uses.
Inference only: no dropout, no macaron, normalize_before, conv kernel 15, SiLU.

Submodule and parameter names follow the JAX parameter tree so the weight
bridge (weights.py) maps one onto the other by name. Tensors are
channels-last [B, T, C], as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from indextts_tpu_torch.config import ConditionModuleConfig
from indextts_tpu_torch.ops.conv import conv1d, conv2d
from indextts_tpu_torch.ops.norms import layer_norm


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """PositionalEncoding table (reference: embedding.py:47-54)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def _ln(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, m.weight, m.bias)


class Conv2dSubsampling2(nn.Module):
    """conv2d2 input layer: one 3x3 stride-2 conv over (time, mel), then a
    linear projection (reference: subsampling.py)."""

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.conv0 = nn.Conv2d(1, odim, 3)
        self.out = nn.Linear(odim * ((idim - 1) // 2), odim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, idim]; mask: [B, 1, T] bool (True = valid)."""
        h = torch.relu(conv2d(x[..., None], self.conv0.weight, self.conv0.bias, stride=2))  # [B, T', F', C]
        b, t, f, c = h.shape
        h = h.permute(0, 1, 3, 2).reshape(b, t, c * f)
        return self.out(h), mask[:, :, 2::2]


class RelPositionMultiHeadedAttention(nn.Module):
    def __init__(self, heads: int, d_model: int):
        super().__init__()
        d_k = d_model // heads
        self.heads = heads
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d_k))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """rel_mha_apply: x [B, T, D]; pos_emb [1, T, D]; mask [B, 1, T] bool."""
        b, t, d = x.shape
        h = self.heads
        d_k = d // h

        def split_heads(y):
            return y.reshape(y.shape[0], -1, h, d_k).transpose(1, 2)  # [B, H, T, dk]

        q = split_heads(self.linear_q(x))
        k = split_heads(self.linear_k(x))
        v = split_heads(self.linear_v(x))
        pmat = split_heads(self.linear_pos(pos_emb))  # [1, H, T, dk]
        q_u = q + self.pos_bias_u.to(q.dtype)[None, :, None, :]
        q_v = q + self.pos_bias_v.to(q.dtype)[None, :, None, :]
        scores = (q_u @ k.transpose(-1, -2) + q_v @ pmat.transpose(-1, -2)) / math.sqrt(d_k)
        key_invalid = ~mask[:, 0, :][:, None, None, :]  # [B, 1, 1, T]
        scores = scores.masked_fill(key_invalid, float("-inf"))
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype).masked_fill(key_invalid, 0.0)
        out = (attn @ v).transpose(1, 2).reshape(b, t, d)
        return self.linear_out(out)


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel: int = 15):
        super().__init__()
        self.kernel = kernel
        self.pw1 = nn.Conv1d(channels, 2 * channels, 1)
        self.dw = nn.Conv1d(channels, channels, kernel, groups=channels)
        self.ln = nn.LayerNorm(channels)
        self.pw2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor, mask_pad: torch.Tensor) -> torch.Tensor:
        """conv_module_apply: GLU pointwise -> depthwise -> LayerNorm+SiLU ->
        pointwise, zeroing padded frames before and after
        (reference: conformer_encoder.py:112-167)."""
        valid = mask_pad[:, 0, :, None]  # [B, T, 1]
        x = x.masked_fill(~valid, 0.0)
        x = F.glu(conv1d(x, self.pw1.weight, self.pw1.bias), dim=-1)
        c = x.shape[-1]
        x = conv1d(x, self.dw.weight, self.dw.bias, padding=(self.kernel - 1) // 2, groups=c)
        x = F.silu(_ln(self.ln, x))
        x = conv1d(x, self.pw2.weight, self.pw2.bias)
        return x.masked_fill(~valid, 0.0)


class ConformerLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, linear_units: int, cnn_kernel: int = 15):
        super().__init__()
        self.attn = RelPositionMultiHeadedAttention(heads, d_model)
        self.ff = nn.ModuleDict({"w1": nn.Linear(d_model, linear_units), "w2": nn.Linear(linear_units, d_model)})
        self.conv = ConvolutionModule(d_model, cnn_kernel)
        self.norm_mha = nn.LayerNorm(d_model)
        self.norm_ff = nn.LayerNorm(d_model)
        self.norm_conv = nn.LayerNorm(d_model)
        self.norm_final = nn.LayerNorm(d_model)

    def forward(self, x, pos_emb, mask):
        """normalize_before, no macaron (reference: conformer_encoder.py:232-313)."""
        x = x + self.attn(_ln(self.norm_mha, x), pos_emb, mask)
        x = x + self.conv(_ln(self.norm_conv, x), mask)
        h = _ln(self.norm_ff, x)
        x = x + self.ff.w2(F.silu(self.ff.w1(h)))
        return _ln(self.norm_final, x)


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: ConditionModuleConfig, input_size: int = 100):
        super().__init__()
        if cfg.input_layer != "conv2d2" or cfg.pos_enc_layer_type != "rel_pos":
            raise NotImplementedError(
                f"the port has the conv2d2 / rel_pos conformer only (IndexTTS-1.5's), got "
                f"input_layer={cfg.input_layer!r}, pos_enc_layer_type={cfg.pos_enc_layer_type!r}"
            )
        self.cfg = cfg
        self.embed = Conv2dSubsampling2(input_size, cfg.output_size)
        self.layers = nn.ModuleList(
            ConformerLayer(cfg.output_size, cfg.attention_heads, cfg.linear_units) for _ in range(cfg.num_blocks)
        )
        self.after_norm = nn.LayerNorm(cfg.output_size)
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(5000, cfg.output_size)))

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """conformer_apply: xs [B, T, input_size]; xs_lens [B] frame lengths.
        Returns (encoded [B, T', D], mask [B, 1, T'] bool True=valid)
        (reference: conformer_encoder.py:400-436)."""
        t = xs.shape[1]
        masks = (torch.arange(t, device=xs.device)[None, :] < xs_lens.to(xs.device)[:, None])[:, None, :]
        xs, masks = self.embed(xs, masks)
        pos_emb = self.pe[None, : xs.shape[1]].to(xs.dtype)
        xs = xs * math.sqrt(self.cfg.output_size)
        for layer in self.layers:
            xs = layer(xs, pos_emb, masks)
        return _ln(self.after_norm, xs), masks
