"""Conformer conditioning encoder (port of indextts_tpu/models/conformer.py).

Behavioral reference: indextts/gpt/conformer_encoder.py (wenet-style conformer
over the prompt mel) with sinusoidal PE and sqrt(d) input scaling, and the
input layers of subsampling.py: linear, conv2d2 (IndexTTS-1.5's), conv2d,
conv2d6 and conv2d8. Position encodings: rel_pos, Transformer-XL
relative-position attention with u/v biases and rel_shift disabled
(attention.py:300-310); abs_pos, the table added to the input and plain
multi-head attention; no_pos, plain attention and no table. Inference only:
no dropout, no macaron, normalize_before, conv kernel 15, SiLU.

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


# (kernel, stride) of each 3x3 / 5x5 conv of the conv input layers, over
# (time, mel); the key mask keeps frames kernel-1, kernel-1+stride, ... of
# each conv's input (reference: subsampling.py)
CONV_INPUT_LAYERS = {
    "conv2d2": ((3, 2),),
    "conv2d": ((3, 2), (3, 2)),
    "conv2d6": ((3, 2), (5, 3)),
    "conv2d8": ((3, 2), (3, 2), (3, 2)),
}


class Conv2dSubsampling(nn.Module):
    """A conv input layer: ReLU convs conv0, conv1, ... over (time, mel),
    then a linear projection of the flattened (channel, mel) features."""

    def __init__(self, kind: str, idim: int, odim: int):
        super().__init__()
        self.convs = CONV_INPUT_LAYERS[kind]
        f, cin = idim, 1
        for i, (k, s) in enumerate(self.convs):
            setattr(self, f"conv{i}", nn.Conv2d(cin, odim, k))
            f, cin = (f - k) // s + 1, odim
        self.out = nn.Linear(odim * f, odim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, idim]; mask: [B, 1, T] bool (True = valid)."""
        h = x[..., None]
        for i, (k, s) in enumerate(self.convs):
            conv = getattr(self, f"conv{i}")
            h = torch.relu(conv2d(h, conv.weight, conv.bias, stride=s))  # [B, T', F', C]
            mask = mask[:, :, k - 1 :: s]
        b, t, f, c = h.shape
        h = h.permute(0, 1, 3, 2).reshape(b, t, c * f)
        return self.out(h), mask


class LinearSubsampling(nn.Module):
    """The linear input layer: Linear, then LayerNorm; no subsampling."""

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.out = nn.Linear(idim, odim)
        self.ln = nn.LayerNorm(odim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return _ln(self.ln, self.out(x)), mask


def _mha_core(q, k, v, mask: torch.Tensor, scores_extra=None) -> torch.Tensor:
    """Masked softmax attention of q, k, v [B, H, T, dk]: keys outside the
    mask [B, 1, T] score -inf and their weights are zeroed after the float32
    softmax. Returns [B, T, H * dk]."""
    b, h, t, d_k = q.shape
    scores = q @ k.transpose(-1, -2)
    if scores_extra is not None:
        scores = scores + scores_extra
    scores = scores / math.sqrt(d_k)
    key_invalid = ~mask[:, 0, :][:, None, None, :]  # [B, 1, 1, T]
    scores = scores.masked_fill(key_invalid, float("-inf"))
    attn = torch.softmax(scores.float(), dim=-1).to(q.dtype).masked_fill(key_invalid, 0.0)
    return (attn @ v).transpose(1, 2).reshape(b, t, h * d_k)


def _split_heads(y: torch.Tensor, h: int) -> torch.Tensor:
    return y.reshape(y.shape[0], -1, h, y.shape[-1] // h).transpose(1, 2)  # [B, H, T, dk]


class MultiHeadedAttention(nn.Module):
    """Absolute-position (plain) multi-head attention, for abs_pos and
    no_pos (reference: attention.py:26-186)."""

    def __init__(self, heads: int, d_model: int):
        super().__init__()
        self.heads = heads
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """plain_mha_apply: x [B, T, D]; mask [B, 1, T] bool."""
        q, k, v = (_split_heads(lin(x), self.heads) for lin in (self.linear_q, self.linear_k, self.linear_v))
        return self.linear_out(_mha_core(q, k, v, mask))


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
        h = self.heads
        q, k, v = (_split_heads(lin(x), h) for lin in (self.linear_q, self.linear_k, self.linear_v))
        pmat = _split_heads(self.linear_pos(pos_emb), h)  # [1, H, T, dk]
        q_u = q + self.pos_bias_u.to(q.dtype)[None, :, None, :]
        q_v = q + self.pos_bias_v.to(q.dtype)[None, :, None, :]
        return self.linear_out(_mha_core(q_u, k, v, mask, scores_extra=q_v @ pmat.transpose(-1, -2)))


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
    def __init__(self, d_model: int, heads: int, linear_units: int, cnn_kernel: int = 15, rel_pos: bool = True):
        super().__init__()
        self.rel_pos = rel_pos
        self.attn = RelPositionMultiHeadedAttention(heads, d_model) if rel_pos else MultiHeadedAttention(heads, d_model)
        self.ff = nn.ModuleDict({"w1": nn.Linear(d_model, linear_units), "w2": nn.Linear(linear_units, d_model)})
        self.conv = ConvolutionModule(d_model, cnn_kernel)
        self.norm_mha = nn.LayerNorm(d_model)
        self.norm_ff = nn.LayerNorm(d_model)
        self.norm_conv = nn.LayerNorm(d_model)
        self.norm_final = nn.LayerNorm(d_model)

    def forward(self, x, pos_emb, mask):
        """normalize_before, no macaron (reference: conformer_encoder.py:232-313)."""
        h = _ln(self.norm_mha, x)
        x = x + (self.attn(h, pos_emb, mask) if self.rel_pos else self.attn(h, mask))
        x = x + self.conv(_ln(self.norm_conv, x), mask)
        h = _ln(self.norm_ff, x)
        x = x + self.ff.w2(F.silu(self.ff.w1(h)))
        return _ln(self.norm_final, x)


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: ConditionModuleConfig, input_size: int = 100):
        super().__init__()
        self.cfg = cfg
        if cfg.input_layer == "linear":
            self.embed = LinearSubsampling(input_size, cfg.output_size)
        elif cfg.input_layer in CONV_INPUT_LAYERS:
            self.embed = Conv2dSubsampling(cfg.input_layer, input_size, cfg.output_size)
        else:
            raise ValueError(f"unsupported input_layer: {cfg.input_layer}")
        rel = cfg.pos_enc_layer_type == "rel_pos"
        self.layers = nn.ModuleList(
            ConformerLayer(cfg.output_size, cfg.attention_heads, cfg.linear_units, rel_pos=rel)
            for _ in range(cfg.num_blocks)
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
        pos_type = self.cfg.pos_enc_layer_type
        if pos_type == "abs_pos":  # the table added to the input (embedding.py:57-75)
            xs = xs * math.sqrt(self.cfg.output_size) + pos_emb
        elif pos_type == "rel_pos":  # scaled input, the table to the attention (embedding.py:129-143)
            xs = xs * math.sqrt(self.cfg.output_size)
        for layer in self.layers:  # no_pos: the input as it is
            xs = layer(xs, pos_emb, masks)
        return _ln(self.after_norm, xs), masks
