"""Tortoise-style attention blocks of the legacy conditioning encoder
(port of indextts_tpu/models/attention_block.py).

Behavioral reference: indextts/utils/arch_util.py:41-120 (AttentionBlock /
QKVAttentionLegacy with GroupNorm32 and a zero-initialized output
projection) and indextts/utils/xtransformers.py:146-186 (RelativePositionBias).
Used by UnifiedVoice's `condition_type` "perceiver" and "default"
(model.py:210-234, 344-360).

Tensors are channels-last [B, T, C]. The qkv / out projections are 1x1 convs
in the reference and [Cin, Cout] matrices in the JAX package; here they are
nn.Linear, which the weight bridge fills transposed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from indextts_tpu_torch.ops.norms import group_norm
from indextts_tpu_torch.weights import default_init_, normal_


def norm_groups(channels: int) -> int:
    """GroupNorm group count heuristic (reference: arch_util.py:22-37)."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups = int(groups / 2)
    if groups <= 2:
        raise ValueError(f"no GroupNorm group count above 2 divides {channels} channels")
    return groups


def _relative_position_bucket(relative_position: torch.Tensor, causal: bool, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5 bucket of each key - query distance (xtransformers.py:160-177):
    exact up to num_buckets / 2 (per sign when not causal), then
    logarithmic up to max_distance."""
    ret = 0
    n = -relative_position
    if not causal:
        num_buckets //= 2
        ret = (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9) / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).long()
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_if_large)


class RelativePositionBias(nn.Module):
    def __init__(self, heads: int, num_buckets: int = 32):
        super().__init__()
        self.emb = nn.Parameter(torch.zeros(num_buckets, heads))

    def forward(self, qlen: int, klen: int, scale: float = 1.0, causal: bool = False,
                max_distance: int = 64) -> torch.Tensor:
        """relative_position_bias: the additive bias [heads, qlen, klen]."""
        dev = self.emb.device
        rel = torch.arange(klen, device=dev)[None, :] - torch.arange(qlen, device=dev)[:, None]
        buckets = _relative_position_bucket(rel, causal, self.emb.shape[0], max_distance)
        return self.emb[buckets].permute(2, 0, 1) * scale


class AttentionBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int = 1, relative_pos_embeddings: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(norm_groups(channels), channels)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj_out = nn.Linear(channels, channels)
        self.rel_pos = RelativePositionBias(num_heads) if relative_pos_embeddings else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """attention_block_apply: x [B, T, C] -> [B, T, C] with the residual
        (arch_util.py:115-120). QKVAttentionLegacy semantics (:40-75): qkv
        split as contiguous (q, k, v) per head, q and k each scaled by
        1/sqrt(sqrt(ch)), the relative bias times sqrt(ch) added before the
        float32 softmax, and `mask` [B, T] applied multiplicatively after it."""
        b, t, c = x.shape
        ch = c // self.num_heads
        h = group_norm(x, self.norm.weight, self.norm.bias, self.norm.num_groups)
        qkv = self.qkv(h).reshape(b, t, self.num_heads, 3 * ch).transpose(1, 2)  # [B, H, T, 3ch]
        q, k, v = qkv.split(ch, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        w = ((q * scale) @ (k * scale).transpose(-1, -2)).float()
        if self.rel_pos is not None:
            w = w + self.rel_pos(t, t, scale=ch**0.5)
        w = torch.softmax(w, dim=-1).to(x.dtype)
        if mask is not None:
            w = w * mask[:, None, None, :].to(w.dtype)
        a = (w @ v).transpose(1, 2).reshape(b, t, c)
        return x + self.proj_out(a)


class ConditioningEncoder(nn.Module):
    """A 1x1 conv of the mel to the model width, then a stack of
    AttentionBlocks (reference: model.py:210-234)."""

    def __init__(self, spec_dim: int, embedding_dim: int, attn_blocks: int = 6, num_attn_heads: int = 4):
        super().__init__()
        self.num_heads = num_attn_heads
        self.init = nn.Linear(spec_dim, embedding_dim)
        self.attn = nn.ModuleList(AttentionBlock(embedding_dim, num_attn_heads) for _ in range(attn_blocks))

    def forward(self, x: torch.Tensor, mean: bool = False) -> torch.Tensor:
        """conditioning_encoder_apply: mel [B, T, spec_dim] -> [B, T, emb],
        or [B, emb] averaged over time when `mean`."""
        h = self.init(x)
        for blk in self.attn:
            h = blk(h)
        return h.mean(dim=1) if mean else h

    def reset_parameters(self, g: torch.Generator) -> None:
        """init_conditioning_encoder's distributions: the 1x1 input conv
        U(+-1/sqrt(spec_dim)) with a zero bias; each block's qkv
        U(+-1/sqrt(C)), its GroupNorm the identity and its output projection
        zero (zero_module, arch_util.py:10-16), so a fresh block is the
        identity; a relative bias N(0, 0.02^2)."""
        default_init_(self, g)
        nn.init.zeros_(self.init.bias)
        for blk in self.attn:
            nn.init.zeros_(blk.proj_out.weight)
            nn.init.zeros_(blk.proj_out.bias)
            if blk.rel_pos is not None:
                normal_(blk.rel_pos.emb, 0.02, g)
