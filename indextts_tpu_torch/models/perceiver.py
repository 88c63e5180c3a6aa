"""Perceiver resampler: variable-length conditioning -> fixed latents
(port of indextts_tpu/models/perceiver.py).

Behavioral reference: indextts/gpt/perceiver.py:224-317 — learned latents
cross-attend to the projected conditioning with the latents included in the
context, GEGLU feed-forward, RMSNorm output.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from indextts_tpu_torch.ops.activations import gelu
from indextts_tpu_torch.ops.norms import rms_norm


class PerceiverLayer(nn.Module):
    def __init__(self, dim: int, dim_inner: int, dim_ff_inner: int):
        super().__init__()
        self.to_q = nn.Linear(dim, dim_inner, bias=False)
        self.to_kv = nn.Linear(dim, dim_inner * 2, bias=False)
        self.to_out = nn.Linear(dim_inner, dim, bias=False)
        self.ff_in = nn.Linear(dim, dim_ff_inner * 2)
        self.ff_out = nn.Linear(dim_ff_inner, dim)

    def attention(self, latents, context, mask, heads: int, dim_head: int):
        """Cross-attention with the latents included in the context
        (reference: perceiver.py:277-317). mask: [B, n + ctx] bool, True = attend."""
        b, n, _ = latents.shape
        q = self.split(self.to_q(latents), heads, dim_head)
        k, v = self.to_kv(torch.cat([latents, context], dim=-2)).chunk(2, dim=-1)
        k, v = self.split(k, heads, dim_head), self.split(v, heads, dim_head)
        sim = (q @ k.transpose(-1, -2)).float() * dim_head**-0.5
        if mask is not None:
            sim = sim.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
        attn = torch.softmax(sim, dim=-1).to(latents.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, heads * dim_head)
        return self.to_out(out)

    @staticmethod
    def split(y, heads, dim_head):
        return y.reshape(y.shape[0], -1, heads, dim_head).transpose(1, 2)

    def geglu_ff(self, x):
        """Linear -> GEGLU -> Linear (reference: perceiver.py:204-221)."""
        a, gate = self.ff_in(x).chunk(2, dim=-1)
        return self.ff_out(gelu(gate) * a)


class PerceiverResampler(nn.Module):
    def __init__(
        self,
        dim: int,
        dim_context: Optional[int] = None,
        num_latents: int = 32,
        depth: int = 2,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: int = 4,
    ):
        super().__init__()
        dim_context = dim_context or dim
        self.heads = heads
        self.dim_head = dim_head
        self.latents = nn.Parameter(torch.zeros(num_latents, dim))
        self.layers = nn.ModuleList(
            PerceiverLayer(dim, dim_head * heads, int(dim * ff_mult * 2 / 3)) for _ in range(depth)
        )
        self.norm_gamma = nn.Parameter(torch.ones(dim))
        self.proj_context = nn.Linear(dim_context, dim) if dim_context != dim else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """perceiver_apply: x [B, T, dim_context]; mask [B, num_latents + T]
        key-padding mask. Returns [B, num_latents, dim]."""
        if self.proj_context is not None:
            x = self.proj_context(x)
        latents = self.latents[None].expand(x.shape[0], -1, -1).to(x.dtype)
        for layer in self.layers:
            latents = layer.attention(latents, x, mask, self.heads, self.dim_head) + latents
            latents = layer.geglu_ff(latents) + latents
        return rms_norm(latents, self.norm_gamma, scale=latents.shape[-1] ** 0.5)
