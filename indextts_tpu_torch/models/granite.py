"""granite-4.0-h's hybrid stack as UnifiedVoice's speech decoder.

The layer equations of HF's GraniteMoeHybrid with no experts
(https://huggingface.co/ibm-granite/granite-4.0-h-micro): every layer is a
pre-norm mixer, a Mamba-2 layer or a NoPE grouped-query attention layer as
`cfg.layer_types` orders them, and a pre-norm SwiGLU MLP, each added to the
residual times `residual_multiplier`; RMSNorm everywhere; the input is
multiplied by `embedding_multiplier` (here the whole embedded sequence:
conditioning latents, text and mel embeddings with their learned positions),
and the stack ends in its own RMSNorm. The attention's softmax scale is
`attention_multiplier`. UnifiedVoice's final LayerNorm and heads follow in
models/gpt.py, which divides the logits by `logits_scaling`.

Mamba-2 (one B / C group): in_proj gives [z | x, B, C | dt]; x, B and C go
through a depthwise causal convolution of width d_conv and SiLU; per head,
dt = softplus(dt + dt_bias), A = -exp(A_log), h_t = exp(dt A) h_{t-1} +
dt x_t B_t^T, y_t = h_t C_t + D x_t; then the gated RMSNorm over all of
d_inner, norm(y * silu(z)), and out_proj.

Two kinds of decode state live side by side. The attention layers keep a
KV cache of their KV heads, bf16 / float32 (k, v) [La, B, Hkv, S, Dh] or
int8 (k8, ks, v8, vs), as the GPT-2 stack's; the Mamba layers keep a conv
state [Lm, B, d_inner + 2 N, d_conv - 1] in the model's dtype (the last
inputs of x, B, C) and an SSM state [Lm, B, heads, head_dim, N] in float32,
which has no sequence axis. A hybrid cache is the tuple of the KV tensors
followed by (conv, ssm) (`split_cache`).

The full-sequence pass (prefill, the teacher-forced latent pass) runs the
scan in chunks of `mamba_chunk_size` (the SSD algorithm: within a chunk the
quadratic form, between chunks the state) in float32 and returns each Mamba
layer's final conv and SSM state. Masked positions (a prompt's left padding)
feed nothing: x, B and C are zeroed before and after the convolution, and dt
after the softplus, so a row's states are those of its first real token on.
The decode step runs each Mamba layer through K7 (ops/cuda/ssm_step.py) and
each attention layer through K6 with its GQA group and scale.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from indextts_tpu_torch import tracing
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.ops.cuda.decode_attn import decode_attn
from indextts_tpu_torch.ops.cuda.ssm_step import ssm_step
from indextts_tpu_torch.weights import normal_

NEG = torch.finfo(torch.float32).min


def split_cache(cache: Sequence[torch.Tensor]) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """(KV tensors, state tensors) of a decode cache: the KV cache, (k, v) or
    int8 (k8, ks, v8, vs), then a hybrid stack's (conv, ssm) states (none for
    GPT-2's)."""
    n = 4 if cache[0].dtype == torch.int8 else 2
    return tuple(cache[:n]), tuple(cache[n:])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """GraniteMoeHybridRMSNorm: in float32, then the weight times the result
    in x's dtype."""
    xf = x.float()
    return w * (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))


class _Layer(nn.Module):
    """What both kinds of layer share: the two pre-norms and the SwiGLU MLP."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        d = cfg.model_dim
        self.cfg = cfg
        self.norm_1 = RMSNorm(d)
        self.norm_2 = RMSNorm(d)
        self.mlp_in = nn.Linear(d, 2 * cfg.intermediate_size, bias=False)
        self.mlp_out = nn.Linear(cfg.intermediate_size, d, bias=False)

    def _norm(self, m: RMSNorm, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, m.weight, self.cfg.rms_norm_eps)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        """x + r * mlp_out(silu(gate) * up) of norm_2(x)."""
        gate, up = self.mlp_in(self._norm(self.norm_2, x)).chunk(2, dim=-1)
        return x + self.mlp_out(F.silu(gate) * up) * self.cfg.residual_multiplier


class MambaLayer(_Layer):
    kind = "mamba"

    def __init__(self, cfg: GPTConfig):
        super().__init__(cfg)
        h, n, di, cd = cfg.mamba_heads, cfg.mamba_d_state, cfg.d_inner, cfg.conv_dim
        self.in_proj = nn.Linear(cfg.model_dim, di + cd + h, bias=False)
        self.conv1d = nn.Conv1d(cd, cd, cfg.mamba_d_conv, groups=cd, bias=True)
        self.dt_bias = nn.Parameter(torch.ones(h))
        self.A_log = nn.Parameter(torch.zeros(h))
        self.D = nn.Parameter(torch.ones(h))
        self.norm = RMSNorm(di)  # the gated RMSNorm over d_inner
        self.out_proj = nn.Linear(di, cfg.model_dim, bias=False)

    def _out(self, x: torch.Tensor, gated: torch.Tensor) -> torch.Tensor:
        """x + r * out_proj(norm(y * silu(z))), from the float32 y * silu(z);
        then the MLP."""
        g = gated * torch.rsqrt(gated.pow(2).mean(-1, keepdim=True) + self.cfg.rms_norm_eps)
        y = self.out_proj(self.norm.weight * g.to(x.dtype))
        return self._mlp(x + y * self.cfg.residual_multiplier)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        """Full sequence x [B, T, D], mask [B, T] bool (None: all valid) ->
        (out, (conv state [B, C, K - 1], SSM state [B, H, P, N]))."""
        cfg = self.cfg
        b, t, _ = x.shape
        h, p, n, di, cd, k = (cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_d_state, cfg.d_inner, cfg.conv_dim,
                              cfg.mamba_d_conv)
        z, xbc, dt = self.in_proj(self._norm(self.norm_1, x)).split([di, cd, h], dim=-1)
        keep = None if mask is None else mask[..., None].float()
        xbc = xbc.float() if keep is None else xbc.float() * keep
        padded = F.pad(xbc.transpose(1, 2), (k - 1, 0))  # [B, C, K - 1 + T]
        conv_state = padded[:, :, -(k - 1):].to(x.dtype)
        xc = F.silu(F.conv1d(padded, self.conv1d.weight.float(), self.conv1d.bias.float(), groups=cd)).transpose(1, 2)
        dt = F.softplus(dt.float() + self.dt_bias.float())
        if keep is not None:
            xc, dt = xc * keep, dt * keep
        xs, bm, cm = xc.split([di, n, n], dim=-1)
        xs = xs.reshape(b, t, h, p)
        a = -torch.exp(self.A_log.float())
        y, state = ssd_scan(xs, dt, a, bm, cm, cfg.mamba_chunk_size)
        y = (y + self.D.float()[:, None] * xs).reshape(b, t, di)
        return self._out(x, y * F.silu(z.float())), (conv_state, state)

    def step(self, x: torch.Tensor, conv_state: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        """One token x [B, D] through the layer, its states [B, C, K - 1] and
        [B, H, P, N] advanced in place (K7)."""
        cfg = self.cfg
        zx = self.in_proj(self._norm(self.norm_1, x))
        gated = ssm_step(zx, conv_state, self.conv1d.weight, self.conv1d.bias, self.dt_bias, self.A_log, self.D, state,
                         cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_d_state)
        return self._out(x, gated)


class AttentionLayer(_Layer):
    kind = "attention"

    def __init__(self, cfg: GPTConfig):
        super().__init__(cfg)
        d, dh = cfg.model_dim, cfg.head_dim
        self.attn_qkv = nn.Linear(d, (cfg.heads + 2 * cfg.n_kv_heads) * dh, bias=False)
        self.attn_proj = nn.Linear(cfg.heads * dh, d, bias=False)
        self.scale = 1.0 / math.sqrt(dh) if cfg.attention_multiplier is None else float(cfg.attention_multiplier)

    def qkv(self, x: torch.Tensor):
        """q [..., H, Dh], k, v [..., Hkv, Dh] of x [..., D]: views of one
        projection, so they share its stride."""
        cfg = self.cfg
        dh = cfg.head_dim
        y = self.attn_qkv(self._norm(self.norm_1, x))
        q, k, v = y.split([cfg.heads * dh, cfg.n_kv_heads * dh, cfg.n_kv_heads * dh], dim=-1)
        return (t.unflatten(-1, (-1, dh)) for t in (q, k, v))

    def _proj(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        return self._mlp(x + self.attn_proj(a) * self.cfg.residual_multiplier)

    def forward(self, x: torch.Tensor, bias: torch.Tensor):
        """Full sequence x [B, T, D] -> (out, (k, v) each [B, Hkv, T, Dh])."""
        b, t, _ = x.shape
        q, k, v = (y.transpose(1, 2) for y in self.qkv(x))
        g = self.cfg.heads // self.cfg.n_kv_heads
        scores = (q @ k.repeat_interleave(g, dim=1).transpose(-1, -2)) * self.scale
        attn = torch.softmax(scores.float() + bias, dim=-1).to(q.dtype)
        a = (attn @ v.repeat_interleave(g, dim=1)).transpose(1, 2).reshape(b, t, -1)
        return self._proj(x, a), (k, v)

    def step(self, x: torch.Tensor, cache: Sequence[torch.Tensor], pos: Union[int, torch.Tensor],
             bias: torch.Tensor) -> torch.Tensor:
        """One token x [B, D] against the layer's cache ((k, v) [B, Hkv, S,
        Dh] or int8), its K / V written into column `pos` (K6)."""
        q, k, v = self.qkv(x)
        return self._proj(x, decode_attn(q, k, v, cache, pos, bias, self.scale))


class GraniteHybrid(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(MambaLayer(cfg) if t == "mamba" else AttentionLayer(cfg) for t in cfg.layer_types)
        self.norm = RMSNorm(cfg.model_dim)

    def forward(self, emb: torch.Tensor, attention_mask: Optional[torch.Tensor] = None, return_state: bool = False):
        """The stack over embeddings [B, T, D] (multiplied by
        embedding_multiplier here). attention_mask [B, T], 1 = a real token:
        attention masks the other keys, the Mamba layers skip those
        positions. With return_state also returns the decode cache ((k, v)
        [La, B, Hkv, T, Dh] each, conv [Lm, B, C, K - 1], ssm [Lm, B, H, P,
        N])."""
        cfg = self.cfg
        t = emb.shape[1]
        causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=emb.device))
        zero = torch.zeros((), device=emb.device)
        bias = torch.where(causal, zero, NEG)[None, None]
        mask = None
        if attention_mask is not None:
            mask = attention_mask.bool()
            bias = bias + torch.where(mask, zero, NEG)[:, None, None, :]
        x = emb * cfg.embedding_multiplier
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        convs: List[torch.Tensor] = []
        ssms: List[torch.Tensor] = []
        for blk in self.blocks:
            if blk.kind == "mamba":
                x, (conv, ssm) = blk(x, mask)
                convs.append(conv)
                ssms.append(ssm)
            else:
                x, (k, v) = blk(x, bias)
                ks.append(k)
                vs.append(v)
        x = rms_norm(x, self.norm.weight, cfg.rms_norm_eps)
        if not return_state:
            return x
        return x, (torch.stack(ks), torch.stack(vs), torch.stack(convs), torch.stack(ssms))

    def step(self, x: torch.Tensor, cache: Sequence[torch.Tensor], pos: Union[int, torch.Tensor],
             bias: torch.Tensor) -> torch.Tensor:
        """One token's embedding x [B, D] through the stack against the decode
        cache (KV tensors, then conv and ssm; split_cache), every state
        written in place; returns the final-norm hidden [B, D]."""
        kv, (conv, ssm) = split_cache(cache)
        x = x * self.cfg.embedding_multiplier
        ia = im = 0
        for blk in self.blocks:
            if blk.kind == "mamba":
                x = blk.step(x, conv[im], ssm[im])
                im += 1
            else:
                x = blk.step(x, [c[ia] for c in kv], pos, bias)
                ia += 1
        return rms_norm(x, self.norm.weight, self.cfg.rms_norm_eps)

    def reset_parameters(self, g: torch.Generator) -> None:
        """The published init: matrices N(0, 0.02) (out_proj, attn_proj and
        mlp_out at 0.02 / sqrt(2 x layers)), norms 1, the convolution as
        torch's default, A = -uniform[1, 16], dt drawn log-uniform in [0.001,
        0.1] and dt_bias its softplus inverse, D = 1."""
        cfg = self.cfg
        proj = 0.02 / math.sqrt(2 * cfg.layers)
        for blk in self.blocks:
            mats = [(blk.mlp_in, 0.02), (blk.mlp_out, proj)]
            if blk.kind == "mamba":
                mats += [(blk.in_proj, 0.02), (blk.out_proj, proj)]
                h = cfg.mamba_heads
                u = torch.rand(h, generator=g, device=g.device)
                blk.A_log.data.copy_(torch.log(1.0 + 15.0 * u))
                u = torch.rand(h, generator=g, device=g.device)
                dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
                blk.dt_bias.data.copy_(dt + torch.log(-torch.expm1(-dt)))
                nn.init.ones_(blk.D)
                nn.init.ones_(blk.norm.weight)
            else:
                mats += [(blk.attn_qkv, 0.02), (blk.attn_proj, proj)]
            for lin, std in mats:
                normal_(lin.weight, std, g)
            nn.init.ones_(blk.norm_1.weight)
            nn.init.ones_(blk.norm_2.weight)
        nn.init.ones_(self.norm.weight)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
             chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSM of every head over a whole sequence, in chunks of `chunk`
    positions (float32): x [B, T, H, P], dt [B, T, H], a = A [H], bm, cm
    [B, T, N]. Returns (y [B, T, H, P] without the D x term, the final state
    [B, H, P, N]). Within a chunk the quadratic form, y_t = sum_{s <= t}
    (C_t . B_s) exp(sum_{s < r <= t} dt_r A) dt_s x_s; across chunks the
    state each chunk leaves, decayed and read through C. A span ssm.scan
    (rows, tokens, chunks); none inside a CUDA-graph capture."""
    b, t, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, t)
    nc = -(-t // q)
    capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
    with contextlib.nullcontext() if capturing else tracing.span("ssm.scan", rows=b, tokens=t, chunks=nc):
        pad = nc * q - t
        if pad:  # zero dt and x: the padded positions neither decay nor feed the state
            x, dt, bm, cm = (F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad)) for v in (x, dt, bm, cm))
        x, dt = x.reshape(b, nc, q, h, p), dt.reshape(b, nc, q, h)
        bm, cm = bm.reshape(b, nc, q, n), cm.reshape(b, nc, q, n)
        acs = torch.cumsum(dt * a, dim=2)  # [B, c, Q, H]
        causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
        seg = (acs[:, :, :, None, :] - acs[:, :, None, :, :]).masked_fill(~causal[:, :, None], -math.inf)
        xdt = x * dt[..., None]
        w = torch.einsum("bctn,bcsn->bcts", cm, bm)[..., None] * torch.exp(seg)  # [B, c, t, s, H]
        y = torch.einsum("bctsh,bcshp->bcthp", w, xdt)
        to_end = torch.exp(acs[:, :, -1:, :] - acs)  # [B, c, Q, H]
        ends = torch.einsum("bcsn,bcsh,bcshp->bchpn", bm, to_end, xdt)  # each chunk's own contribution
        state = ends[:, 0]
        for c in range(1, nc):
            y[:, c] += torch.einsum("btn,bhpn,bth->bthp", cm[:, c], state, torch.exp(acs[:, c]))
            state = torch.exp(acs[:, c, -1])[:, :, None, None] * state + ends[:, c]
        return y.reshape(b, nc * q, h, p)[:, :t], state
