"""UnifiedVoice: the autoregressive speech-token LM
(port of indextts_tpu/models/gpt.py, the conformer_perceiver model).

Behavioral reference: indextts/gpt/model.py:300-589 — text/mel embeddings with
learned per-modality positional tables, a GPT-2 core whose own wte/wpe are
unused, conformer + perceiver conditioning, and the teacher-forced pass that
returns the vocoder latents. The GPT blocks are an nn.ModuleList run by a
Python loop (the JAX package stacks them for lax.scan; the weight bridge
unstacks them).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models.conformer import ConformerEncoder
from indextts_tpu_torch.models.perceiver import PerceiverResampler
from indextts_tpu_torch.ops.activations import gelu_new
from indextts_tpu_torch.ops.norms import layer_norm
from indextts_tpu_torch.weights import default_init_, normal_, uniform_

NEG = torch.finfo(torch.float32).min


def _ln(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, m.weight, m.bias)


def _attn(q, k, v, bias):
    """q: [B, H, Tq, Dh]; k/v: [B, H, Tk, Dh]; bias: additive f32, broadcast
    to [B, H, Tq, Tk]."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    attn = torch.softmax(scores.float() + bias, dim=-1).to(q.dtype)
    return attn @ v


class GPT2Block(nn.Module):
    """One GPT-2 block; weights as HF Conv1D, y = x @ W + b. The four
    linears may be ops/quant.QuantLinear (quantize_gpt_blocks)."""

    def __init__(self, d: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d)
        self.attn_qkv = nn.Linear(d, 3 * d)
        self.attn_proj = nn.Linear(d, d)
        self.ln_2 = nn.LayerNorm(d)
        self.mlp_fc = nn.Linear(d, 4 * d)
        self.mlp_proj = nn.Linear(4 * d, d)

    def _mlp(self, x):
        return x + self.mlp_proj(gelu_new(self.mlp_fc(_ln(self.ln_2, x))))

    def forward(self, x: torch.Tensor, bias: torch.Tensor, heads: int):
        """Full sequence x [B, T, D] -> (out, (k, v) each [B, H, T, Dh])."""
        b, t, d = x.shape
        q, k, v = (
            y.reshape(b, t, heads, d // heads).transpose(1, 2)
            for y in self.attn_qkv(_ln(self.ln_1, x)).split(d, dim=-1)
        )
        a = _attn(q, k, v, bias).transpose(1, 2).reshape(b, t, d)
        return self._mlp(x + self.attn_proj(a)), (k, v)

    def step(self, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
             bias: torch.Tensor, heads: int) -> torch.Tensor:
        """One new token x [B, D] against the caches [B, H, S, Dh]. `bias`
        [B, 1, S] masks slot `pos`: the token's own K/V enter the softmax as
        an extra logit, as in JAX _decode_block, and are then written into
        slot `pos` of the caches in place."""
        b, d = x.shape
        dh = d // heads
        q, k, v = (y.reshape(b, heads, dh) for y in self.attn_qkv(_ln(self.ln_1, x)).split(d, dim=-1))
        scale = 1.0 / math.sqrt(dh)
        s = (q[:, :, None] @ k_cache.transpose(-1, -2))[:, :, 0].float()
        scores = torch.cat([s * scale + bias, (q * k).sum(-1, keepdim=True).float() * scale], dim=-1)
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        a = (attn[:, :, None, :-1] @ v_cache)[:, :, 0] + attn[..., -1:] * v
        k_cache[:, :, pos] = k
        v_cache[:, :, pos] = v
        return self._mlp(x + self.attn_proj(a.reshape(b, d)))


class GPT2(nn.Module):
    def __init__(self, layers: int, d: int):
        super().__init__()
        self.blocks = nn.ModuleList(GPT2Block(d) for _ in range(layers))
        self.ln_f = nn.LayerNorm(d)


def gpt2_apply(gpt: GPT2, emb: torch.Tensor, heads: int, attention_mask: Optional[torch.Tensor] = None,
               return_kv: bool = False):
    """GPT-2 stack over [B, T, D] embeddings. attention_mask: [B, T], 1 =
    attend. With return_kv also returns (k, v), each [L, B, H, T, Dh]."""
    t = emb.shape[1]
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=emb.device))
    zero = torch.zeros((), device=emb.device)
    bias = torch.where(causal, zero, NEG)[None, None]
    if attention_mask is not None:
        bias = bias + torch.where(attention_mask.bool(), zero, NEG)[:, None, None, :]
    x = emb
    ks, vs = [], []
    for block in gpt.blocks:
        x, (k, v) = block(x, bias, heads)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = _ln(gpt.ln_f, x)
    return (x, (torch.stack(ks), torch.stack(vs))) if return_kv else x


class UnifiedVoice(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        if cfg.condition_type != "conformer_perceiver":
            raise NotImplementedError(
                f"condition_type={cfg.condition_type!r}: the port has IndexTTS-1.5's conformer_perceiver only"
            )
        self.cfg = cfg
        d = cfg.model_dim
        n_text = cfg.number_text_tokens * cfg.types + 1
        self.text_embedding = nn.Parameter(torch.zeros(n_text, d))
        self.mel_embedding = nn.Parameter(torch.zeros(cfg.number_mel_codes, d))
        self.text_pos_embedding = nn.Parameter(torch.zeros(cfg.max_text_seq_len, d))
        self.mel_pos_embedding = nn.Parameter(torch.zeros(cfg.max_mel_seq_len, d))
        self.gpt = GPT2(cfg.layers, d)
        self.final_norm = nn.LayerNorm(d)
        self.text_head = nn.Linear(d, n_text)
        self.mel_head = nn.Linear(d, cfg.number_mel_codes)
        cm = cfg.condition_module
        self.conditioning_encoder = ConformerEncoder(cm, input_size=100)
        self.perceiver_encoder = PerceiverResampler(
            dim=d, dim_context=cm.output_size, num_latents=cfg.condition_num_latent,
            heads=cm.attention_heads, ff_mult=cm.perceiver_mult,
        )

    def reset_parameters(self, g: torch.Generator) -> None:
        """init_unified_voice's distributions: GPT-2 normal(0.02) with the
        residual projections at 0.02/sqrt(2*layers), zero biases; torch
        default uniform for the conditioning encoders; xavier pos biases."""
        default_init_(self, g)
        for p in (self.text_embedding, self.mel_embedding, self.text_pos_embedding, self.mel_pos_embedding):
            normal_(p, 0.02, g)
        proj_std = 0.02 / math.sqrt(2 * self.cfg.layers)
        for blk in self.gpt.blocks:
            for lin, std in ((blk.attn_qkv, 0.02), (blk.attn_proj, proj_std), (blk.mlp_fc, 0.02),
                             (blk.mlp_proj, proj_std)):
                normal_(lin.weight, std, g)
                nn.init.zeros_(lin.bias)
        for head in (self.text_head, self.mel_head):
            normal_(head.weight, 0.02, g)
            nn.init.zeros_(head.bias)
        for layer in self.conditioning_encoder.layers:
            h, d_k = layer.attn.pos_bias_u.shape
            for p in (layer.attn.pos_bias_u, layer.attn.pos_bias_v):
                uniform_(p, math.sqrt(6.0 / (h + d_k)), g)
        normal_(self.perceiver_encoder.latents, 0.02, g)
        nn.init.ones_(self.perceiver_encoder.norm_gamma)


def get_conditioning(model: UnifiedVoice, cfg: GPTConfig, speech_conditioning_mel: torch.Tensor,
                     cond_mel_lengths: torch.Tensor) -> torch.Tensor:
    """Prompt mel [B, frames, 100] -> conditioning latents [B, latents, D]
    (reference: model.py:490-519, conformer_perceiver branch)."""
    enc, mask = model.conditioning_encoder(speech_conditioning_mel, cond_mel_lengths)
    ones = torch.ones(enc.shape[0], cfg.condition_num_latent, dtype=torch.bool, device=enc.device)
    return model.perceiver_encoder(enc, torch.cat([ones, mask[:, 0, :]], dim=1))


def set_padding(tokens: torch.Tensor, lengths: torch.Tensor, pad_value: int) -> torch.Tensor:
    """Replace positions >= length with pad_value (reference: model.py:434-460)."""
    idx = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    return torch.where(idx >= lengths[:, None], torch.full_like(tokens, pad_value), tokens)


def _frame(tokens: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """[start, tokens..., stop]: the inputs of build_aligned_inputs_and_targets
    after the trailing stop pad (model.py:561-566)."""
    b = tokens.shape[0]
    return torch.cat([tokens.new_full((b, 1), start), tokens, tokens.new_full((b, 1), stop)], dim=1)


def unified_voice_forward(
    model: UnifiedVoice,
    cfg: GPTConfig,
    text_inputs: torch.Tensor,
    text_lengths: torch.Tensor,
    mel_codes: torch.Tensor,
    wav_lengths: torch.Tensor,
    conds: torch.Tensor,
) -> torch.Tensor:
    """Teacher-forced pass returning the vocoder latents [B, T_mel, D]
    (reference: model.py:521-589 with return_latent=True), with the keys that
    exist only because of shape bucketing masked — the JAX
    unified_voice_forward(return_latent=True, mask_pad_keys=True) the engine
    runs. `conds` are precomputed conditioning latents."""
    mel_code_lengths = (wav_lengths + cfg.mel_length_compression - 1) // cfg.mel_length_compression + 1
    mel_codes = set_padding(mel_codes, mel_code_lengths, cfg.stop_mel_token)
    text_inputs = set_padding(text_inputs, text_lengths, cfg.stop_text_token)
    text_in = _frame(text_inputs, cfg.start_text_token, cfg.stop_text_token)
    mel_in = _frame(mel_codes, cfg.start_mel_token, cfg.stop_mel_token)
    text_emb = model.text_embedding[text_in] + model.text_pos_embedding[: text_in.shape[1]][None]
    mel_emb = model.mel_embedding[mel_in] + model.mel_pos_embedding[: mel_in.shape[1]][None]
    emb = torch.cat([conds.to(text_emb.dtype), text_emb, mel_emb], dim=1)
    b, dev = emb.shape[0], emb.device
    # valid keys: all conds; text [start, t_0..t_{len-1}, stop] = len+2; mel
    # [start, c_0.., stop] = mel_code_len+1 — the rest is bucket padding
    text_ok = torch.arange(text_in.shape[1], device=dev)[None, :] < (text_lengths + 2)[:, None]
    mel_ok = torch.arange(mel_in.shape[1], device=dev)[None, :] < (mel_code_lengths + 1)[:, None]
    mask = torch.cat([torch.ones(b, conds.shape[1], dtype=torch.bool, device=dev), text_ok, mel_ok], dim=1)
    hidden = gpt2_apply(model.gpt, emb, cfg.heads, attention_mask=mask)
    enc = _ln(model.final_norm, hidden[:, conds.shape[1]:])
    # the mel block, without the two trailing frames this forward adds (model.py:576-578)
    return enc[:, -mel_emb.shape[1]:][:, :-2]
