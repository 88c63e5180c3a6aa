"""Autoregressive decode for UnifiedVoice: prefill plus a KV-cached loop
(port of indextts_tpu/models/gpt_decode.py, greedy and sampled, num_beams == 1,
with the bf16 / float32 or the int8 KV cache).

  * prepare_gpt_inputs builds the left-padded [pad][cond][text][start]
    embedding layout and key mask of model.py:591-654.
  * The prefill runs the whole GPT-2 stack once and fills a static KV cache
    [L, B, H, S, Dh] of length S = prefill + max_new_tokens. The decode loop
    writes each token's K/V into that cache in place (the JAX loop returns a
    new cache each step) and stops early when every row has emitted
    stop_mel_token.
  * With quant_kv the cache is int8 (k8, ks, v8, vs): k8 / v8 [L, B, H, S,
    Dh] int8 and one float32 scale per head PAIR and position, ks / vs [L,
    B, H/2, S]. The JAX cache is head-paired ([.., H/2, S, 2*Dh], a TPU lane
    layout the port does not carry), and its scale is the amax of a paired
    column, i.e. over both heads 2g and 2g+1; a per-head scale would be a
    different quantizer. The new token attends to its own exact K / V and is
    quantized into the cache afterwards, as in JAX _decode_block_q.
  * The mel positional off-by-one of the reference inference model
    (model.py:151-155: generated token t takes mel position t+1) is kept:
    pos_off=2.

Not ported yet (see ROADMAP.md): beams, segmented decoding, latent capture
(fast_latents) and forced input_tokens prefixes. The JAX monolithic driver
is the contract: its segmented driver is pinned bit-exact to it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models.gpt import NEG, GPT2Block, UnifiedVoice, _ln, gpt2_apply
from indextts_tpu_torch.ops.norms import layer_norm
from indextts_tpu_torch.ops.sampling import greedy_token, process_logits, sample_token


@dataclass(frozen=True)
class GenerationConfig:
    """Decode settings that change the loop's structure."""

    do_sample: bool = True
    top_k: int = 30
    max_new_tokens: int = 600


@dataclass
class DecodeState:
    """The loop state: step i, codes [B, max_new] (stop-filled), the cache
    (k, v) [L, B, H, S, Dh] or, int8, (k8, ks, v8, vs), done [B], seen [B, V]
    for the repetition penalty, and the last token cur [B]. Updated in place
    by decode_steps."""

    i: int
    codes: torch.Tensor
    cache: Tuple[torch.Tensor, ...]
    done: torch.Tensor
    seen: torch.Tensor
    cur: torch.Tensor


@dataclass
class DecodeContext:
    """What the loop needs besides the state: the prefill length p, the
    prefill key mask padded to the cache length, and the sampling settings."""

    p: int
    prefill_valid: torch.Tensor
    gen: GenerationConfig
    generator: torch.Generator
    temperature: float
    top_p: float
    repetition_penalty: float

    def sample(self, logits: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
        lf = process_logits(
            logits, seen_mask=seen, repetition_penalty=self.repetition_penalty,
            temperature=self.temperature, top_k=self.gen.top_k if self.gen.do_sample else 0,
            top_p=self.top_p, do_sample=self.gen.do_sample,
        )
        if self.gen.do_sample:
            return sample_token(lf, self.generator)
        return greedy_token(lf)


def prepare_gpt_inputs(
    model: UnifiedVoice,
    cfg: GPTConfig,
    conds: torch.Tensor,
    text_tokens: torch.Tensor,
    text_lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill embeddings + key mask (reference: model.py:591-654).

    conds: [B, C, D]; text_tokens: [B, L] right-padded with stop_text_token;
    text_lengths: [B] true token counts. Returns (emb [B, P, D], mask [B, P]
    bool) with P = C + L + 2 + 1; each row is left-padded (zero embeddings,
    mask False) so that its start_mel token sits last."""
    b, l = text_tokens.shape
    c = conds.shape[1]
    dev = text_tokens.device
    full_text = torch.cat(
        [text_tokens.new_full((b, 1), cfg.start_text_token), text_tokens,
         text_tokens.new_full((b, 1), cfg.stop_text_token)], dim=1,
    )
    full_text = torch.where(
        torch.arange(l + 2, device=dev)[None, :] > text_lengths[:, None],
        torch.full_like(full_text, cfg.stop_text_token), full_text,
    )
    text_emb = model.text_embedding[full_text] + model.text_pos_embedding[: l + 2][None]
    seq = torch.cat([conds.to(text_emb.dtype), text_emb], dim=1)  # [B, C+L+2, D]
    core = c + l + 2
    src = torch.arange(core, device=dev)[None, :] - (l - text_lengths)[:, None]
    gathered = torch.gather(seq, 1, src.clamp(0, core - 1)[..., None].expand(-1, -1, seq.shape[-1]))
    emb_core = torch.where((src >= 0)[..., None], gathered, torch.zeros((), dtype=seq.dtype, device=dev))
    start_emb = model.mel_embedding[cfg.start_mel_token] + model.mel_pos_embedding[0]
    emb = torch.cat([emb_core, start_emb.to(emb_core.dtype).expand(b, 1, -1)], dim=1)
    mask = torch.cat([src >= 0, torch.ones(b, 1, dtype=torch.bool, device=dev)], dim=1)
    return emb, mask


def _mel_logits(model: UnifiedVoice, hidden: torch.Tensor) -> torch.Tensor:
    """lm_head = final_norm -> mel_head (reference: model.py:48)."""
    h = layer_norm(hidden, model.final_norm.weight, model.final_norm.bias)
    return model.mel_head(h)


def _prefill(model: UnifiedVoice, cfg: GPTConfig, emb: torch.Tensor, mask: torch.Tensor, cache_len: int,
             quant_kv: bool = False):
    """Run the stack over the prompt; returns last-position logits [B, V] and
    the cache, zero past the prompt: (k, v), each [L, B, H, cache_len, Dh],
    or with quant_kv (k8, ks, v8, vs), quantized after the full-precision
    prefill attention; the pad columns' scales are zero (the attention bias
    masks those columns)."""
    hidden, (k, v) = gpt2_apply(model.gpt, emb, cfg.heads, attention_mask=mask, return_kv=True)
    pad = cache_len - k.shape[3]
    if quant_kv:
        (k8, ks), (v8, vs) = _quant_cols(k), _quant_cols(v)
        pad8, pads = (0, 0, 0, pad), (0, pad)
        cache = tuple(torch.nn.functional.pad(t, pad8 if t.dim() == 5 else pads) for t in (k8, ks, v8, vs))
    else:
        cache = tuple(torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    return _mel_logits(model, hidden[:, -1]), cache


def _quant_cols(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 of a cache t [..., H, S, Dh] with one scale per head
    pair and position: the amax runs over heads 2g and 2g+1 together, the
    column of JAX's head-paired cache (gpt_decode.py:326-336). Returns (q
    [..., H, S, Dh] int8, s [..., H/2, S] float32), t ~ q * s."""
    *lead, h, s_len, dh = t.shape
    tf = t.float().reshape(*lead, h // 2, 2, s_len, dh)
    amax = tf.abs().amax(dim=(-3, -1))
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(tf / s[..., None, :, None]), -127, 127).to(torch.int8)
    return q.reshape(t.shape), s


def _decode_block_q(block: GPT2Block, x: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor, v8: torch.Tensor,
                    vs: torch.Tensor, pos: int, bias: torch.Tensor, heads: int) -> torch.Tensor:
    """GPT2Block.step against the int8 cache of one layer: k8 / v8 [B, H, S,
    Dh], ks / vs [B, H/2, S]. `bias` [B, 1, S] masks slot `pos`: the new
    token's exact K / V enter the softmax as an extra logit, and are then
    quantized into slot `pos` in place. Dequantization in JAX's order
    (_decode_block_q): scores contract in x's dtype and then take ks in
    float32; the attention weights take vs in float32 before the cast."""
    b, d = x.shape
    dh = d // heads
    q, k, v = (y.reshape(b, heads, dh) for y in block.attn_qkv(_ln(block.ln_1, x)).split(d, dim=-1))
    scale = 1.0 / math.sqrt(dh)
    ksh, vsh = ks.repeat_interleave(2, dim=1), vs.repeat_interleave(2, dim=1)  # [B, H, S]
    s = (q[:, :, None] @ k8.to(x.dtype).transpose(-1, -2))[:, :, 0].float()
    scores = torch.cat([s * ksh * scale + bias, (q * k).sum(-1, keepdim=True).float() * scale], dim=-1)
    attn = torch.softmax(scores, dim=-1)
    a2 = (attn[..., :-1] * vsh).to(x.dtype)
    a = (a2[:, :, None] @ v8.to(x.dtype))[:, :, 0] + attn[..., -1:].to(x.dtype) * v
    for cache8, cache_s, new in ((k8, ks, k), (v8, vs, v)):
        q8, qs = _quant_cols(new[:, :, None])
        cache8[:, :, pos] = q8[:, :, 0]
        cache_s[:, :, pos] = qs[:, :, 0]
    return block._mlp(x + block.attn_proj(a.reshape(b, d)))


def _decode_step(model: UnifiedVoice, cfg: GPTConfig, token: torch.Tensor, mel_pos: int, cache, pos: int,
                 valid: torch.Tensor) -> torch.Tensor:
    """One step: token [B] at mel position `mel_pos`, its K/V written into
    cache slot `pos` (in place). valid: [B, S] bool, the cache slots already
    written that the token attends, `pos` excluded (JAX's base_mask). The
    cache is (k, v) or int8 (k8, ks, v8, vs). Returns logits [B, V]."""
    x = model.mel_embedding[token] + model.mel_pos_embedding[mel_pos]
    bias = torch.where(valid, torch.zeros((), device=x.device), NEG)[:, None, :]  # [B, 1, S]
    for layer, block in enumerate(model.gpt.blocks):
        caches = [c[layer] for c in cache]
        if len(cache) == 4:
            x = _decode_block_q(block, x, *caches, pos, bias, cfg.heads)
        else:
            x = block.step(x, *caches, pos, bias, cfg.heads)
    x = layer_norm(x, model.gpt.ln_f.weight, model.gpt.ln_f.bias)
    return _mel_logits(model, x)


def prefill_decode_state(
    model: UnifiedVoice,
    cfg: GPTConfig,
    gen: GenerationConfig,
    conds: torch.Tensor,
    text_tokens: torch.Tensor,
    text_lengths: torch.Tensor,
    generator: torch.Generator,
    temperature: float = 1.0,
    top_p: float = 0.8,
    repetition_penalty: float = 10.0,
    quant_kv: bool = False,
) -> Tuple[DecodeState, DecodeContext]:
    """Prefill + first token. Returns the loop state and its context; the
    cache is int8 with quant_kv."""
    b = text_tokens.shape[0]
    dev = text_tokens.device
    emb, prefill_mask = prepare_gpt_inputs(model, cfg, conds, text_tokens, text_lengths)
    p = emb.shape[1]
    max_new = gen.max_new_tokens
    s_max = p + max_new
    logits0, cache = _prefill(model, cfg, emb, prefill_mask, s_max, quant_kv=quant_kv)
    # HF penalizes over the whole input_ids row: the fake inputs are 1s with
    # a trailing start_mel (model.py:645-653), so ids {1, start_mel} start seen
    seen = torch.zeros(b, cfg.number_mel_codes, dtype=torch.bool, device=dev)
    seen[:, 1] = True
    seen[:, cfg.start_mel_token] = True
    ctx = DecodeContext(
        p=p, prefill_valid=torch.nn.functional.pad(prefill_mask, (0, s_max - p)), gen=gen,
        generator=generator, temperature=float(temperature), top_p=float(top_p),
        repetition_penalty=float(repetition_penalty),
    )
    tok1 = ctx.sample(logits0, seen)
    codes = torch.full((b, max_new), cfg.stop_mel_token, dtype=torch.long, device=dev)
    codes[:, 0] = tok1
    seen[torch.arange(b, device=dev), tok1] = True
    state = DecodeState(i=0, codes=codes, cache=cache, done=tok1 == cfg.stop_mel_token, seen=seen, cur=tok1)
    return state, ctx


def decode_steps(model: UnifiedVoice, cfg: GPTConfig, state: DecodeState, ctx: DecodeContext, n_steps: int,
                 pos_off: int = 2) -> DecodeState:
    """Run up to `n_steps` decode iterations, stopping early when every row
    has emitted stop_mel_token or the code buffer is full. Token g_{i+1} is
    decoded at cache slot p+i and mel position i+pos_off."""
    max_new = state.codes.shape[1]
    positions = torch.arange(ctx.prefill_valid.shape[1], device=state.codes.device)[None, :]
    stop = state.i + n_steps
    rows = torch.arange(state.codes.shape[0], device=state.codes.device)
    while state.i < max_new - 1 and state.i < stop and not bool(state.done.all()):
        i = state.i
        write_pos = ctx.p + i
        valid = ctx.prefill_valid | ((positions >= ctx.p) & (positions < write_pos))
        logits = _decode_step(model, cfg, state.cur, i + pos_off, state.cache, write_pos, valid)
        nxt = ctx.sample(logits, state.seen)
        nxt = torch.where(state.done, torch.full_like(nxt, cfg.stop_mel_token), nxt)
        state.codes[:, i + 1] = nxt
        state.done |= nxt == cfg.stop_mel_token
        state.seen[rows, nxt] = True
        state.cur = nxt
        state.i = i + 1
    return state


@torch.no_grad()
def generate_speech(
    model: UnifiedVoice,
    cfg: GPTConfig,
    gen: GenerationConfig,
    conds: torch.Tensor,
    text_tokens: torch.Tensor,
    text_lengths: torch.Tensor,
    generator: torch.Generator,
    temperature: float = 1.0,
    top_p: float = 0.8,
    repetition_penalty: float = 10.0,
    pos_off: int = 2,
    quant_kv: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy / sampled generation (num_beams == 1). Returns (codes [B,
    max_new_tokens] right-padded with stop_mel_token, lengths [B] counting
    tokens up to and including the stop token), as HF generate() with
    eos = pad = stop_mel_token (model.py:698-703). The loop runs
    max(lengths) - 1 decode steps. quant_kv: the int8 KV cache."""
    state, ctx = prefill_decode_state(
        model, cfg, gen, conds, text_tokens, text_lengths, generator,
        temperature=temperature, top_p=top_p, repetition_penalty=repetition_penalty, quant_kv=quant_kv,
    )
    max_new = gen.max_new_tokens
    state = decode_steps(model, cfg, state, ctx, max_new - 1, pos_off=pos_off)
    is_stop = state.codes == cfg.stop_mel_token
    first_stop = torch.argmax(is_stop.int(), dim=1)
    lengths = torch.where(is_stop.any(dim=1), first_stop + 1, torch.full_like(first_stop, max_new))
    return state.codes, lengths
