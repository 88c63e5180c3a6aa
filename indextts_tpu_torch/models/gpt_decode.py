"""Autoregressive decode for UnifiedVoice: prefill plus a KV-cached loop
(port of indextts_tpu/models/gpt_decode.py: greedy, sampled and beam search,
typical sampling, latent capture, with the bf16 / float32 or the int8 KV
cache, monolithic or with a cache that grows by segments).

  * prepare_gpt_inputs builds the left-padded [pad][cond][text][start]
    embedding layout and key mask of model.py:591-654.
  * The prefill runs the whole GPT-2 stack once and fills a static KV cache
    [L, B, H, S, Dh] of length S = prefill + max_new_tokens. The decode loop
    writes each token's K/V into that cache in place (the JAX loop returns a
    new cache each step) and stops early when every row has emitted
    stop_mel_token. A granite hybrid stack (models/granite.py) keeps the KV
    cache of its attention layers and, after it in the cache tuple, its
    Mamba layers' conv and SSM states, which have no sequence axis: they are
    never grown or padded, only written per row (the prefill, a slot's
    admission, every step) or reordered with the beams.
  * With quant_kv the cache is int8 (k8, ks, v8, vs): k8 / v8 [L, B, H, S,
    Dh] int8 and one float32 scale per head PAIR and position, ks / vs [L,
    B, H/2, S]. The JAX cache is head-paired ([.., H/2, S, 2*Dh], a TPU lane
    layout the port does not carry), and its scale is the amax of a paired
    column, i.e. over both heads 2g and 2g+1; a per-head scale would be a
    different quantizer. The new token attends to its own exact K / V and is
    quantized into the cache afterwards, as in JAX _decode_block_q.
  * The mel positional off-by-one of the reference inference model
    (model.py:151-155: generated token t takes mel position t+1) is kept:
    pos_off=2. With capture_latents the loop also keeps the final-norm
    hidden that predicted each code (the vocoder's latent); pos_off=1, the
    teacher-forced pass's positions, makes them equal to that pass.
  * generate_speech_beam is HF beam_search / beam_sample with JAX's
    admissible early stop. The beams' cache is the plain GPU form: [L, B*nb,
    H, S, Dh], its rows reordered with index_select after every step (the
    JAX package resolves beam lineage inside attention instead, to avoid a
    TPU relayout). The beam helpers (_beam_joint_scores, _select_successors,
    _beam_stop_bound_base, _beam_step, _beam_finalize) are one set, and
    _BeamLoop is the one loop built on them, shared by generate_speech_beam
    and generate_speech_beam_segmented.
  * The segmented loops (generate_speech_segmented,
    generate_speech_beam_segmented) start with a cache of p + segment slots
    and grow it by `segment` between runs of steps (grow_cache), so a
    step's attention reads the slots written so far and not the whole
    max_new_tokens budget. They give the monolithic loops' codes; the cache
    length of a segment is part of the key of its captured step (graphs.py),
    as it is of the JAX functions' jit_cache. They take no forced prefix, as
    in JAX.
  * Each loop runs one step function whose every write is in place and
    indexed by a device step counter, with every dynamic knob a [B] tensor
    and a sampled step's uniforms drawn into a [BLOCK, ...] buffer before
    its block runs, in blocks of graphs.BLOCK steps: step j of a block runs
    while the budget allows it and the loop's condition, computed on the
    device (some row not stopped; under early_stopping some live beam's
    bound above the best finished score), holds, the port of the JAX loops'
    lax.while_loop. The loop state is bound to the static buffers of its
    key in a graph stage (`graphs`, the engine's; graphs.py), which on a
    CUDA engine captures the block once per key as one CUDA graph of
    conditional steps and replays it, and elsewhere runs the same block
    deciding each step on the host; the host reads the device once a block.
  * A forced prefix `input_tokens` [B, S0] (model.py:673-688, HF generate's
    input_ids) joins the prefill after start_mel at mel positions 1..S0, its
    codes join the repetition penalty's seen set, and every decode position
    shifts by S0; the returned codes exclude it. inference_speech is the
    reference's high-level entry (model.py:655-708): conditioning, row
    tiling for num_return_sequences, the positional-table cap, and the
    greedy / sampled or the beam loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from indextts_tpu_torch import tracing
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.graphs import BLOCK, GraphStage, block_row, stage_or_uncaptured, weights_key
from indextts_tpu_torch.models.gpt import (NEG, GPT2Block, Stream, UnifiedVoice, final_ln, get_conditioning,
                                           gpt2_apply, head_logits, write_at)
from indextts_tpu_torch.models.granite import split_cache
from indextts_tpu_torch.ops.cuda import gpt2_chains, ssm_step
from indextts_tpu_torch.ops.cuda.decode_attn import decode_attn, quant_cols as _quant_cols
from indextts_tpu_torch.ops.norms import layer_norm
from indextts_tpu_torch.ops.sampling import (
    Knob,
    RowDraw,
    apply_repetition_penalty,
    apply_typical,
    apply_warpers,
    greedy_token,
    process_logits,
    row_knob,
    sample_token,
    uniforms,
)

NEG_INF = torch.finfo(torch.float32).min  # a dead beam's score, as in JAX


@dataclass(frozen=True)
class GenerationConfig:
    """Decode settings that change the loop's structure. early_stopping is
    JAX's admissible rule: a beam search stops once no live beam's best
    reachable score can beat the best finished hypothesis."""

    do_sample: bool = True
    num_beams: int = 1
    top_k: int = 30
    typical_sampling: bool = False
    max_new_tokens: int = 600
    early_stopping: bool = True


@dataclass
class DecodeState:
    """The loop state: step i, codes [B, max_new] (stop-filled), the cache
    (k, v) [L, B, H, S, Dh] or, int8, (k8, ks, v8, vs), done [B], seen [B, V]
    for the repetition penalty, the last token cur [B] and, under latent
    capture, lat [B, max_new, D] (lat[:, j] is the final-norm hidden that
    predicted code j). Updated in place by decode_steps, which keeps i on
    the host (for the budget) and in t, a [1] long device counter that the
    step reads and advances, and `live`, whether some row was still
    decoding when the last block ended (read back with the block)."""

    i: int
    codes: torch.Tensor
    cache: Tuple[torch.Tensor, ...]
    done: torch.Tensor
    seen: torch.Tensor
    cur: torch.Tensor
    t: torch.Tensor
    lat: Optional[torch.Tensor] = None
    live: bool = True


@dataclass
class DecodeContext:
    """What the loop needs besides the state: the prefill length p, the
    prefill key mask padded to the cache length, the sampling settings
    (each dynamic knob a [B] float32 tensor, one value per row) and s0, the
    length of a forced prefix (decode positions shift by s0). When sampling,
    `u` [BLOCK, B] holds the uniforms of a block's steps, row j for its step
    j, drawn from `generator` by draw() before the block runs (a captured
    step draws nothing)."""

    p: int
    prefill_valid: torch.Tensor
    gen: GenerationConfig
    generator: Union[torch.Generator, RowDraw]
    temperature: torch.Tensor
    top_p: torch.Tensor
    repetition_penalty: torch.Tensor
    typical_mass: torch.Tensor
    s0: int = 0
    u: Optional[torch.Tensor] = None

    def draw(self, steps: int) -> None:
        """The uniforms of the next `steps` steps, one draw a step, in order
        (a span dec.draws)."""
        if self.u is not None:
            with tracing.span("dec.draws", steps=steps):
                for j in range(steps):
                    self.u[j].copy_(uniforms(tuple(self.u.shape[1:]), self.generator, self.u.device))

    def sample(self, logits: torch.Tensor, seen: torch.Tensor, u: Optional[torch.Tensor]) -> torch.Tensor:
        """The next token of each row; `u` [B], a row of self.u, when sampling."""
        lf = process_logits(
            logits, seen_mask=seen, repetition_penalty=self.repetition_penalty,
            typical_sampling=self.gen.typical_sampling, typical_mass=self.typical_mass,
            temperature=self.temperature, top_k=self.gen.top_k if self.gen.do_sample else 0,
            top_p=self.top_p, do_sample=self.gen.do_sample,
        )
        return sample_token(lf, u) if self.gen.do_sample else greedy_token(lf)


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


def _with_prefix(model: UnifiedVoice, emb: torch.Tensor, mask: torch.Tensor,
                 input_tokens: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The prefill with a forced prefix [B, S0] of mel codes after start_mel,
    at mel positions 1..S0 (model.py:673-688). Returns (emb, mask, s0)."""
    if input_tokens is None:
        return emb, mask, 0
    s0 = input_tokens.shape[1]
    prefix = model.mel_embedding[input_tokens.long()] + model.mel_pos_embedding[1 : s0 + 1][None]
    ones = torch.ones(mask.shape[0], s0, dtype=torch.bool, device=mask.device)
    return torch.cat([emb, prefix.to(emb.dtype)], dim=1), torch.cat([mask, ones], dim=1), s0


def _mel_logits(model: UnifiedVoice, hidden: torch.Tensor, return_normed: bool = False):
    """lm_head = final_norm -> mel_head (reference: model.py:48). The
    final-norm hidden is the latent the vocoder takes; return_normed returns
    it beside the logits."""
    h = layer_norm(hidden, model.final_norm.weight, model.final_norm.bias)
    if return_normed:
        return head_logits(model.mel_head, h, model.logits_scaling), h
    return head_logits(model.mel_head, h, model.logits_scaling)


def _prefill(model: UnifiedVoice, cfg: GPTConfig, emb: torch.Tensor, mask: torch.Tensor, cache_len: int,
             quant_kv: bool = False, return_hidden: bool = False):
    """Run the stack over the prompt; returns last-position logits [B, V] and
    the cache, zero past the prompt: (k, v), each [L, B, H, cache_len, Dh],
    or with quant_kv (k8, ks, v8, vs), quantized after the full-precision
    prefill attention; the pad columns' scales are zero (the attention bias
    masks those columns). A hybrid stack's cache holds its attention layers'
    K / V and then its Mamba layers' conv and SSM states after the prompt.
    return_hidden adds the last position's final-norm hidden [B, D], the
    latent that predicts the first code."""
    states = ()
    if model.hybrid:
        hidden, (k, v, *states) = model.gpt(emb, mask, return_state=True)
    else:
        hidden, (k, v) = gpt2_apply(model.gpt, emb, cfg.heads, attention_mask=mask, return_kv=True)
    pad = cache_len - k.shape[3]
    if quant_kv:
        (k8, ks), (v8, vs) = _quant_cols(k), _quant_cols(v)
        pad8, pads = (0, 0, 0, pad), (0, pad)
        cache = tuple(torch.nn.functional.pad(t, pad8 if t.dim() == 5 else pads) for t in (k8, ks, v8, vs))
    else:
        cache = tuple(torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    cache += tuple(states)
    if return_hidden:
        logits, h = _mel_logits(model, hidden[:, -1], return_normed=True)
        return logits, cache, h
    return _mel_logits(model, hidden[:, -1]), cache


def _decode_block_q(block: GPT2Block, h: Stream, k8: torch.Tensor, ks: torch.Tensor, v8: torch.Tensor,
                    vs: torch.Tensor, pos: Union[int, torch.Tensor], bias: torch.Tensor, heads: int) -> Stream:
    """GPT2Block.step against the int8 cache of one layer: k8 / v8 [B, H, S,
    Dh], ks / vs [B, H/2, S]; the residual stream h in and out (models/gpt.py
    Stream). `bias` [B, 1, S] masks slot `pos`: the new
    token's exact K / V enter the softmax as an extra logit, and are then
    quantized into slot `pos` (an int or a [1] device index) in place (K6,
    ops/cuda/decode_attn.py, whose plain version dequantizes in JAX's order)."""
    x, q, k, v = block.qkv(h, heads)
    return block.proj(x, decode_attn(q, k, v, (k8, ks, v8, vs), pos, bias))


def _decode_step(model: UnifiedVoice, cfg: GPTConfig, token: torch.Tensor, mel_pos: Union[int, torch.Tensor], cache,
                 pos: Union[int, torch.Tensor], valid: torch.Tensor, return_hidden: bool = False):
    """One step: token [B] at mel position `mel_pos` (an int, a [1] long
    tensor, or a [B] one where the rows sit at different ages, as slot rows
    do), its K/V written into the one shared cache slot `pos` (an int or a
    [1] long device index; in place). valid: [B, S]
    bool, the cache slots already written that the token attends, `pos`
    excluded (JAX's base_mask). The cache is (k, v) or int8 (k8, ks, v8, vs),
    with a hybrid stack's conv and SSM states after them (advanced in
    place). Returns logits [B, V], and with return_hidden also the
    final-norm hidden [B, D]."""
    x = model.mel_embedding[token] + model.mel_pos_embedding[mel_pos]
    bias = torch.where(valid, torch.zeros((), device=x.device), NEG)[:, None, :]  # [B, 1, S]
    if model.hybrid:
        return _mel_logits(model, model.gpt.step(x, cache, pos, bias), return_normed=return_hidden)
    h = x  # the residual stream (models/gpt.Stream)
    for layer, block in enumerate(model.gpt.blocks):
        caches = [c[layer] for c in cache]
        if len(cache) == 4:
            h = _decode_block_q(block, h, *caches, pos, bias, cfg.heads)
        else:
            h = block.step(h, *caches, pos, bias, cfg.heads)
    return _mel_logits(model, final_ln(model.gpt.ln_f, h), return_normed=return_hidden)


def prefill_decode_state(
    model: UnifiedVoice,
    cfg: GPTConfig,
    gen: GenerationConfig,
    conds: torch.Tensor,
    text_tokens: torch.Tensor,
    text_lengths: torch.Tensor,
    generator: torch.Generator,
    temperature: Knob = 1.0,
    top_p: Knob = 0.8,
    repetition_penalty: Knob = 10.0,
    quant_kv: bool = False,
    typical_mass: Knob = 0.9,
    capture_latents: bool = False,
    cache_len: Optional[int] = None,
    input_tokens: Optional[torch.Tensor] = None,
) -> Tuple[DecodeState, DecodeContext]:
    """Prefill + first token. Returns the loop state and its context; the
    cache is int8 with quant_kv. The dynamic knobs are floats or [B] tensors.
    capture_latents gives the state a latent buffer whose slot 0 is the
    prefill's last final-norm hidden. cache_len
    (default p + max_new_tokens) allocates a shorter cache, to be extended
    with grow_cache before decode_steps writes past it. `input_tokens`
    [B, S0] is a forced prefix of mel codes (_with_prefix). A span
    dec.prefill (tracing.py)."""
    b = text_tokens.shape[0]
    with tracing.span("dec.prefill", rows=b) as span:
        dev = text_tokens.device
        emb, prefill_mask, s0 = _with_prefix(model, *prepare_gpt_inputs(model, cfg, conds, text_tokens, text_lengths),
                                             input_tokens)
        p = emb.shape[1]
        span.set(prefill=p)
        max_new = gen.max_new_tokens
        s_max = p + max_new if cache_len is None else int(cache_len)
        logits0, cache, *h0 = _prefill(model, cfg, emb, prefill_mask, s_max, quant_kv=quant_kv,
                                       return_hidden=capture_latents)
        seen = _initial_seen(cfg, b, dev, input_tokens)
        ctx = DecodeContext(
            p=p, prefill_valid=torch.nn.functional.pad(prefill_mask, (0, s_max - p)), gen=gen,
            generator=generator, temperature=row_knob(temperature, b, dev), top_p=row_knob(top_p, b, dev),
            repetition_penalty=row_knob(repetition_penalty, b, dev), typical_mass=row_knob(typical_mass, b, dev), s0=s0,
            u=torch.empty(BLOCK, b, device=dev) if gen.do_sample else None,
        )
        ctx.draw(1)
        tok1 = ctx.sample(logits0, seen, None if ctx.u is None else ctx.u[0])
        codes = torch.full((b, max_new), cfg.stop_mel_token, dtype=torch.long, device=dev)
        codes[:, 0] = tok1
        seen[torch.arange(b, device=dev), tok1] = True
        lat = None
        if capture_latents:
            lat = emb.new_zeros((b, max_new, emb.shape[-1]))
            lat[:, 0] = h0[0]
        state = DecodeState(i=0, codes=codes, cache=cache, done=tok1 == cfg.stop_mel_token, seen=seen, cur=tok1,
                            t=torch.zeros(1, dtype=torch.long, device=dev), lat=lat)
        return state, ctx


def _initial_seen(cfg: GPTConfig, rows: int, dev, input_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The repetition penalty's seen set [rows, V]. HF penalizes over the
    whole input_ids row: the fake inputs are 1s with a trailing start_mel
    (model.py:645-653), so ids {1, start_mel} start seen, and so do the
    codes of a forced prefix [rows, S0]."""
    seen = torch.zeros(rows, cfg.number_mel_codes, dtype=torch.bool, device=dev)
    seen[:, 1] = True
    seen[:, cfg.start_mel_token] = True
    if input_tokens is not None:
        seen[torch.arange(rows, device=dev)[:, None], input_tokens.long()] = True
    return seen


def _pad_slots(cache: Tuple[torch.Tensor, ...], extra: int) -> Tuple[torch.Tensor, ...]:
    """A cache with `extra` zero slots appended: (k, v) [L, B, H, S, Dh] or
    int8 (k8, ks, v8, vs) with the scales [L, B, H/2, S]; a hybrid stack's
    conv and SSM states, which have no slots, as they are."""
    kv, states = split_cache(cache)
    return tuple(torch.nn.functional.pad(c, (0, 0, 0, extra) if c.dim() == 5 else (0, extra)) for c in kv) + states


def grow_cache(state: DecodeState, ctx: DecodeContext, extra: int) -> Tuple[DecodeState, DecodeContext]:
    """Extend the state's KV cache, either kind, and the context's key mask
    by `extra` slots (the transition between two segments: each runs against
    the smallest cache that fits its steps). Updates both in place."""
    state.cache = _pad_slots(state.cache, extra)
    ctx.prefill_valid = torch.nn.functional.pad(ctx.prefill_valid, (0, extra))
    return state, ctx


def _decode_iteration(model: UnifiedVoice, cfg: GPTConfig, state: DecodeState, ctx: DecodeContext,
                      pos_off: int, row: torch.Tensor) -> None:
    """One iteration of decode_steps at the device step counter i = state.t,
    which it then advances; a sampled step takes row `row` ([1] long, its
    place in the block) of ctx.u. Every write is in place."""
    dev = state.codes.device
    i = state.t
    positions = torch.arange(ctx.prefill_valid.shape[1], device=dev)[None, :]
    write_pos = ctx.p + i
    valid = ctx.prefill_valid | ((positions >= ctx.p) & (positions < write_pos))
    logits = _decode_step(model, cfg, state.cur, i + pos_off + ctx.s0, state.cache, write_pos, valid,
                          return_hidden=state.lat is not None)
    if state.lat is not None:
        logits, hidden = logits
        write_at(state.lat, 1, i + 1, hidden)
    nxt = ctx.sample(logits, state.seen, block_row(ctx.u, row))
    nxt = torch.where(state.done, torch.full_like(nxt, cfg.stop_mel_token), nxt)
    write_at(state.codes, 1, i + 1, nxt)
    state.done |= nxt == cfg.stop_mel_token
    state.seen.scatter_(1, nxt[:, None], True)
    state.cur.copy_(nxt)
    state.t.add_(1)


_DECODE_STATE_BUFFERS = ("codes", "cache", "done", "seen", "cur", "lat", "t")
_DECODE_CONTEXT_BUFFERS = ("prefill_valid", "temperature", "top_p", "repetition_penalty", "typical_mass", "u")


def _bind_decode(stage: GraphStage, model: UnifiedVoice, state: DecodeState, ctx: DecodeContext,
                 pos_off: int):
    """Move a greedy / sampled loop onto the static buffers of its key, the
    JAX engine's ("dec", b, text bucket, gen, capture, quant_kv) with the
    prefill length p standing for the text bucket, the cache length of the
    segment, the positional offsets, the dtype, the weights and the block's
    steps; the device counter t is set to the host's i."""
    b = state.codes.shape[0]
    key = ("dec", b, ctx.p, ctx.gen, state.lat is not None, state.cache[0].dtype == torch.int8,
           ctx.prefill_valid.shape[1], pos_off, ctx.s0, state.cache[0].dtype, weights_key(model), BLOCK)
    lane = stage.bind(key, state, [(state, _DECODE_STATE_BUFFERS), (ctx, _DECODE_CONTEXT_BUFFERS)])
    state.t.fill_(state.i)
    return lane


def decode_steps(model: UnifiedVoice, cfg: GPTConfig, state: DecodeState, ctx: DecodeContext, n_steps: int,
                 pos_off: int = 2, graphs: Optional[GraphStage] = None) -> DecodeState:
    """Run up to `n_steps` decode iterations, stopping early when every row
    has emitted stop_mel_token or the code buffer is full. Token g_{i+1} is
    decoded at cache slot p+i and mel position i+pos_off+s0; under capture
    its final-norm hidden goes to lat[:, i+1]. The state moves onto its
    key's static buffers in `graphs`, the engine's decode stage (without
    one, a stage that never captures), and the steps run through it in
    blocks (graphs.GraphStage.run): on a CUDA engine a replay of the key's
    captured block, whose steps after the last row stopped are skipped on
    the card; the uniforms of a block's steps are drawn into ctx.u before
    it, one draw for each step the budget allows. One host read a block.
    A span dec.loop (tracing.py) around the whole call, with `k7_launches`
    and `k8_launches`, the K7 and K8 launches its steps ran."""
    with tracing.span("dec.loop") as loop_span:
        k7, k8 = ssm_step.launches, gpt2_chains.launches
        stop = min(state.i + n_steps, state.codes.shape[1] - 1)
        stage = stage_or_uncaptured(graphs, state.codes.device)
        lane = _bind_decode(stage, model, state, ctx, pos_off)
        step = lambda: _decode_iteration(model, cfg, state, ctx, pos_off, lane.ctl.ran)
        live = lambda: ~state.done.all()
        while state.i < stop and state.live:
            ctx.draw(min(BLOCK, stop - state.i))
            ran, state.live = stage.run(lane, step, live, stop - state.i)
            state.i += ran
        loop_span.set(k7_launches=ssm_step.launches - k7, k8_launches=gpt2_chains.launches - k8)
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
    typical_mass: float = 0.9,
    capture_latents: bool = False,
    input_tokens: Optional[torch.Tensor] = None,
    graphs: Optional[GraphStage] = None,
):
    """Greedy / sampled generation (num_beams == 1). Returns (codes [B,
    max_new_tokens] right-padded with stop_mel_token, lengths [B] counting
    tokens up to and including the stop token), as HF generate() with
    eos = pad = stop_mel_token (model.py:698-703). The loop runs
    max(lengths) - 1 decode steps. quant_kv: the int8 KV cache.
    capture_latents adds lat [B, max_new, D]: lat[:, j] is the final-norm
    hidden that predicted code j. They equal the teacher-forced latents of
    the same codes only with pos_off=1 (the consistent-positions mode).
    `input_tokens` [B, S0]: a forced prefix, excluded from the codes (the
    reference truncates at trunc_index, model.py:704-708). `graphs`: the
    engine's decode stage (decode_steps)."""
    state, ctx = prefill_decode_state(
        model, cfg, gen, conds, text_tokens, text_lengths, generator,
        temperature=temperature, top_p=top_p, repetition_penalty=repetition_penalty, quant_kv=quant_kv,
        typical_mass=typical_mass, capture_latents=capture_latents, input_tokens=input_tokens,
    )
    state = decode_steps(model, cfg, state, ctx, gen.max_new_tokens - 1, pos_off=pos_off, graphs=graphs)
    return _finish(cfg, state, capture_latents)


def _finish(cfg: GPTConfig, state: DecodeState, capture_latents: bool):
    """(codes, lengths[, lat]) of a finished greedy / sampled state, copied
    out of the state (a captured key's buffers serve the next request)."""
    max_new = state.codes.shape[1]
    is_stop = state.codes == cfg.stop_mel_token
    first_stop = torch.argmax(is_stop.int(), dim=1)
    lengths = torch.where(is_stop.any(dim=1), first_stop + 1, torch.full_like(first_stop, max_new))
    if capture_latents:
        return state.codes.clone(), lengths, state.lat.clone()
    return state.codes.clone(), lengths


@torch.no_grad()
def generate_speech_segmented(
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
    typical_mass: float = 0.9,
    capture_latents: bool = False,
    segment: int = 160,
    stats: Optional[dict] = None,
    graphs: Optional[GraphStage] = None,
):
    """generate_speech with a KV cache that grows by segments: the same
    sampling state machine and outputs, but segment k runs against a cache
    of p + min(segment * (k + 1), max_new) slots, so a step's attention
    reads scale with the generated length and not with max_new_tokens. The
    first segment runs the prefill and segment - 1 steps; a segment's last
    block tells the host whether every row has stopped, and then it skips
    the rest.
    `stats`, a dict, receives "segments", the segments run. `graphs`: the
    engine's decode stage; each segment's cache length is a key of its own."""
    max_new = gen.max_new_tokens
    n_segments = -(-max_new // segment)
    p = conds.shape[1] + text_tokens.shape[1] + 2 + 1
    state, ctx = prefill_decode_state(
        model, cfg, gen, conds, text_tokens, text_lengths, generator,
        temperature=temperature, top_p=top_p, repetition_penalty=repetition_penalty, quant_kv=quant_kv,
        typical_mass=typical_mass, capture_latents=capture_latents, cache_len=p + min(segment, max_new),
    )
    state = decode_steps(model, cfg, state, ctx, segment - 1, pos_off=pos_off, graphs=graphs)
    ran = 1
    for k in range(1, n_segments):
        if not state.live:
            break
        cache_len = p + min(segment * (k + 1), max_new)
        grow_cache(state, ctx, cache_len - ctx.prefill_valid.shape[1])
        state = decode_steps(model, cfg, state, ctx, cache_len - p - segment * k, pos_off=pos_off, graphs=graphs)
        ran += 1
    if stats is not None:
        stats["segments"] = ran
    return _finish(cfg, state, capture_latents)


# ---------------------------------------------------------------------------
# beam search (num_beams > 1): HF beam_search / beam_sample semantics
# ---------------------------------------------------------------------------


def _beam_joint_scores(logits: torch.Tensor, seen: torch.Tensor, beam_scores: torch.Tensor, gen: GenerationConfig,
                       temperature: Knob, top_p: Knob, repetition_penalty: Knob,
                       typical_mass: Knob) -> torch.Tensor:
    """Joint successor scores [bb, V] float32 with HF beam semantics: the
    processors (repetition penalty, typical) run on the log-softmaxed
    per-beam scores, the beam scores are added, and the warpers
    (temperature, top-k / top-p keeping at least two tokens) run on the joint
    scores when sampling. On log-probs (always <= 0) the repetition penalty
    always multiplies. logits, seen: [bb, V]; beam_scores: [bb]; the knobs
    are floats or [bb] tensors (a request's value repeated for its beams)."""
    lf = torch.log_softmax(logits.float(), dim=-1)
    lf = apply_repetition_penalty(lf, seen, repetition_penalty)
    if gen.typical_sampling:
        lf = apply_typical(lf, typical_mass, min_tokens_to_keep=2)
    joint = lf + beam_scores[:, None]
    if gen.do_sample:
        joint = apply_warpers(joint, temperature, gen.top_k, top_p, min_tokens_to_keep=2)
    return joint


def beam_uniforms(shape, generator: Union[torch.Generator, RowDraw], device) -> torch.Tensor:
    """The uniforms of one sampled successor draw, made before the step that
    consumes them (the tests replace this function with a recorded stream);
    a RowDraw takes its rows of the whole batch's draw (ops/sampling.uniforms)."""
    return uniforms(shape, generator, device)


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k along the last axis: the k largest, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_successors(logp_joint: torch.Tensor, generator: Union[torch.Generator, RowDraw, torch.Tensor],
                       gen: GenerationConfig, nb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b, nb*V] joint scores -> (vals, idx) of the 2*nb successors of each
    row, in descending true score. Sampling draws them by Gumbel top-k (HF
    beam_sample's multinomial without replacement over softmax(joint)), its
    uniforms from `generator` or a [b, nb*V] tensor of them already drawn,
    and sorts the draw by true score; greedy is plain top-k."""
    k = 2 * nb
    if gen.do_sample:
        u = uniforms(logp_joint.shape, generator, logp_joint.device)
        g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        _, idx = _top_k_stable(logp_joint + g, k)
        vals = torch.gather(logp_joint, 1, idx)
        order = torch.argsort(-vals, dim=1, stable=True)
        return torch.gather(vals, 1, order), torch.gather(idx, 1, order)
    return _top_k_stable(logp_joint, k)


def _beam_stop_bound_base(length_penalty: Knob, prefill_len: int, max_new: int, i: Union[int, torch.Tensor]):
    """The admissible hypothesis-length base of the early-stop bound: scores
    divide by (prefill + length) ** length_penalty, so the best reachable
    finish is at max_new when length_penalty > 0 and at the next step
    otherwise (HF's BeamHypotheses.is_done switches the same way). A float,
    or [b] for a length_penalty with one value per request; i, the steps
    run, is an int or the loop's [1] device counter (no host read)."""
    if isinstance(length_penalty, torch.Tensor):
        far = torch.full_like(length_penalty, float(prefill_len + max_new))
        near = ((i + (prefill_len + 1)).to(far.dtype) if isinstance(i, torch.Tensor)
                else torch.full_like(far, float(prefill_len + i + 1)))
        return torch.where(length_penalty > 0, far, near)
    return float(prefill_len + max_new) if length_penalty > 0 else float(prefill_len + i + 1)


def _length_norm(base, length_penalty: Knob, column: bool = False):
    """base ** length_penalty, the divisor of a hypothesis score: a float for
    a float penalty, else float32 per request, [b] or as a column [b, 1]."""
    if isinstance(length_penalty, torch.Tensor):
        lp = length_penalty.float()
        norm = torch.as_tensor(base, dtype=torch.float32, device=lp.device) ** lp
        return norm[:, None] if column else norm
    return base ** float(length_penalty)


@dataclass
class BeamBest:
    """The best finished hypothesis of each batch row: score [b], codes [b,
    max_new], length [b], and under latent capture its latents [b, max_new,
    D]."""

    score: torch.Tensor
    codes: torch.Tensor
    length: torch.Tensor
    lat: Optional[torch.Tensor] = None


def _beam_step(cfg: GPTConfig, gen: GenerationConfig, si: Union[int, torch.Tensor], logits: torch.Tensor,
               codes: torch.Tensor,
               beam_scores: torch.Tensor, seen: torch.Tensor, best: BeamBest, joint_fn, select, b: int, nb: int,
               length_penalty: Knob = 0.0, prefill_len: int = 0, lat: Optional[torch.Tensor] = None):
    """One successor selection, shared by generate_speech_beam and the tests.
    joint_fn(logits, seen, beam_scores) -> [bb, V] (_beam_joint_scores);
    select(cand [b, nb*V]) -> (vals, idx) (_select_successors). The code
    chosen here goes to codes[:, si] (si a [1] long device index, or an int
    moved there). An eos candidate among the top nb
    ranks finishes a hypothesis scored vals / (prefill_len + si) **
    length_penalty (HF's base: the eos is not yet appended; length_penalty a
    float, or [b] with one value per request); lower-ranked eos
    candidates are dropped (HF's rank filter). lat [bb, max_new, D], the
    beams' latents in the same row order as codes, is snapshotted with a
    finished hypothesis. Updates `best`'s tensors in place; returns (codes,
    beam scores [bb], seen, flat_src [bb], next tokens [bb])."""
    v = cfg.number_mel_codes
    dev = logits.device
    si = torch.as_tensor(si, device=dev).reshape(1)
    cand = joint_fn(logits, seen, beam_scores).reshape(b, nb * v)
    vals, idx = select(cand)
    src_beam = torch.div(idx, v, rounding_mode="floor")
    tok = idx % v
    is_eos = tok == cfg.stop_mel_token
    base = (prefill_len + si).float()
    lp = torch.where(base > 0, _length_norm(base, length_penalty, column=True), 1.0)
    ranks = torch.arange(2 * nb, device=dev)[None, :]
    finished = torch.where(is_eos & (ranks < nb), vals / lp, torch.full_like(vals, NEG_INF))
    fbest, fargmax = finished.max(dim=1)
    improve = fbest > best.score
    fin_beam = torch.gather(src_beam, 1, fargmax[:, None])[:, 0]
    fin_tok = torch.gather(tok, 1, fargmax[:, None])[:, 0]
    flat_fin = torch.arange(b, device=dev) * nb + fin_beam
    fin_codes = codes[flat_fin]
    write_at(fin_codes, 1, si, fin_tok)
    length = (si + 1).expand_as(best.length)
    best.codes.copy_(torch.where(improve[:, None], fin_codes, best.codes))
    best.length.copy_(torch.where(improve, length, best.length))
    best.score.copy_(torch.where(improve, fbest, best.score))
    if lat is not None:
        best.lat.copy_(torch.where(improve[:, None, None], lat[flat_fin], best.lat))
    cont = torch.where(is_eos, torch.full_like(vals, NEG_INF), vals)
    cont_vals, cont_pick = _top_k_stable(cont, nb)
    new_beam = torch.gather(src_beam, 1, cont_pick)
    new_tok = torch.gather(tok, 1, cont_pick).reshape(-1)
    flat_src = (torch.arange(b, device=dev)[:, None] * nb + new_beam).reshape(-1)
    codes = codes[flat_src]
    write_at(codes, 1, si, new_tok)
    seen = seen[flat_src]
    seen.scatter_(1, new_tok[:, None], True)
    return codes, cont_vals.reshape(-1), seen, flat_src, new_tok


def _beam_finalize(codes: torch.Tensor, beam_scores: torch.Tensor, best: BeamBest, b: int, nb: int, max_new: int,
                   length_penalty: Knob, prefill_len: int, lat: Optional[torch.Tensor] = None):
    """HF finalize: the live beams join the finished hypotheses, normalized
    by the full final length, and the best of all wins. Returns (codes [b,
    max_new], lengths [b]) and, with lat [bb, max_new, D], the winner's
    latents [b, max_new, D]."""
    live = beam_scores.reshape(b, nb) / _length_norm(float(prefill_len + max_new), length_penalty, column=True)
    live_val, live_idx = live.max(dim=1)
    live_flat = torch.arange(b, device=codes.device) * nb + live_idx
    pick_live = live_val > best.score
    final_codes = torch.where(pick_live[:, None], codes[live_flat], best.codes)
    final_len = torch.where(pick_live, torch.full_like(best.length, max_new), best.length)
    if lat is None:
        return final_codes, final_len
    return final_codes, final_len, torch.where(pick_live[:, None, None], lat[live_flat], best.lat)


class _BeamLoop:
    """The beam search loop, shared by generate_speech_beam and
    generate_speech_beam_segmented: prefill (once per batch row, the cache
    repeated to [L, B*nb, H, S, Dh], row b*nb + m is beam m of row b), the
    first successor choice, then run(n) for up to n decode steps and grow(n)
    for n more cache and latent slots. After every step the cache rows, both
    kinds ((k, v) or int8 (k8, ks, v8, vs)), follow their beams: each is
    gathered by index_select and copied back in place (the JAX package
    resolves beam lineage inside attention instead, to avoid a TPU
    relayout), so that the state keeps its addresses. Iteration i consumes
    the code at codes[:, i], writes cache slot p+i at mel position
    i+pos_off+s0 and chooses codes[:, i+1]. `gen_slots` is the number of
    generated-token slots the cache and the latent buffer start with. A
    forced prefix `input_tokens` [B, S0] rides each row's prefill, and its
    codes are repeated for the row's beams in the seen set (JAX it_bb). The
    knobs are float32 tensors, one value per beam row ([b] for
    length_penalty); t is the device step counter, u [BLOCK, b, nb*V] the
    successor draws of a block's steps when sampling, row j for its step j;
    `alive` is the early-stop condition as the last block left it. The
    constructor (the prefill and the first choice) is a span dec.prefill."""

    # the tensors a captured step reads and writes (the static buffers of its key)
    _BUFFERS = ("cache", "codes", "beam_scores", "seen", "lat", "cur", "t", "prefill_valid", "temperature", "top_p",
                "repetition_penalty", "typical_mass", "length_penalty", "u")

    def __init__(self, model, cfg, gen, conds, text_tokens, text_lengths, generator, temperature, top_p,
                 repetition_penalty, length_penalty, typical_mass, quant_kv, capture_latents, pos_off, gen_slots,
                 input_tokens=None):
        with tracing.span("dec.prefill", rows=text_tokens.shape[0]) as span:
            self.model, self.cfg, self.gen, self.generator = model, cfg, gen, generator
            self.nb = nb = gen.num_beams
            self.b = b = text_tokens.shape[0]
            self.pos_off, self.capture = pos_off, capture_latents
            self.max_new = max_new = gen.max_new_tokens
            bb = b * nb
            dev = text_tokens.device
            self.length_penalty = row_knob(length_penalty, b, dev)
            emb, prefill_mask, self.s0 = _with_prefix(
                model, *prepare_gpt_inputs(model, cfg, conds, text_tokens, text_lengths), input_tokens)
            self.p = p = emb.shape[1]
            span.set(prefill=p)
            logits0, cache, *h0 = _prefill(model, cfg, emb, prefill_mask, p + gen_slots, quant_kv=quant_kv,
                                           return_hidden=capture_latents)
            self.cache = tuple(c.repeat_interleave(nb, dim=1) for c in cache)
            logits0 = logits0.repeat_interleave(nb, dim=0)
            self.prefill_valid = torch.nn.functional.pad(prefill_mask, (0, gen_slots)).repeat_interleave(nb, dim=0)
            self.seen = _initial_seen(cfg, bb, dev,
                                      None if input_tokens is None else input_tokens.repeat_interleave(nb, 0))
            self.lat = None
            if capture_latents:
                self.lat = emb.new_zeros((bb, gen_slots, emb.shape[-1]))
                self.lat[:, 0] = h0[0].repeat_interleave(nb, dim=0)
            # a knob with one value per request repeats for the request's beams
            self.temperature, self.top_p, self.repetition_penalty, self.typical_mass = (
                row_knob(v.repeat_interleave(nb) if isinstance(v, torch.Tensor) and v.dim() == 1 else v, bb, dev)
                for v in (temperature, top_p, repetition_penalty, typical_mass))
            beam_scores = torch.full((b, nb), NEG_INF, device=dev)
            beam_scores[:, 0] = 0.0
            self.beam_scores = beam_scores.reshape(-1)
            self.codes = torch.full((bb, max_new), cfg.stop_mel_token, dtype=torch.long, device=dev)
            self.best = BeamBest(score=torch.full((b,), NEG_INF, device=dev),
                                 codes=torch.full((b, max_new), cfg.stop_mel_token, dtype=torch.long, device=dev),
                                 length=torch.zeros((b,), dtype=torch.long, device=dev),
                                 lat=None if self.lat is None else self.lat.new_zeros((b,) + self.lat.shape[1:]))
            self.i = 0
            self.alive = True
            self.t = torch.zeros(1, dtype=torch.long, device=dev)
            self.u = torch.empty(BLOCK, b, nb * cfg.number_mel_codes, device=dev) if gen.do_sample else None
            # the beams of a row are copies until the first decode step writes, so
            # the first selection needs no cache reorder
            self._draw(1)
            _, self.cur = self._select(self.t, logits0, None if self.u is None else self.u[0])

    def _joint(self, logits, seen, scores):
        return _beam_joint_scores(logits, seen, scores, self.gen, self.temperature, self.top_p,
                                  self.repetition_penalty, self.typical_mass)

    def _draw(self, steps: int) -> None:
        """The successor draws of the next `steps` steps, one a step, in order
        (a span dec.draws)."""
        if self.u is not None:
            with tracing.span("dec.draws", steps=steps):
                for j in range(steps):
                    self.u[j].copy_(beam_uniforms(tuple(self.u.shape[1:]), self.generator, self.u.device))

    def _select(self, si, logits, u: Optional[torch.Tensor]):
        """One successor choice, sampled from the draw `u` [b, nb*V] (a row
        of self.u); the beams' codes, scores, seen set and latents follow it
        in place."""
        codes, scores, seen, flat_src, nxt = _beam_step(
            self.cfg, self.gen, si, logits, self.codes, self.beam_scores, self.seen, self.best, self._joint,
            lambda cand: _select_successors(cand, u, self.gen, self.nb), self.b, self.nb,
            length_penalty=self.length_penalty, prefill_len=self.p, lat=self.lat)
        self.codes.copy_(codes)
        self.beam_scores.copy_(scores)
        self.seen.copy_(seen)
        if self.lat is not None:
            self.lat.copy_(self.lat[flat_src])
        return flat_src, nxt

    def _iteration(self, row: torch.Tensor) -> None:
        """One decode step at the device step counter i = self.t, which it
        then advances; sampled, it takes row `row` ([1] long, its place in the
        block) of self.u."""
        p, i = self.p, self.t
        positions = torch.arange(self.prefill_valid.shape[1], device=self.codes.device)[None, :]
        valid = self.prefill_valid | ((positions >= p) & (positions < p + i))
        logits = _decode_step(self.model, self.cfg, self.cur, i + self.pos_off + self.s0, self.cache, p + i, valid,
                              return_hidden=self.capture)
        if self.capture:
            logits, hidden = logits
            write_at(self.lat, 1, i + 1, hidden)
        flat_src, nxt = self._select(i + 1, logits, block_row(self.u, row))
        for c in self.cache:
            c.copy_(c.index_select(1, flat_src))
        self.cur.copy_(nxt)
        self.t.add_(1)

    def _live(self) -> torch.Tensor:
        """Whether another step can still change the result, on the device
        (the budget is the block's): under early_stopping, some live beam's
        best reachable score beats the best finished hypothesis, with the
        step counter t read on the device."""
        if not self.gen.early_stopping:
            return torch.ones((), dtype=torch.bool, device=self.t.device)
        base = _beam_stop_bound_base(self.length_penalty, self.p, self.max_new, self.t)
        bound = self.beam_scores.reshape(self.b, self.nb).max(dim=1).values / _length_norm(base, self.length_penalty)
        return (bound > self.best.score).any()

    def _bind(self, stage: GraphStage):
        """Move the loop onto the static buffers of its key (_bind_decode's,
        with gen.num_beams > 1); the device counter t is set to the host's i."""
        key = ("dec", self.b, self.p, self.gen, self.capture, self.cache[0].dtype == torch.int8,
               self.prefill_valid.shape[1], self.pos_off, self.s0, self.cache[0].dtype, weights_key(self.model),
               BLOCK)
        lane = stage.bind(key, self, [(self, self._BUFFERS), (self.best, ("score", "codes", "length", "lat"))])
        self.t.fill_(self.i)
        return lane

    def run(self, n_steps: int, graphs: Optional[GraphStage] = None) -> None:
        """Up to n_steps steps (at most to max_new - 1) while _live(), in
        blocks through `graphs`, the engine's decode stage, as in
        decode_steps (a span dec.loop, with k7_launches and k8_launches)."""
        with tracing.span("dec.loop") as loop_span:
            k7, k8 = ssm_step.launches, gpt2_chains.launches
            stop = min(self.i + n_steps, self.max_new - 1)
            stage = stage_or_uncaptured(graphs, self.codes.device)
            lane = self._bind(stage)
            step = lambda: self._iteration(lane.ctl.ran)
            while self.i < stop and self.alive:
                self._draw(min(BLOCK, stop - self.i))
                ran, self.alive = stage.run(lane, step, self._live, stop - self.i)
                self.i += ran
            loop_span.set(k7_launches=ssm_step.launches - k7, k8_launches=gpt2_chains.launches - k8)

    def grow(self, extra: int) -> None:
        """`extra` more generated-token slots: the cache, the key mask and,
        under capture, the beams' and the finished hypotheses' latents."""
        self.cache = _pad_slots(self.cache, extra)
        self.prefill_valid = torch.nn.functional.pad(self.prefill_valid, (0, extra))
        if self.lat is not None:
            self.lat = torch.nn.functional.pad(self.lat, (0, 0, 0, extra))
            self.best.lat = torch.nn.functional.pad(self.best.lat, (0, 0, 0, extra))

    def finalize(self):
        if self.lat is not None and self.lat.shape[1] < self.max_new:  # stopped before the last segment
            pad = (0, 0, 0, self.max_new - self.lat.shape[1])
            self.lat, self.best.lat = (torch.nn.functional.pad(t, pad) for t in (self.lat, self.best.lat))
        return _beam_finalize(self.codes, self.beam_scores, self.best, self.b, self.nb, self.max_new,
                              self.length_penalty, self.p, lat=self.lat)


@torch.no_grad()
def generate_speech_beam(
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
    length_penalty: float = 0.0,
    typical_mass: float = 0.9,
    quant_kv: bool = False,
    capture_latents: bool = False,
    pos_off: int = 2,
    stats: Optional[dict] = None,
    input_tokens: Optional[torch.Tensor] = None,
    graphs: Optional[GraphStage] = None,
):
    """Beam search (gen.num_beams = nb > 1): HF beam_search, or beam_sample
    with gen.do_sample, with JAX's admissible early stop (checked on the
    device before every step), over a cache of p + max_new_tokens slots
    (_BeamLoop);
    `input_tokens` [B, S0] a forced prefix, as in generate_speech.

    Returns (codes [B, max_new], lengths [B]) of the best hypothesis, and
    with capture_latents its latents [B, max_new, D] (slot j predicted code
    j; pos_off=1 for the teacher-forced pass's positions): the latent buffer
    is reordered with the beams, and a finished hypothesis keeps a copy.
    `stats`, a dict, receives "steps", the decode steps the loop ran.
    `graphs`: the engine's decode stage (decode_steps)."""
    max_new = gen.max_new_tokens
    loop = _BeamLoop(model, cfg, gen, conds, text_tokens, text_lengths, generator, temperature, top_p,
                     repetition_penalty, length_penalty, typical_mass, quant_kv, capture_latents, pos_off, max_new,
                     input_tokens=input_tokens)
    loop.run(max_new - 1, graphs)
    if stats is not None:
        stats["steps"] = loop.i
    return loop.finalize()


@torch.no_grad()
def generate_speech_beam_segmented(
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
    length_penalty: float = 0.0,
    typical_mass: float = 0.9,
    quant_kv: bool = False,
    capture_latents: bool = False,
    pos_off: int = 2,
    segment: int = 160,
    stats: Optional[dict] = None,
    graphs: Optional[GraphStage] = None,
):
    """generate_speech_beam with the generated part of the cache, and the
    latent buffers, growing by `segment` slots between runs of steps: the
    index_select reorder and the attention of a step then move the slots
    written so far, not the whole max_new_tokens budget. The same loop and
    the same outputs, token for token; a segment's last block reads back the
    loop's own early-stop condition, and the host then skips the rest. `stats` receives "steps"
    and "segments". `graphs`: the engine's decode stage; each segment's
    cache length is a key of its own."""
    max_new = gen.max_new_tokens
    n_segments = -(-max_new // segment)
    loop = _BeamLoop(model, cfg, gen, conds, text_tokens, text_lengths, generator, temperature, top_p,
                     repetition_penalty, length_penalty, typical_mass, quant_kv, capture_latents, pos_off,
                     min(segment, max_new))
    loop.run(min(segment, max_new) - 1, graphs)
    ran = 1
    for k in range(1, n_segments):
        if not loop.alive:
            break
        slots = min(segment * (k + 1), max_new)
        loop.grow(slots - segment * k)
        loop.run(slots - segment * k, graphs)
        ran += 1
    if stats is not None:
        stats["steps"], stats["segments"] = loop.i, ran
    return loop.finalize()


@torch.no_grad()
def inference_speech(
    model: UnifiedVoice,
    cfg: GPTConfig,
    speech_conditioning_mel: torch.Tensor,
    text_inputs: torch.Tensor,
    text_lengths: torch.Tensor,
    cond_mel_lengths: Optional[torch.Tensor] = None,
    input_tokens: Optional[torch.Tensor] = None,
    num_return_sequences: int = 1,
    max_generate_length: Optional[int] = None,
    typical_sampling: bool = False,
    typical_mass: float = 0.9,
    do_sample: bool = True,
    top_k: int = 30,
    top_p: float = 0.8,
    temperature: float = 1.0,
    num_beams: int = 1,
    repetition_penalty: float = 10.0,
    length_penalty: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """UnifiedVoice.inference_speech (model.py:655-708): conditioning, then
    generate_speech, or generate_speech_beam when num_beams > 1. Returns
    (codes [rows, max_new], lengths [rows]).

    num_return_sequences tiles the rows, which then sample independently
    (a multiple of the batch size when the batch has several rows, else
    ValueError). max_new is max_generate_length (default max_mel_tokens - 1),
    capped at max_mel_tokens and, with a forced prefix of S0 codes, at
    max_mel_tokens - 1 - S0 so that every decode position stays inside the
    positional table (ValueError when that leaves none). `generator`
    defaults to one seeded with 0."""
    if speech_conditioning_mel.dim() == 2:
        speech_conditioning_mel = speech_conditioning_mel[None]
    if cond_mel_lengths is None:
        cond_mel_lengths = torch.tensor([speech_conditioning_mel.shape[1]], device=speech_conditioning_mel.device)
    conds = get_conditioning(model, cfg, speech_conditioning_mel, cond_mel_lengths)
    b = text_inputs.shape[0]
    if conds.shape[0] == 1 and b > 1:
        conds = conds.expand(b, -1, -1)
    if num_return_sequences > 1:
        # the reference asserts divisibility (model.py:678-681)
        if b > 1 and num_return_sequences % b != 0:
            raise ValueError(
                f"num_return_sequences ({num_return_sequences}) must be a multiple of the batch size ({b})")
        reps = num_return_sequences // b if b > 1 else num_return_sequences
        conds, text_inputs, text_lengths = (t.repeat_interleave(reps, dim=0) for t in (conds, text_inputs, text_lengths))
        if input_tokens is not None:
            if input_tokens.dim() == 1:
                input_tokens = input_tokens[None]
            input_tokens = input_tokens.repeat_interleave(conds.shape[0] // input_tokens.shape[0], dim=0)
    max_new = max_generate_length if max_generate_length is not None else cfg.max_mel_tokens - 1
    max_new = min(int(max_new), cfg.max_mel_tokens)
    if input_tokens is not None:
        s0 = input_tokens.shape[-1]
        max_new = min(max_new, cfg.max_mel_tokens - 1 - s0)
        if max_new <= 0:
            raise ValueError(f"input_tokens prefix ({s0}) leaves no room under max_mel_tokens ({cfg.max_mel_tokens})")
    gen = GenerationConfig(do_sample=do_sample, num_beams=num_beams, top_k=int(top_k) if top_k else 0,
                           typical_sampling=typical_sampling, max_new_tokens=max_new)
    if generator is None:
        generator = torch.Generator(device=conds.device).manual_seed(0)
    kw = dict(temperature=temperature, top_p=top_p, repetition_penalty=repetition_penalty,
              typical_mass=typical_mass, input_tokens=input_tokens)
    if num_beams > 1:
        return generate_speech_beam(model, cfg, gen, conds, text_inputs, text_lengths, generator,
                                    length_penalty=length_penalty, **kw)
    return generate_speech(model, cfg, gen, conds, text_inputs, text_lengths, generator, **kw)
