"""Slot-based continuous decoding: rolling admission into a live batch (port
of indextts_tpu/models/gpt_slots.py).

A fixed-shape decode state holds `n_slots` independent rows. When a row
finishes, the host harvests it and admits a queued request's prefill into the
free slot while the other rows keep decoding.

What makes rolling admission exact is kept from the JAX package:

- Cached K/V carry their position from the time they were written (the GPT-2
  stack adds the learned mel position to the input embedding), so attention
  over them is a set reduction: where in the cache buffer a position lives
  does not matter, only each row's validity mask does.
- All rows therefore share ONE write cursor that advances mod S over a
  circular cache of S slots: every step writes one column, whatever the
  rows' ages.
- A row admitted at cursor c gets its prefill placed so that it ENDS at the
  cursor, columns (c - p) mod S .. c of its own plane; its generated K/V then
  land wherever the shared cursor goes next. A row lives at most p + max_new
  - 1 < S steps, so the cursor never laps a row's own valid content, and rows
  never touch each other's planes.
- Per-row progress (mel position, code index, latent index) rides [n_slots]
  vectors.

What differs: the cache is the port's [L, B, H, S, Dh] (int8: k8, ks, v8, vs
with one scale per head pair and position), not the head-paired one. A
granite hybrid stack's attention layers keep it with their KV heads, and its
Mamba layers keep a conv and an SSM state per slot beside it, which an
admission overwrites whole and every step advances in place. The
admission and the per-row writes of codes / seen / latents are indexed
writes, the plain form on a GPU (the JAX package uses roll-pad-where and
dense masked selects because XLA on a TPU serializes scatters). The step
counter and the cursor are device scalars and every write of a step is in
place, so the engine captures the loop's block of graphs.BLOCK steps once per
session shape as one CUDA graph (graphs.py), each step a conditional node
whose predicate (a row still active, the call's budget) the card computes
before it, as JAX's while_loop does; the host reads the device once a block.

Greedy slot decode equals `generate_speech` token for token per row, for
rows admitted mid-decode, across the cache wrap and after slot reuse
(tests/test_torch_slots.py). Sampling rows draw one uniform per row and step
from one generator. Forced mel prefixes and beams are not supported.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch

from indextts_tpu_torch import tracing
from indextts_tpu_torch.config import GPTConfig, is_hybrid
from indextts_tpu_torch.graphs import BLOCK, GraphStage, block_row, stage_or_uncaptured, weights_key
from indextts_tpu_torch.models.gpt import UnifiedVoice, write_at
from indextts_tpu_torch.models.gpt_decode import GenerationConfig, _decode_step, prefill_decode_state
from indextts_tpu_torch.models.granite import split_cache
from indextts_tpu_torch.ops.cuda import gpt2_chains, ssm_step
from indextts_tpu_torch.ops.sampling import Knob, greedy_token, process_logits, row_knob, sample_token, uniforms


@dataclass
class SlotState:
    """The rolling decode state ([B] = n_slots, [S] = cache_len). `active`: the
    row is mid-decode. `done`: it finished (stop code, or the codes buffer is
    full) and awaits the host's harvest; inert until admitted anew. A slot
    that is neither is empty. Inactive rows still get the shared cursor
    column written each step, but their mask bit stays False, so it is never
    attended. Updated in place by slot_admit and slot_steps."""

    tick: torch.Tensor     # 0-dim long, steps run so far
    cursor: torch.Tensor   # 0-dim long, the shared circular write cursor, in [0, S)
    i_b: torch.Tensor      # [B] long, each row's index of its last code
    codes: torch.Tensor    # [B, max_new] long, stop-filled
    cache: Tuple[torch.Tensor, ...]  # (k, v) or int8 (k8, ks, v8, vs); a hybrid stack's (conv, ssm) after them
    active: torch.Tensor   # [B] bool
    done: torch.Tensor     # [B] bool
    seen: torch.Tensor     # [B, V] bool, the repetition penalty's seen set
    cur: torch.Tensor      # [B] long, the last code emitted
    mask: torch.Tensor     # [B, S] bool, each row's valid cache slots
    lat: Optional[torch.Tensor] = None  # [B, max_new, D] captured latents
    u: Optional[torch.Tensor] = None    # [BLOCK, B] when sampling, a block's uniforms, drawn before it runs


def slot_state_init(cfg: GPTConfig, gen: GenerationConfig, n_slots: int, cache_len: int, dtype: torch.dtype,
                    device="cpu", capture_latents: bool = False, quant_kv: bool = False,
                    heads: Optional[int] = None) -> SlotState:
    """The empty state. cache_len (S) must reach the longest admitted prefill
    + gen.max_new_tokens (slot_admit checks each admission). `heads`: the
    KV heads of the cache, cfg.n_kv_heads, or a tensor-parallel shard's
    (parallel/mesh.local_heads). A hybrid stack's cache holds its attention
    layers and then each Mamba layer's conv state (in `dtype`) and SSM state
    (float32) per slot."""
    b, dev = n_slots, torch.device(device)
    hybrid = is_hybrid(cfg)
    h = (cfg.n_kv_heads if hybrid else cfg.heads) if heads is None else int(heads)
    layers = cfg.attn_layers if hybrid else cfg.layers
    shape5 = (layers, b, h, cache_len, cfg.model_dim // cfg.heads)
    shape4 = (layers, b, h // 2, cache_len)
    if quant_kv:
        cache = (torch.zeros(shape5, dtype=torch.int8, device=dev), torch.zeros(shape4, device=dev),
                 torch.zeros(shape5, dtype=torch.int8, device=dev), torch.zeros(shape4, device=dev))
    else:
        cache = (torch.zeros(shape5, dtype=dtype, device=dev), torch.zeros(shape5, dtype=dtype, device=dev))
    if hybrid:
        lm = cfg.mamba_layers
        cache += (torch.zeros(lm, b, cfg.conv_dim, cfg.mamba_d_conv - 1, dtype=dtype, device=dev),
                  torch.zeros(lm, b, cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_d_state, device=dev))
    return SlotState(
        tick=torch.zeros((), dtype=torch.long, device=dev), cursor=torch.zeros((), dtype=torch.long, device=dev),
        i_b=torch.zeros(b, dtype=torch.long, device=dev),
        codes=torch.full((b, gen.max_new_tokens), cfg.stop_mel_token, dtype=torch.long, device=dev),
        cache=cache,
        active=torch.zeros(b, dtype=torch.bool, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
        seen=torch.zeros(b, cfg.number_mel_codes, dtype=torch.bool, device=dev),
        cur=torch.full((b,), cfg.stop_mel_token, dtype=torch.long, device=dev),
        mask=torch.zeros(b, cache_len, dtype=torch.bool, device=dev),
        lat=torch.zeros(b, gen.max_new_tokens, cfg.model_dim, dtype=dtype, device=dev) if capture_latents else None,
        u=torch.zeros(BLOCK, b, device=dev) if gen.do_sample else None,
    )


@torch.no_grad()
def slot_prefill(model: UnifiedVoice, cfg: GPTConfig, gen: GenerationConfig, conds: torch.Tensor,
                 text_tokens: torch.Tensor, text_lengths: torch.Tensor, generator: torch.Generator,
                 temperature: Knob = 1.0, top_p: Knob = 0.8, repetition_penalty: Knob = 10.0,
                 typical_mass: Knob = 0.9, capture_latents: bool = False, quant_kv: bool = False) -> Dict[str, Any]:
    """Prefill queued rows (one or a batch, each to be admitted by
    slot_admit with its row index), through prefill_decode_state with
    cache_len = p: the one definition of the prefill and the first code
    (input mask, the ids {1, start_mel} that start out seen, the first draw)
    that the one-piece, streaming and segmented decodes use. The cache comes
    back at its own length p; a shorter row is left-padded to it, its pad
    columns masked."""
    p = conds.shape[1] + text_tokens.shape[1] + 3  # [cond latents | start, text, stop | start_mel]
    state, ctx = prefill_decode_state(
        model, cfg, gen, conds, text_tokens, text_lengths, generator,
        temperature=temperature, top_p=top_p, repetition_penalty=repetition_penalty, typical_mass=typical_mass,
        cache_len=p, capture_latents=capture_latents, quant_kv=quant_kv,
    )
    if ctx.p != p:
        raise AssertionError(f"prefill length drifted: {ctx.p} != {p}")
    out = {"cache": state.cache, "prefill_mask": ctx.prefill_valid, "tok1": state.cur, "done0": state.done,
           "seen1": state.seen}
    if capture_latents:
        out["h0"] = state.lat[:, 0]
    return out


@torch.no_grad()
def slot_admit(state: SlotState, prod: Dict[str, Any], slot: int, cfg: GPTConfig, row: int = 0) -> SlotState:
    """Write row `row` of a prefill (slot_prefill) into slot `slot`, its
    prefill placed so that it ENDS at the shared cursor: columns
    (cursor - p) mod S .. cursor of the slot's own cache plane; a hybrid
    stack's conv and SSM states are the slot's whole. The row is reset as a
    whole, so a harvested slot needs no clearing."""
    p = prod["prefill_mask"].shape[1]
    s_len = state.mask.shape[1]
    max_new = state.codes.shape[1]
    if p + max_new > s_len:
        raise ValueError(f"cache_len {s_len} < prefill {p} + max_new {max_new}: the cursor would lap this row's "
                         "own content")
    dev = state.codes.device
    cols = (state.cursor - p + torch.arange(p, device=dev)) % s_len
    kv, states = split_cache(state.cache)
    for big, small in zip(kv, prod["cache"]):
        # big [L, B, H, S, Dh] or the scales [L, B, H/2, S]; small the same with the prefill's rows and S = p
        big[:, slot][:, :, cols] = small[:, row].to(big.dtype)
    for big, small in zip(states, prod["cache"][len(kv):]):
        big[:, slot] = small[:, row].to(big.dtype)
    state.mask[slot] = False
    state.mask[slot, cols] = prod["prefill_mask"][row]
    tok1 = prod["tok1"][row]
    state.codes[slot] = cfg.stop_mel_token
    state.codes[slot, 0] = tok1
    state.seen[slot] = prod["seen1"][row]
    state.cur[slot] = tok1
    state.i_b[slot] = 0
    state.active[slot] = ~prod["done0"][row]
    state.done[slot] = prod["done0"][row]
    if state.lat is not None:
        state.lat[slot] = 0
        state.lat[slot, 0] = prod["h0"][row].to(state.lat.dtype)
    return state


def _slot_iteration(model: UnifiedVoice, cfg: GPTConfig, gen: GenerationConfig, state: SlotState, knobs,
                    pos_off: int, row: torch.Tensor) -> None:
    """One slot step; every write is in place, and the cursor and the tick
    are device scalars, so the step reads no host value. `knobs`: the four
    dynamic knobs as [n_slots] attributes; a sampled row takes its uniform
    from row `row` ([1] long, the step's place in its block) of state.u."""
    s_len = state.mask.shape[1]
    max_new = state.codes.shape[1]
    stop = cfg.stop_mel_token
    rows = torch.arange(state.codes.shape[0], device=state.codes.device)
    act = state.active.clone()
    wp = (state.cursor % s_len).reshape(1)
    # slot wp is invalid for every active row: a row's span never laps the cursor
    logits = _decode_step(model, cfg, state.cur, state.i_b + pos_off, state.cache, wp, state.mask,
                          return_hidden=state.lat is not None)
    if state.lat is not None:
        logits, hnorm = logits
    lf = process_logits(
        logits, seen_mask=state.seen, repetition_penalty=knobs.repetition_penalty,
        typical_sampling=gen.typical_sampling, typical_mass=knobs.typical_mass, temperature=knobs.temperature,
        top_k=gen.top_k if gen.do_sample else 0, top_p=knobs.top_p, do_sample=gen.do_sample,
    )
    nxt = sample_token(lf, block_row(state.u, row)) if gen.do_sample else greedy_token(lf)
    nxt = torch.where(act, nxt, torch.full_like(nxt, stop))
    # indexed writes at each row's own index; an inactive row writes back what it holds
    # (a boolean row selection would cost a host round trip per step)
    widx = (state.i_b + 1).clamp(max=max_new - 1)
    state.codes[rows, widx] = torch.where(act, nxt, state.codes[rows, widx])
    state.seen[rows, nxt] = state.seen[rows, nxt] | act
    if state.lat is not None:
        state.lat[rows, widx] = torch.where(act[:, None], hnorm.to(state.lat.dtype), state.lat[rows, widx])
    write_at(state.mask, 1, wp, act)  # the cursor column becomes attendable for the rows that really wrote
    newly_done = act & ((nxt == stop) | (state.i_b + 1 >= max_new - 1))
    state.i_b.copy_(torch.where(act, state.i_b + 1, state.i_b))
    state.cur.copy_(torch.where(act, nxt, state.cur))
    state.active.copy_(act & ~newly_done)
    state.done |= newly_done
    state.tick.add_(1)
    state.cursor.copy_((state.cursor + 1) % s_len)


# the dynamic knobs of a slot step, each [n_slots]
_KNOBS = ("temperature", "top_p", "repetition_penalty", "typical_mass")


@torch.no_grad()
def slot_steps(model: UnifiedVoice, cfg: GPTConfig, gen: GenerationConfig, state: SlotState, n_steps: int,
               generator: torch.Generator, temperature: Knob = 1.0, top_p: Knob = 0.8,
               repetition_penalty: Knob = 10.0, typical_mass: Knob = 0.9, pos_off: int = 2,
               graphs: Optional[GraphStage] = None) -> SlotState:
    """Run up to `n_steps` decode steps at the shared cursor, ending early
    when no row is active. The sampling knobs are floats or [n_slots]
    tensors, one value per row (the session sets a row's at admission, so
    requests with different knobs share the batch). Row r decodes at mel
    position i_b[r] + pos_off; inactive rows emit the stop code. The state,
    allocated once per session by slot_state_init, is the static buffers of
    its key in `graphs`, the engine's slot stage (without one, a stage that
    never captures; the knobs are copied into [n_slots] buffers each call),
    and the steps run through it in blocks (graphs.GraphStage.run): on a
    CUDA engine a replay of the key's captured block, its uniforms drawn
    into state.u before it, one draw for each step the budget allows. One
    host read a block. Spans (tracing.py): slot.loop around the whole call
    (a knob given as a host tensor is uploaded inside it; `k7_launches` and
    `k8_launches`, the K7 and K8 launches its steps ran), slot.draws around a
    block's draws."""
    b, dev = state.codes.shape[0], state.codes.device
    with tracing.span("slot.loop") as loop_span:
        k7, k8 = ssm_step.launches, gpt2_chains.launches
        knobs = SimpleNamespace(**{name: row_knob(v, b, dev) for name, v in zip(
            _KNOBS, (temperature, top_p, repetition_penalty, typical_mass))})
        stage = stage_or_uncaptured(graphs, dev)
        key = ("slot", b, state.mask.shape[1], gen, state.lat is not None, state.cache[0].dtype == torch.int8,
               state.cache[0].shape[2], pos_off, state.cache[0].dtype, weights_key(model), BLOCK)
        lane = stage.bind(key, state, [(state, ("tick", "cursor", "i_b", "codes", "cache", "active", "done", "seen",
                                                "cur", "mask", "lat", "u")), (knobs, _KNOBS)])
        step = lambda: _slot_iteration(model, cfg, gen, state, knobs, pos_off, lane.ctl.ran)
        live = lambda: state.active.any()
        done = 0
        while done < n_steps:
            if state.u is not None:
                steps = min(BLOCK, n_steps - done)
                with tracing.span("slot.draws", steps=steps):
                    for j in range(steps):
                        state.u[j].copy_(uniforms((b,), generator, dev))
            ran, alive = stage.run(lane, step, live, n_steps - done)
            done += ran
            if not alive:
                break
        loop_span.set(k7_launches=ssm_step.launches - k7, k8_launches=gpt2_chains.launches - k8)
    return state


def slot_lengths(codes: torch.Tensor, stop_token: int) -> torch.Tensor:
    """Each row's generated length: its first stop code + 1, or max_new (as
    generate_speech counts)."""
    is_stop = codes == stop_token
    return torch.where(is_stop.any(dim=1), torch.argmax(is_stop.int(), dim=1) + 1,
                       torch.full((codes.shape[0],), codes.shape[1], dtype=torch.long, device=codes.device))
