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
with one scale per head pair and position), not the head-paired one. The
admission and the per-row writes of codes / seen / latents are indexed
writes, the plain form on a GPU (the JAX package uses roll-pad-where and
dense masked selects because XLA on a TPU serializes scatters). The loop is
eager; the step counter and the cursor live on the host.

Greedy slot decode equals `generate_speech` token for token per row, for
rows admitted mid-decode, across the cache wrap and after slot reuse
(tests/test_torch_slots.py). Sampling rows draw one uniform per row and step
from one generator. Forced mel prefixes and beams are not supported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models.gpt import UnifiedVoice
from indextts_tpu_torch.models.gpt_decode import GenerationConfig, _decode_step, prefill_decode_state
from indextts_tpu_torch.ops.sampling import Knob, greedy_token, process_logits, sample_token


@dataclass
class SlotState:
    """The rolling decode state ([B] = n_slots, [S] = cache_len). `active`: the
    row is mid-decode. `done`: it finished (stop code, or the codes buffer is
    full) and awaits the host's harvest; inert until admitted anew. A slot
    that is neither is empty. Inactive rows still get the shared cursor
    column written each step, but their mask bit stays False, so it is never
    attended. Updated in place by slot_admit and slot_steps."""

    tick: int              # steps run so far
    cursor: int            # the shared circular write cursor, in [0, S)
    i_b: torch.Tensor      # [B] long, each row's index of its last code
    codes: torch.Tensor    # [B, max_new] long, stop-filled
    cache: Tuple[torch.Tensor, ...]  # (k, v) or int8 (k8, ks, v8, vs)
    active: torch.Tensor   # [B] bool
    done: torch.Tensor     # [B] bool
    seen: torch.Tensor     # [B, V] bool, the repetition penalty's seen set
    cur: torch.Tensor      # [B] long, the last code emitted
    mask: torch.Tensor     # [B, S] bool, each row's valid cache slots
    lat: Optional[torch.Tensor] = None  # [B, max_new, D] captured latents


def slot_state_init(cfg: GPTConfig, gen: GenerationConfig, n_slots: int, cache_len: int, dtype: torch.dtype,
                    device="cpu", capture_latents: bool = False, quant_kv: bool = False,
                    heads: Optional[int] = None) -> SlotState:
    """The empty state. cache_len (S) must reach the longest admitted prefill
    + gen.max_new_tokens (slot_admit checks each admission). `heads`: the
    attention heads of the cache, cfg.heads, or a tensor-parallel shard's
    (parallel/mesh.local_heads)."""
    b, dev = n_slots, torch.device(device)
    h = cfg.heads if heads is None else int(heads)
    shape5 = (cfg.layers, b, h, cache_len, cfg.model_dim // cfg.heads)
    shape4 = (cfg.layers, b, h // 2, cache_len)
    if quant_kv:
        cache = (torch.zeros(shape5, dtype=torch.int8, device=dev), torch.zeros(shape4, device=dev),
                 torch.zeros(shape5, dtype=torch.int8, device=dev), torch.zeros(shape4, device=dev))
    else:
        cache = (torch.zeros(shape5, dtype=dtype, device=dev), torch.zeros(shape5, dtype=dtype, device=dev))
    return SlotState(
        tick=0, cursor=0,
        i_b=torch.zeros(b, dtype=torch.long, device=dev),
        codes=torch.full((b, gen.max_new_tokens), cfg.stop_mel_token, dtype=torch.long, device=dev),
        cache=cache,
        active=torch.zeros(b, dtype=torch.bool, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
        seen=torch.zeros(b, cfg.number_mel_codes, dtype=torch.bool, device=dev),
        cur=torch.full((b,), cfg.stop_mel_token, dtype=torch.long, device=dev),
        mask=torch.zeros(b, cache_len, dtype=torch.bool, device=dev),
        lat=torch.zeros(b, gen.max_new_tokens, cfg.model_dim, dtype=dtype, device=dev) if capture_latents else None,
    )


@torch.no_grad()
def slot_prefill(model: UnifiedVoice, cfg: GPTConfig, gen: GenerationConfig, conds: torch.Tensor,
                 text_tokens: torch.Tensor, text_lengths: torch.Tensor, generator: torch.Generator,
                 temperature: Knob = 1.0, top_p: Knob = 0.8, repetition_penalty: Knob = 10.0,
                 typical_mass: Knob = 0.9, capture_latents: bool = False, quant_kv: bool = False) -> Dict[str, Any]:
    """Prefill ONE request (b = 1) for a later admission, through
    prefill_decode_state with cache_len = p: the one definition of the
    prefill and the first code (input mask, the ids {1, start_mel} that start
    out seen, the first draw) that the one-piece, streaming and segmented
    decodes use. The cache comes back at its own length p."""
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
def slot_admit(state: SlotState, prod: Dict[str, Any], slot: int, cfg: GPTConfig) -> SlotState:
    """Write a prefilled request into slot `slot`, its prefill placed so
    that it ENDS at the shared cursor: columns (cursor - p) mod S .. cursor
    of the slot's own cache plane. The row is reset as a whole, so a
    harvested slot needs no clearing."""
    p = prod["prefill_mask"].shape[1]
    s_len = state.mask.shape[1]
    max_new = state.codes.shape[1]
    if p + max_new > s_len:
        raise ValueError(f"cache_len {s_len} < prefill {p} + max_new {max_new}: the cursor would lap this row's "
                         "own content")
    dev = state.codes.device
    cols = (state.cursor - p + torch.arange(p, device=dev)) % s_len
    for big, small in zip(state.cache, prod["cache"]):
        # big [L, B, H, S, Dh] or the scales [L, B, H/2, S]; small the same with B = 1 and S = p
        big[:, slot][:, :, cols] = small[:, 0].to(big.dtype)
    state.mask[slot] = False
    state.mask[slot, cols] = prod["prefill_mask"][0]
    tok1 = prod["tok1"][0]
    state.codes[slot] = cfg.stop_mel_token
    state.codes[slot, 0] = tok1
    state.seen[slot] = prod["seen1"][0]
    state.cur[slot] = tok1
    state.i_b[slot] = 0
    state.active[slot] = ~prod["done0"][0]
    state.done[slot] = prod["done0"][0]
    if state.lat is not None:
        state.lat[slot] = 0
        state.lat[slot, 0] = prod["h0"][0].to(state.lat.dtype)
    return state


@torch.no_grad()
def slot_steps(model: UnifiedVoice, cfg: GPTConfig, gen: GenerationConfig, state: SlotState, n_steps: int,
               generator: torch.Generator, temperature: Knob = 1.0, top_p: Knob = 0.8,
               repetition_penalty: Knob = 10.0, typical_mass: Knob = 0.9, pos_off: int = 2) -> SlotState:
    """Run up to `n_steps` decode steps at the shared cursor, ending early
    when no row is active. The sampling knobs are floats or [n_slots]
    tensors, one value per row (the session sets a row's at admission, so
    requests with different knobs share the batch). Row r decodes at mel
    position i_b[r] + pos_off; inactive rows emit the stop code."""
    s_len = state.mask.shape[1]
    max_new = state.codes.shape[1]
    stop = cfg.stop_mel_token
    rows = torch.arange(state.codes.shape[0], device=state.codes.device)
    capture = state.lat is not None
    for _ in range(n_steps):
        if not bool(state.active.any()):
            break
        act = state.active
        wp = state.cursor % s_len
        # slot wp is invalid for every active row: a row's span never laps the cursor
        logits = _decode_step(model, cfg, state.cur, state.i_b + pos_off, state.cache, wp, state.mask,
                              return_hidden=capture)
        if capture:
            logits, hnorm = logits
        lf = process_logits(
            logits, seen_mask=state.seen, repetition_penalty=repetition_penalty,
            typical_sampling=gen.typical_sampling, typical_mass=typical_mass, temperature=temperature,
            top_k=gen.top_k if gen.do_sample else 0, top_p=top_p, do_sample=gen.do_sample,
        )
        nxt = sample_token(lf, generator) if gen.do_sample else greedy_token(lf)
        nxt = torch.where(act, nxt, torch.full_like(nxt, stop))
        # indexed writes at each row's own index; an inactive row writes back what it holds
        # (a boolean row selection would cost a host round trip per step)
        widx = (state.i_b + 1).clamp(max=max_new - 1)
        state.codes[rows, widx] = torch.where(act, nxt, state.codes[rows, widx])
        state.seen[rows, nxt] = state.seen[rows, nxt] | act
        if capture:
            state.lat[rows, widx] = torch.where(act[:, None], hnorm.to(state.lat.dtype), state.lat[rows, widx])
        state.mask[:, wp] = act  # the cursor column becomes attendable for the rows that really wrote
        newly_done = act & ((nxt == stop) | (state.i_b + 1 >= max_new - 1))
        state.i_b = torch.where(act, state.i_b + 1, state.i_b)
        state.cur = torch.where(act, nxt, state.cur)
        state.active = act & ~newly_done
        state.done = state.done | newly_done
        state.tick += 1
        state.cursor = (state.cursor + 1) % s_len
    return state


def slot_lengths(codes: torch.Tensor, stop_token: int) -> torch.Tensor:
    """Each row's generated length: its first stop code + 1, or max_new (as
    generate_speech counts)."""
    is_stop = codes == stop_token
    return torch.where(is_stop.any(dim=1), torch.argmax(is_stop.int(), dim=1) + 1,
                       torch.full((codes.shape[0],), codes.shape[1], dtype=torch.long, device=codes.device))
