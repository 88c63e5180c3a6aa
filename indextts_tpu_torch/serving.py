"""SlotSession: the continuous-batching serving loop over models/gpt_slots
(port of indextts_tpu/serving.py).

The latency-oriented serving mode: a persistent decode batch with rolling
admission. A request submitted while others are mid-decode starts at the next
chunk boundary (chunk_steps decode steps) instead of waiting for the running
batch to finish; engine.infer_batch, the throughput mode, runs each batch to
completion.

What the slots pay for that: the circular KV cache is sized for the worst row
(the longest prefill + max_new), so every step attends over the whole cache,
where a one-piece decode with a segment-grown cache reads less on young
sequences. quant_kv halves that read.

Greedy outputs equal engine.infer per request
(tests/test_torch_slot_session.py; the row-wise contract is held at the model
level in tests/test_torch_slots.py). The static generation knobs are fixed
for a session; the dynamic knobs ride per-row columns, as infer_batch's
BATCH_DYNAMIC_PARAMS do.

The JAX session reads each chunk's done / i_b / codes snapshot one tick late,
to hide a device round trip behind the next chunk. Here the loop is eager and
the snapshot is read right after its chunk, so a row completes in the tick
that finishes it. The admit_seq guard stays: a snapshot never harvests a slot
that was admitted after it was taken.
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch.engine import _round_up
from indextts_tpu_torch.models.gpt_slots import slot_admit, slot_prefill, slot_state_init, slot_steps
from indextts_tpu_torch.parallel.mesh import local_heads


#: the dynamic knobs a slot row can override per request: those of
#: engine.BATCH_DYNAMIC_PARAMS that the slot step uses. length_penalty is left
#: out: it shapes beam scores only and slot mode is num_beams=1, so taking it
#: would be a silent no-op.
SLOT_DYNAMIC_PARAMS = ("temperature", "top_p", "repetition_penalty", "typical_mass")


class SlotSession:
    """One live slot-decoding session bound to an IndexTTS engine.

    submit() enqueues a request (its text may split into several sentence
    rows); tick() admits pending rows into free slots, runs one decode chunk,
    harvests the rows that finished, and returns the requests completed in
    this tick as (request_id, result) pairs, result as engine.infer returns
    it ((sr, wav int16 [S, 1]) or the written output path). drain() ticks
    until everything submitted has completed."""

    def __init__(
        self,
        engine,
        n_slots: int = 8,
        chunk_steps: int = 25,
        max_text_tokens_per_sentence: int = 120,
        stream_overlap_codes: int = 8,
        seed: int = 0,
        verbose: bool = False,
        **generation_kwargs,
    ):
        if generation_kwargs.get("num_beams", 1) not in (None, 1):
            raise ValueError("slot mode decodes with num_beams=1 (use infer/infer_batch for beam search)")
        if engine.cfg.gpt.condition_type == "conformer_encoder":
            # that type's conditioning length depends on the prompt's frames, so
            # the fixed sizing below (condition_num_latent) would under-size
            # the circular cache and fail slot_admit's capacity check mid-serving
            raise ValueError("slot mode requires a fixed conditioning-latent count; "
                             "condition_type='conformer_encoder' produces frame-dependent conds "
                             "(use infer/infer_batch)")
        gen, base_dyn, self.max_mel_tokens = engine._parse_generation_kwargs(generation_kwargs, force_num_beams=1)
        self.engine = engine
        self.gen = gen
        self.base_dyn = base_dyn
        self.n_slots = n_slots
        self.chunk_steps = chunk_steps
        self.stream_overlap = max(0, int(stream_overlap_codes))
        self.verbose = verbose
        self.max_split = engine._clamp_split_len(max_text_tokens_per_sentence)
        self.pos_off = 1 if engine.fast_latents else 2
        cfg = engine.cfg.gpt
        # the longest prefill: cond latents + the largest text bucket + the start
        # and stop text tokens + start_mel; the bucket is engine._text_bucket's,
        # which admission pads to
        p_max = cfg.condition_num_latent + engine._text_bucket(self.max_split) + 3
        self.cache_len = _round_up(p_max + gen.max_new_tokens, 64)
        self.state = slot_state_init(cfg, gen, n_slots, self.cache_len, engine.dtype, device=engine.device,
                                     capture_latents=engine.fast_latents, quant_kv=engine.quant_kv,
                                     heads=local_heads(engine.gpt))
        self.generator = torch.Generator(device=engine.device).manual_seed(seed)
        # the width of a streaming row's latent window: one vocoder shape wherever the window sits
        self._win_w = min(chunk_steps + self.stream_overlap + 1, gen.max_new_tokens)
        # per-row dynamic sampling columns (host copies, uploaded per chunk)
        self.dyn_cols = {name: np.full((n_slots,), float(base_dyn[name]), np.float32) for name in SLOT_DYNAMIC_PARAMS}
        self.pending: deque = deque()
        self.slots: List[Optional[Dict[str, Any]]] = [None] * n_slots
        self.requests: Dict[int, Dict[str, Any]] = {}
        self._next_rid = 0
        self._warned_max = False
        # _seq counts the chunks run; a row records the first chunk that includes
        # it, and a snapshot harvests only rows with admit_seq <= its seq: a done
        # flag from before a slot was reused must never harvest the new occupant
        self._seq = 0
        # wall time of each tick's decode chunk, for whoever measures the session
        self.chunk_s: List[float] = []
        # rows whose latents took the teacher-forced pass (0 while the captured latents served)
        self.tf_latent_rows = 0

    # ------------------------------------------------------------------

    def submit(self, prompt, text: str, output_path: Optional[str] = None, on_chunk=None,
               **per_request_kwargs) -> int:
        """Enqueue one request. Returns its id; the result comes from a later
        tick() / drain(). per_request_kwargs: SLOT_DYNAMIC_PARAMS only.

        `on_chunk(rid, wav_chunk)` makes the request STREAMING: each tick
        delivers the newly decoded audio (int16 [samples] mono, 24 kHz,
        infer_stream's window and overlap trim) while the request is still
        decoding. The chunks concatenated ARE the final result (as many
        samples as the non-streamed slot output; values may differ at window
        boundaries within the vocoder's edge tolerance, as in infer_stream).
        It needs a fast_latents engine (the chunk latents are captured during
        the decode); silence removal is skipped (the audio has already left);
        a streaming request of several sentences decodes its rows one after
        another, so that chunks arrive in playback order. on_chunk must not
        raise: an exception leaves tick() mid-harvest."""
        eng = self.engine
        bad = set(per_request_kwargs) - set(SLOT_DYNAMIC_PARAMS)
        if bad:
            raise ValueError(
                f"per-request overrides in slot mode are allowed only for {SLOT_DYNAMIC_PARAMS} "
                f"(length_penalty only affects beams and slot mode is num_beams=1); got {sorted(bad)}")
        if on_chunk is not None and self.state.lat is None:
            raise ValueError("streaming slot requests need a fast_latents=True engine "
                             "(chunk latents are captured during decode)")
        mel = eng._resolve_prompt(prompt)
        conds = eng._conds_for(mel)
        sents = eng.tokenizer.split_sentences(eng.tokenizer.tokenize(text), self.max_split)
        if not sents:
            raise ValueError("text is empty (nothing to synthesize)")
        dyn = {k: float(per_request_kwargs.get(k, self.base_dyn[k])) for k in SLOT_DYNAMIC_PARAMS}
        eng._agree("submit", sents, mel.shape, dyn, on_chunk is not None)
        rid = self._next_rid
        self._next_rid += 1
        token_rows = [np.asarray(eng.tokenizer.convert_tokens_to_ids(s), np.int64)[None, :] for s in sents]
        self.requests[rid] = {
            "mel": mel, "n_rows": len(sents), "rows": {}, "output_path": output_path,
            "submitted": time.perf_counter(), "on_chunk": on_chunk, "chunks": [],
            "row_tokens": token_rows, "next_row": 1, "conds": conds, "dyn": dyn,
        }
        # streaming rows decode one after another; the others all queue at once
        for j in range(1 if on_chunk is not None else len(token_rows)):
            self.pending.append(self._row_job(rid, j))
        return rid

    def _row_job(self, rid: int, j: int) -> Dict[str, Any]:
        """The work item of one sentence row (submit() and the harvest's
        queue-the-next-row path both build it here)."""
        req = self.requests[rid]
        return {"rid": rid, "row": j, "tokens": req["row_tokens"][j], "conds": req["conds"], "dyn": req["dyn"],
                "stream": req["on_chunk"] is not None, "emitted": 0}

    # ------------------------------------------------------------------

    def _admit_one(self, row: Dict[str, Any], slot: int) -> None:
        eng = self.engine
        cfg = eng.cfg.gpt
        t = row["tokens"]
        padded = np.full((1, eng._text_bucket(t.shape[1])), cfg.stop_text_token, np.int64)
        padded[:, : t.shape[1]] = t
        prod = slot_prefill(
            eng.gpt, cfg, self.gen, row["conds"].to(eng.dtype), torch.from_numpy(padded).to(eng.device),
            torch.tensor([t.shape[1]], dtype=torch.long, device=eng.device), self.generator,
            temperature=row["dyn"]["temperature"], top_p=row["dyn"]["top_p"],
            repetition_penalty=row["dyn"]["repetition_penalty"], typical_mass=row["dyn"]["typical_mass"],
            capture_latents=eng.fast_latents, quant_kv=eng.quant_kv,
        )
        self.state = slot_admit(self.state, prod, slot, cfg)
        for k, col in self.dyn_cols.items():
            col[slot] = row["dyn"][k]
        row["admit_seq"] = self._seq + 1  # the first chunk that includes this row
        self.slots[slot] = row

    def _harvest(self, snap) -> List[Tuple[int, Any]]:
        """Take the finished rows off the state, resolve their latents (the
        captured ones, or one batched teacher-forced pass), vocode every
        request completed in this tick in one batched call, and return the
        results. `snap` is the (seq, done, i_b, codes) host copy taken after
        this tick's chunk, or None when no chunk ran. A done row is inert, so
        its codes and captured latents are final; the admit_seq guard skips
        slots admitted after the snapshot."""
        eng = self.engine
        fin: List[int] = []
        if snap is not None:
            seq, done, _ib, codes_all = snap
            fin = [i for i, r in enumerate(self.slots) if r is not None and done[i] and r["admit_seq"] <= seq]
        if not fin and not any(len(req["rows"]) == req["n_rows"] for req in self.requests.values()):
            # nothing finished and nothing completable (a cancelled request can
            # become completable with no live rows)
            return []
        if snap is None:
            codes_all = self.state.codes.cpu().numpy()
        is_stop = codes_all == eng.stop_mel_token
        lens_all = np.where(is_stop.any(axis=1), is_stop.argmax(axis=1) + 1, codes_all.shape[1])
        pending_tf = []  # (slot, row, codes, code_lens) for the teacher-forced pass
        stream_fin = []  # (slot, row, n): streaming rows finish by a last chunk
        for slot in fin:
            row = self.slots[slot]
            n = max(int(lens_all[slot]), 1)
            if (not self._warned_max and n >= self.gen.max_new_tokens
                    and codes_all[slot, -1] != eng.stop_mel_token):
                warnings.warn(f"WARN: generation stopped due to exceeding `max_mel_tokens` ({self.max_mel_tokens}).",
                              category=RuntimeWarning)
                self._warned_max = True
            if row.get("stream"):
                # no silence removal for a streamed row. The stop code itself is
                # NOT vocoded: remove_long_silence trims AT the stop and
                # infer_stream ends there, so the streamed sample count matches both
                n_voc = n - 1 if codes_all[slot, n - 1] == eng.stop_mel_token else n
                stream_fin.append((slot, row, n_voc))
                self.slots[slot] = None
                continue
            code_row = codes_all[slot : slot + 1, :n]
            codes, code_lens = eng.remove_long_silence(code_row, silent_token=52, max_consecutive=30)
            if self.state.lat is not None and np.array_equal(codes, code_row[:, : codes.shape[1]]):
                latent = self.state.lat[slot, : codes.shape[1]].clone()[None]
                self.requests[row["rid"]]["rows"][row["row"]] = (latent, int(code_lens[0]))
            else:
                pending_tf.append((slot, row, codes, code_lens))
            self.slots[slot] = None  # the slot is free; admission resets its flags
        if pending_tf:
            lats = eng._gpt_latent_many([(row["conds"], row["tokens"], cd, cl) for _s, row, cd, cl in pending_tf])
            self.tf_latent_rows += len(pending_tf)
            for (_s, row, cd, cl), lat in zip(pending_tf, lats):
                self.requests[row["rid"]]["rows"][row["row"]] = (lat, int(np.asarray(cl).reshape(-1)[0]))
        if stream_fin:
            # the last window (the codes since the last emission), then queue the
            # request's next sentence row
            todo = [(slot, row, self._win_start(row["emitted"]), n) for slot, row, n in stream_fin
                    if n > row["emitted"]]
            if todo:
                self._emit_stream_chunks(todo)
            for _slot, row, _n in stream_fin:
                req = self.requests[row["rid"]]
                req["rows"][row["row"]] = True  # the audio is already in req["chunks"]
                if not req.get("cancelled") and req["next_row"] < req["n_rows"]:
                    j = req["next_row"]
                    req["next_row"] += 1
                    self.pending.append(self._row_job(row["rid"], j))
        # assemble and vocode every request completed in this tick, in one
        # batched vocoder pass across requests
        completed = [rid for rid, req in self.requests.items() if len(req["rows"]) == req["n_rows"]]
        results: List[Tuple[int, Any]] = []
        if completed:
            chunk_list, chunk_rid = [], []
            for rid in completed:
                req = self.requests[rid]
                if req["on_chunk"] is not None:
                    continue
                rows = [req["rows"][j] for j in range(req["n_rows"])]
                for k in range(0, len(rows), 2):  # chunks of two sentences, as infer_batch
                    part = rows[k : k + 2]
                    chunk_list.append((torch.cat([lat for lat, _ in part], dim=1), sum(nv for _, nv in part),
                                       req["mel"]))
                    chunk_rid.append(rid)
            wavs = eng._vocode_many(chunk_list) if chunk_list else []
            for rid in completed:
                req = self.requests.pop(rid)
                if req["on_chunk"] is not None:
                    # streamed: the delivered chunks ARE the result (none when
                    # every row stopped at once)
                    parts = [c[None, :] for c in req["chunks"]]
                else:
                    # none is legal: a request cancelled before any row was admitted
                    parts = [w for w, r in zip(wavs, chunk_rid) if r == rid]
                wav = np.concatenate(parts, axis=1) if parts else np.zeros((1, 0), np.int16)
                results.append((rid, eng._emit(wav, req["output_path"], 24000)))
                if self.verbose:
                    print(f">> slot request {rid} done in {time.perf_counter() - req['submitted']:.2f}s "
                          f"({wav.shape[-1] / 24000:.2f}s audio)")
        return results

    # ------------------------------------------------------------------

    def cancel(self, rid: int) -> None:
        """Abandon a request (a streaming client went away, say): rows not yet
        admitted are dropped, live rows stop decoding at the next tick (their
        flags flip to done; the slot is harvested and freed like any finished
        row), and no further sentence row is queued. The request still
        completes through tick() with the audio produced so far."""
        if rid not in self.requests:
            return
        self.pending = deque(r for r in self.pending if r["rid"] != rid)
        req = self.requests[rid]
        req["cancelled"] = True
        live = 0
        for slot, row in enumerate(self.slots):
            if row is not None and row["rid"] == rid:
                live += 1
                self.state.active[slot] = False
                self.state.done[slot] = True
        # completion now needs only the rows already harvested and the live ones
        # (0 when nothing was ever admitted: the request completes on the next tick)
        req["n_rows"] = len(req["rows"]) + live

    def _win_start(self, emitted: int) -> int:
        """Where a streaming emission's window starts: the overlap's context
        behind the last emitted code, clamped so that the fixed-width window
        stays inside the latent buffer."""
        start = max(emitted - self.stream_overlap, 0)
        return max(min(start, self.gen.max_new_tokens - self._win_w), 0)

    def _window(self, slot: int, start: int, n_valid: int) -> torch.Tensor:
        """[1, _win_w, D]: the slot's latents from `start`, zeroed from
        n_valid on (the padding _vocode_many itself would add)."""
        win = self.state.lat[slot, start : start + self._win_w].clone()
        win[n_valid:] = 0
        return win[None]

    def _emit_stream_chunks(self, todo) -> None:
        """Vocode the streaming windows (slot, row, start, n_now) in ONE
        batched vocoder call and hand each trimmed chunk to its request's
        on_chunk (int16 [samples], trimmed as infer_stream trims)."""
        eng = self.engine
        spc = eng._samples_per_code()
        wins = [(self._window(slot, start, n_now - start), n_now - start, self.requests[row["rid"]]["mel"])
                for slot, row, start, n_now in todo]
        wavs = eng._vocode_many(wins)
        for (slot, row, start, n_now), wav in zip(todo, wavs):
            chunk = wav[0, (row["emitted"] - start) * spc:]
            req = self.requests[row["rid"]]
            req["chunks"].append(chunk)
            req["on_chunk"](row["rid"], chunk)
            row["emitted"] = n_now

    def _stream_emit(self, snap) -> None:
        """Once per tick: vocode every ACTIVE streaming row's newly decoded
        window (rows that finished get their last chunk from _harvest, with
        the stop code's length rule). Positions below a row's i_b were each
        written once and never change."""
        rows = [(s, r) for s, r in enumerate(self.slots) if r is not None and r.get("stream")]
        if not rows or snap is None:
            return
        seq, done, i_b, _codes = snap
        todo = []
        for slot, row in rows:
            if done[slot] or row["admit_seq"] > seq:
                continue
            n_now = int(i_b[slot]) + 1
            if n_now <= row["emitted"]:
                continue
            todo.append((slot, row, self._win_start(row["emitted"]), n_now))
        if todo:
            self._emit_stream_chunks(todo)

    # ------------------------------------------------------------------

    def tick(self) -> List[Tuple[int, Any]]:
        """One scheduler cycle: admit pending rows into free slots, run one
        decode chunk, read the rows' done / i_b / codes, emit the streaming
        rows' chunks and harvest what finished. A row admitted in this tick is
        in this tick's chunk."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        while free and self.pending:
            self._admit_one(self.pending.popleft(), free.pop(0))
        snap = None
        if any(r is not None for r in self.slots):
            dev = self.engine.device
            cols = {k: torch.from_numpy(v).to(dev) for k, v in self.dyn_cols.items()}
            t0 = time.perf_counter()
            self.state = slot_steps(
                self.engine.gpt, self.engine.cfg.gpt, self.gen, self.state, self.chunk_steps, self.generator,
                temperature=cols["temperature"], top_p=cols["top_p"],
                repetition_penalty=cols["repetition_penalty"], typical_mass=cols["typical_mass"],
                pos_off=self.pos_off,
            )
            self._seq += 1
            st = self.state
            snap = (self._seq, st.done.cpu().numpy(), st.i_b.cpu().numpy(), st.codes.cpu().numpy())
            self.chunk_s.append(time.perf_counter() - t0)
            self._stream_emit(snap)
        return self._harvest(snap)

    @property
    def busy(self) -> bool:
        # self.requests covers the cancel edge: a fully cancelled request with no
        # live rows still needs one tick to hand out its result
        return bool(self.pending) or any(r is not None for r in self.slots) or bool(self.requests)

    def drain(self) -> Dict[int, Any]:
        """tick() until every submitted request has completed."""
        out: Dict[int, Any] = {}
        guard = 0
        while self.busy:
            for rid, res in self.tick():
                out[rid] = res
            guard += 1
            if guard > 100000:
                raise RuntimeError("slot session failed to drain")
        return out
