"""The benchmark's own spans and counters around the program's layers.

The harness wraps a few of the engine's calls on the instance it measures
(the program's code is not changed): each wrapper records a span (name,
host start and end, what the call was given) and, while a profiled window
is open, a torch.profiler range of the same name, so that the device's idle
gaps can be named by what the host was doing. The wrappers also keep what
the check of `correct` reads: the codes each sentence row was served, keyed
by its text tokens.

Spans and layers:
  submit / tick / infer / infer_batch   the entry points (the drivers' own)
  cond      IndexTTS._conditioning      conditioning encoder (conformer + perceiver)
  decode    IndexTTS._gpt_generate      prefill + decode loop of infer / infer_batch
  latent    IndexTTS._gpt_latent        the teacher-forced latent pass
  vocode    IndexTTS._vocoder_call      one vocoder call (BigVGAN + ECAPA), its padded (rows, frames)
  harvest   SlotSession._harvest        a slot tick's harvest (latents, vocoder, results)
Graph events: every decision a graph stage logs (graphs.GraphStage._note),
with its time and lane: captures and warm runs, and the steps each block
replay ran.
Work: the model FLOPs of each call at its true sizes (the architecture's
counts, counts/models/<architecture>.py, and the vocoder's, counts/flops.py),
with the call's host interval: decode rows and steps, admissions' prefills,
latent passes, conditioning passes, and the codes each vocoder call had to
make. Beside them, the bound seconds of each kernel that the counts name for
that work (`bounds`): K1's in each vocoder call as padded, and the
architecture's kernels in its units of work.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from counts import flops as F


class Recorder:
    """Spans, graph events, work and served codes of one run, for the model
    configuration `cfg` ({"gpt": ..., "bigvgan": ..., "engine": ...}) whose
    architecture's counts are the module `counts` (portbench.cell.Cell.counts).
    `on` gates the recording of spans, events and work (the warm-up is not
    recorded); served codes are kept whenever `keep_codes` is set."""

    def __init__(self, cfg: Dict[str, Any], counts):
        self.cfg, self.counts = cfg, counts
        self.g, self.h = cfg["gpt"], cfg["bigvgan"]
        self.on = False
        self.keep_codes = False
        self.profiling = False
        self.spans: List[Tuple[str, float, float, Any]] = []
        self.events: List[Tuple[float, str, str, Any]] = []
        self.work: List[Tuple[float, float, float]] = []
        self.bounds: List[Tuple[float, float, Dict[str, float]]] = []
        self.codes: Dict[Tuple[int, ...], np.ndarray] = {}
        self.slot_steps = 0  # slot steps run since the last harvest

    def did(self, t0: float, flops: float, bounds: Optional[Dict[str, float]] = None) -> None:
        """A call that began at `t0` and ends now did `flops` model FLOPs,
        and `bounds`: the bound seconds of each kernel named for it."""
        if self.on:
            t1 = time.perf_counter()
            self.work.append((t0, t1, flops))
            if bounds:
                self.bounds.append((t0, t1, bounds))

    def cost(self, unit: str, times: int = 1, **sizes) -> Tuple[float, Dict[str, float]]:
        """`times` units of the architecture's work (`unit`, one of its counts'
        functions, at `sizes`): their model FLOPs, and the bound seconds of
        each kernel its counts name for them."""
        flops = times * getattr(self.counts, unit)(self.g, **sizes)
        terms = self.counts.kernels(self.cfg, unit, **sizes)
        return flops, {k: times * F.bound_s(**t) for k, t in terms.items()}

    @contextlib.contextmanager
    def span(self, name: str, info: Any = None):
        t0 = time.perf_counter()
        rf = None
        if self.profiling:
            from torch.profiler import record_function

            rf = record_function(name)
            rf.__enter__()
        try:
            yield
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
            if self.on:
                self.spans.append((name, t0, time.perf_counter(), info))

    def served(self, tokens, codes) -> None:
        """The codes a sentence row was served, up to its stop code."""
        if self.keep_codes:
            c = np.asarray(codes)
            hit = np.nonzero(c == self.g["stop_mel_token"])[0]
            self.codes[tuple(int(t) for t in tokens)] = (c[: hit[0]] if hit.size else c).copy()


def _sum(units) -> Tuple[float, Dict[str, float]]:
    """The model FLOPs and kernel bounds of several Recorder.cost units."""
    work, bounds = 0.0, {}
    for f, b in units:
        work += f
        for k, v in b.items():
            bounds[k] = bounds.get(k, 0.0) + v
    return work, bounds


def _wrap(obj, attr: str, make):
    inner = getattr(obj, attr)
    setattr(obj, attr, make(inner))


def instrument_engine(engine, rec: Recorder) -> None:
    """Wrap the engine's layer calls (on this instance only)."""

    def cond(inner):
        def f(mel, lens):
            t0 = time.perf_counter()
            with rec.span("cond", (int(mel.shape[0]), int(mel.shape[1]))):
                out = inner(mel, lens)
            # rows as called (a batch padded to a power of two counts its padding: reading
            # the lengths back would make the host wait for the device)
            rec.did(t0, *rec.cost("conditioning", int(mel.shape[0]), frames=int(mel.shape[1])))
            return out
        return f

    n_lat = rec.g["condition_num_latent"]

    def decode(inner):
        def f(conds, text_tokens, text_lengths, gen, *a, **kw):
            t0 = time.perf_counter()
            with rec.span("decode", (int(text_tokens.shape[0]), int(gen.num_beams))):
                codes, lengths, lat, steps = inner(conds, text_tokens, text_lengths, gen, *a, **kw)
            units = []
            for r in range(text_tokens.shape[0]):
                rec.served(text_tokens[r, : int(text_lengths[r])], codes[r, : int(lengths[r])])
                p = n_lat + int(text_lengths[r]) + 3
                units += [rec.cost("prefill", p=p),
                          rec.cost("decode_steps", gen.num_beams, p=p, first=0, steps=int(steps))]
            rec.did(t0, *_sum(units))
            return codes, lengths, lat, steps
        return f

    def latent(inner):
        def f(conds, text_tokens, codes, code_lens, text_lengths=None):
            t0 = time.perf_counter()
            with rec.span("latent", (int(text_tokens.shape[0]), int(text_tokens.shape[1]), int(codes.shape[1]))):
                out = inner(conds, text_tokens, codes, code_lens, text_lengths)
            tl = np.full(text_tokens.shape[0], text_tokens.shape[1]) if text_lengths is None else text_lengths
            rec.did(t0, *_sum(rec.cost("latent_pass", t=n_lat + int(a) + 2 + int(b) + 2)
                              for a, b in zip(np.asarray(tl).reshape(-1), np.asarray(code_lens).reshape(-1)) if b > 1))
            return out
        return f

    def vocoder_call(inner):
        def f(latent, mel_ref, lens, *a, **kw):
            t0 = time.perf_counter()
            rows, frames = int(latent.shape[0]), int(latent.shape[1])
            with rec.span("vocode", (rows, frames, int(mel_ref.shape[1]))):
                out = inner(latent, mel_ref, lens, *a, **kw)
            # K1's work as the call is padded; its model FLOPs are the valid codes' (_vocode*)
            rec.did(t0, 0.0, {F.K1_KERNEL: F.k1_bound_s(F.k1_elements(rec.h, rows, frames))})
            return out
        return f

    def vocode_one(inner):
        def f(latent, n_valid, prompt_mel):
            t0 = time.perf_counter()
            out = inner(latent, n_valid, prompt_mel)
            rec.did(t0, F.vocoder(rec.h, int(n_valid)))
            return out
        return f

    def vocode_many(inner):
        def f(chunks):
            t0 = time.perf_counter()
            out = inner(chunks)
            rec.did(t0, sum(F.vocoder(rec.h, int(n)) for _lat, n, _mel in chunks))
            return out
        return f

    _wrap(engine, "_conditioning", cond)
    _wrap(engine, "_gpt_generate", decode)
    _wrap(engine, "_gpt_latent", latent)
    _wrap(engine, "_vocoder_call", vocoder_call)
    _wrap(engine, "_vocode", vocode_one)
    _wrap(engine, "_vocode_many", vocode_many)
    for stage in engine._graphs.stages():
        _wrap(stage, "_note", lambda inner, name=stage.name: _note(inner, name, rec))


def _note(inner, stage: str, rec: Recorder):
    def f(event, key, n, detail=None):
        if stage == "slot" and event in ("replay", "run", "warm"):
            rec.slot_steps += int(detail or 0)
        if rec.on:
            rec.events.append((time.perf_counter(), stage, event, detail, (key, n)))
        return inner(event, key, n, detail)
    return f


def instrument_session(sess, rec: Recorder) -> None:
    """Wrap a SlotSession's harvest: it records the codes of every row that
    the tick's snapshot shows finished (the rows the harvest takes off), and
    the tick's decode work: each live row's steps in the chunk (the slot
    stage's blocks report the steps they ran) and the prefills of the rows
    admitted in it."""

    n_lat = rec.g["condition_num_latent"]

    def harvest(inner):
        def f(snap):
            t0 = time.perf_counter()
            steps, rec.slot_steps = rec.slot_steps, 0
            if snap is not None:
                seq, done, i_b, codes = snap
                units = []
                for slot, row in enumerate(sess.slots):
                    if row is None or row["admit_seq"] > seq:
                        continue
                    p = n_lat + int(row["tokens"].shape[1]) + 3
                    if row["admit_seq"] == seq:  # admitted in this tick: its prefill, then i_b steps
                        units.append(rec.cost("prefill", p=p))
                    ran = min(steps, int(i_b[slot]))
                    units.append(rec.cost("decode_steps", p=p, first=int(i_b[slot]) - ran, steps=ran))
                    if done[slot]:
                        rec.served(row["tokens"][0], codes[slot])
                rec.did(t0, *_sum(units))
            with rec.span("harvest"):
                return inner(snap)
        return f

    _wrap(sess, "_harvest", harvest)

