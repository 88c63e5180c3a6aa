"""Entry driver: a continuous-batching slot session (SlotSession.submit /
tick, the core of the server's --slot-batching dispatcher) under open-loop
arrivals.

Requests are submitted when due, whatever the session is doing: between
ticks, the driver submits every request whose time has come, then ticks
while anything is in flight, and sleeps only when nothing is. A streaming
request's first audio is the first on_chunk call; a whole-file request's
audio is its result from tick(). Times run from when a request was due.
After the window, requests keep arriving (the mix's tail) until every
request due inside the window has finished, or `drain_s` has passed.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Dict, List

import numpy as np

from portbench import observe, traffic


def _session_kwargs(mix: Dict[str, Any]) -> Dict[str, Any]:
    s = mix["session"]
    return {"n_slots": s["n_slots"], "chunk_steps": s["chunk_steps"], "stream_overlap_codes": s["stream_overlap_codes"],
            "max_text_tokens_per_sentence": s["max_text_tokens_per_sentence"]}


def _gen(mix: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in mix["generation"].items() if k != "num_beams"}


def warm(ctx) -> None:
    """Capture every key the mix reaches, through the engine's public entry
    points: per prompt frame bucket of the mix's range, the engine's warmup
    of a streamed request (the slot block, the prefill, the conditioning,
    and the streamed windows' vocoder calls at every batch size); then slot
    sessions drained with whole-file requests of each bucket at each batch
    size up to a quarter of the slots (a tick vocodes the whole-file
    requests of one bucket that finished in it in one call, its batch
    padded to a power of two; a batch of more than n_slots / 4 of one
    bucket would need a queue of some n_slots requests), of one-sentence
    and of two-sentence width, each request with its own prompt (new
    voices admitted in one tick share a conditioning call per bucket).
    Buckets share a session while their requests fit its slots; all are
    admitted in its first tick and finish in one."""
    eng, mix = ctx.engine, ctx.mix
    rng = np.random.default_rng([int(ctx.seed), 9])
    s = mix["session"]
    lo, hi = mix["prompts"]["frames"]
    buckets = sorted({max(-(-f // 100) * 100, 100) for f in range(lo, hi + 1)})
    frames = [min(b, hi) for b in buckets]
    max_split = s["max_text_tokens_per_sentence"]
    one_row = [traffic.sentence(rng, n) for n in range(16, max_split + 1, 8)]
    half = max_split // 2 + 1
    two_rows = traffic.sentence(rng, half) + " " + traffic.sentence(rng, half)
    kw = dict(_gen(mix), **{k: v for k, v in _session_kwargs(mix).items() if k != "n_slots"})
    for f in frames:
        eng.warmup(texts=[one_row[0]], prompt=traffic.prompt_mel(rng, f), n_slots=s["n_slots"], streaming=True,
                   verbose=False, **kw)
    sizes = [1 << i for i in range(6) if 1 << i <= s["n_slots"] // 4]
    for k in sizes:
        one = [one_row[j % len(one_row)] for j in range(k)]
        for texts, rows in ((one, k), ([two_rows] + one[1:], k + 1)):
            if rows == 1:  # one request of one sentence: the streamed warm-up's whole-file twin
                continue
            per = max(s["n_slots"] // rows, 1)
            for at in range(0, len(frames), per):
                sess = eng.slot_session(n_slots=s["n_slots"], **kw)
                for f in frames[at : at + per]:
                    for t in texts:
                        sess.submit(traffic.prompt_mel(rng, f), t)
                sess.drain()


def measure(ctx, seconds: float) -> Dict[str, Any]:
    eng, mix, rec = ctx.engine, ctx.mix, ctx.rec
    reqs = traffic.open_loop(mix, ctx.seed, seconds)
    sess = eng.slot_session(seed=ctx.seed, **_session_kwargs(mix), **_gen(mix))
    observe.instrument_session(sess, rec)
    ctx.session = sess
    by_rid: Dict[int, Dict[str, Any]] = {}
    counted = [r for r in reqs if r["counted"]]
    left = len(counted)
    drain = float(mix.get("drain_s", 60.0))
    ticks: List[Any] = []
    longest: List[float] = []  # each tick's seconds, for the report
    t0 = time.perf_counter()
    i = 0

    def on_chunk_for(req):
        def cb(_rid, chunk):
            if req.get("first_at") is None:
                req["first_at"] = time.perf_counter() - t0
            req["chunks"].append(chunk)
        return cb

    while True:
        now = time.perf_counter() - t0
        while i < len(reqs) and reqs[i]["due"] <= now:
            r = reqs[i]
            over = {"top_p": 0.0} if r["greedy"] else {}
            if r["stream"]:
                r["chunks"] = []
            with rec.span("submit"):
                rid = sess.submit(r["mel"], r["text"], on_chunk=on_chunk_for(r) if r["stream"] else None, **over)
            r["submitted_at"] = time.perf_counter() - t0
            by_rid[rid] = r
            i += 1
        if left == 0 or now > seconds + drain:
            break
        if sess.busy:
            ctx.boundary(time.perf_counter())
            n_chunks = len(sess.chunk_s)
            with rec.span("tick"):
                done = sess.tick()
            end = time.perf_counter() - t0
            ticks.append((end, sess.chunk_s[-1] if len(sess.chunk_s) > n_chunks else None))
            longest.append(end - now)
            for rid, res in done:
                r = by_rid.pop(rid)
                r["done_at"] = end
                r["out"] = {"chunks": r["chunks"]} if r["stream"] else {"wav": np.asarray(res[1]).reshape(-1)}
                if r["counted"]:
                    left -= 1
        elif i < len(reqs):
            time.sleep(max(0.0, min(reqs[i]["due"] - now, 0.005)))
    end = time.perf_counter() - t0
    for r in counted:
        r["cut_at"] = end
    late = np.array([r["submitted_at"] - r["due"] for r in counted if "submitted_at" in r])
    report = [f"{len(counted)} requests due in {seconds:.1f} s at {mix['rate_per_s']} /s "
              f"({sum(r['stream'] for r in counted)} streaming); {len(ticks)} ticks; "
              f"finished {sum(r.get('out') is not None for r in counted)}; the loop ended at {end:.2f} s",
              f"submission lateness: median {np.median(late):.4f} s, max {late.max():.4f} s"]
    for stream, mark in ((True, "first_at"), (False, "done_at")):
        w = [r[mark] - r["due"] for r in counted if r["stream"] == stream and r.get(mark) is not None]
        if w:
            report.append(f"{'streaming to first chunk' if stream else 'whole-file to wav'}: {len(w)} finished, "
                          f"median {np.median(w):.4f} s, p90 {sorted(w)[-(-9 * len(w) // 10) - 1]:.4f} s, "
                          f"mean {np.mean(w):.4f} s, max {max(w):.4f} s")
    tk = np.asarray(longest or [0.0])
    report.append(f"ticks: longest {tk.max():.4f} s, {int((tk > 0.25).sum())} over 0.25 s ({tk[tk > 0.25].sum():.3f} s); "
                  f"graph warm runs and captures in the window by stage "
                  f"{dict(Counter(e[1] for e in rec.events if e[2] in ('warm', 'capture')))}; preset voices "
                  f"{len({r['voice'] for r in counted if r['voice'] is not None})}")
    return {"window_s": seconds, "requests": counted, "ticks": ticks, "t0": t0, "report": report}


def path(ctx) -> Dict[str, Any]:
    """How the session served its requests, for the reference's check."""
    mix, e = ctx.mix, ctx.cfg["engine"]
    g = mix["generation"]
    s = mix["session"]
    return {"pos_off": 1 if e["fast_latents"] else 2, "quant_kv": e["quant_kv"], "beams": False,
            "knobs": {k: g[k] for k in ("do_sample", "top_k", "top_p", "temperature", "repetition_penalty")},
            "max_split": s["max_text_tokens_per_sentence"], "vocode": "pairs", "stream_vocode": "stream",
            "chunk_steps": s["chunk_steps"], "overlap": s["stream_overlap_codes"], "max_new": g["max_mel_tokens"]}


def release(ctx) -> None:
    ctx.session = None
