"""Entry driver: cross-request batches (IndexTTS.infer_batch) in a closed
loop, one caller sending its next batch when the last one returned.

A call holds `requests` request shapes of the mix. The mix's
`compositions` x `requests` shapes are cut into that many calls, each call
a fixed set of shapes (sentence counts and lengths, voices) from the mix's
shape_seed; the run's seed orders the calls, a new order each round, and
fills in new text and sampling draws. So every seed runs the same calls,
in another order, and the calls differ from one another in rows, text
lengths and voices as an audiobook job's batches do. The warm-up runs each
composition once; the decode, latent and vocoder keys of all of them may
outnumber what the engine's graph stages keep, and the captures that this
costs inside the window are the program's (graphs.window_captures counts
them). The window is whole calls: it runs calls until `seconds` have passed
and ends with the last one.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from portbench import traffic


def _gen(mix: Dict[str, Any]) -> Dict[str, Any]:
    return dict(mix["generation"])


def _shapes(mix: Dict[str, Any]) -> int:
    return int(mix["call"]["compositions"]) * int(mix["call"]["requests"])


def _call(ctx, seed, composition: int, pool) -> List[Dict[str, Any]]:
    """The requests of one call of `composition`, filled in from `seed`."""
    n = int(ctx.mix["call"]["requests"])
    return traffic.requests(ctx.mix, seed, _shapes(ctx.mix), pool,
                            subset=list(range(composition * n, (composition + 1) * n)))


def _order(ctx, round_: int) -> List[int]:
    """The compositions of a round of calls, in the seed's order for it."""
    return [int(c) for c in np.random.default_rng([int(ctx.seed), 5, round_]).permutation(
        int(ctx.mix["call"]["compositions"]))]


def _run(ctx, reqs: List[Dict[str, Any]]):
    c = ctx.mix["call"]
    per = [{"top_p": 0.0} if r["greedy"] else {} for r in reqs]
    with ctx.rec.span("infer_batch"):
        return ctx.engine.infer_batch([(r["mel"], r["text"]) for r in reqs],
                                      max_text_tokens_per_sentence=c["max_text_tokens_per_sentence"],
                                      sentences_bucket_max_size=c["sentences_bucket_max_size"],
                                      per_request_kwargs=per, **_gen(ctx.mix))


def warm(ctx) -> None:
    """One call of each composition (its voices are the run's, its text the
    warm-up's own), which visits every key the window's calls visit and
    caches the voices' conditioning."""
    ctx.pool = traffic.voice_pool(ctx.mix, ctx.seed)
    for c in range(int(ctx.mix["call"]["compositions"])):
        _run(ctx, _call(ctx, [int(ctx.seed), 9, c], c, ctx.pool))


def measure(ctx, seconds: float) -> Dict[str, Any]:
    if ctx.pool is None:  # a run without the warm-up
        ctx.pool = traffic.voice_pool(ctx.mix, ctx.seed)
    calls, reqs = [], []
    t0 = time.perf_counter()
    k, todo = 0, []
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if not todo:
            todo = _order(ctx, k // int(ctx.mix["call"]["compositions"]))
        ctx.boundary(now)
        batch = _call(ctx, [int(ctx.seed), 6, k], todo.pop(0), ctx.pool)
        out = _run(ctx, batch)
        end = time.perf_counter()
        calls.append({"start": now - t0, "end": end - t0, "stats": dict(ctx.engine.last_stats)})
        for r, (_sr, wav) in zip(batch, out):
            r["out"] = {"wav": np.asarray(wav).reshape(-1)}
            r["done_at"] = end - t0
        reqs.extend(batch)
        k += 1
    window = calls[-1]["end"]
    audio = sum(c["stats"]["audio_s"] for c in calls)
    secs = [c["end"] - c["start"] for c in calls]
    report = [f"{len(calls)} calls of {len(batch)} requests in {window:.3f} s, {audio:.2f} s of audio; "
              f"call seconds median {np.median(secs):.4f}",
              "call seconds: " + " ".join(f"{x:.3f}" for x in secs)]
    return {"window_s": window, "calls": calls, "requests": reqs, "t0": t0, "report": report}


def path(ctx) -> Dict[str, Any]:
    mix, e = ctx.mix, ctx.cfg["engine"]
    g = mix["generation"]
    return {"pos_off": 1 if e["fast_latents"] else 2, "quant_kv": e["quant_kv"], "beams": g.get("num_beams", 1) > 1,
            "knobs": {k: g[k] for k in ("do_sample", "top_k", "top_p", "temperature", "repetition_penalty")},
            "max_split": mix["call"]["max_text_tokens_per_sentence"], "vocode": "pairs", "stream_vocode": None}


def release(ctx) -> None:
    ctx.pool = None
