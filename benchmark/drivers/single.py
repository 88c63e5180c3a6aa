"""Entry driver: one client calling IndexTTS.infer (the CLI's and the web
UI's default path) in a closed loop, each request after the last returned.

The requests are the mix's shapes (`requests` of them), in the seed's order
and then again in another, with new text and prompts each round, sent one
after another until `seconds` have passed; the window is whole requests and
ends with the last.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np

from portbench import traffic


def _gen(mix: Dict[str, Any]) -> Dict[str, Any]:
    return dict(mix["generation"])


def warm(ctx) -> None:
    """Through the engine's warmup: one request per text bucket the mix's
    sentence rows reach (the decode, latent and vocoder keys hold the text
    bucket), each prompt frame bucket of the mix's prompt range among them
    (the conditioning and vocoder keys hold the frame bucket)."""
    eng, mix = ctx.engine, ctx.mix
    rng = np.random.default_rng([int(ctx.seed), 9])
    max_split = mix["max_text_tokens_per_sentence"]
    lo, hi = mix["sentences"]["tokens"]
    rows = list(range(lo, max_split + 1, 8))
    lo_f, hi_f = mix["prompts"]["frames"]
    frames = sorted({max(-(-f // 100) * 100, 100) for f in range(lo_f, hi_f + 1)})
    for j in range(max(len(rows), len(frames))):
        mel = traffic.prompt_mel(rng, min(frames[j % len(frames)], hi_f))
        eng.warmup(texts=[traffic.sentence(rng, rows[j % len(rows)])], prompt=mel, verbose=False,
                   max_text_tokens_per_sentence=max_split, **_gen(mix))


def measure(ctx, seconds: float) -> Dict[str, Any]:
    mix = ctx.mix
    calls, done = [], []
    t0 = time.perf_counter()
    round_, reqs = 0, []
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if not reqs:
            reqs = traffic.requests(mix, [int(ctx.seed), 6, round_], int(mix["requests"]))
            round_ += 1
        r = reqs.pop(0)
        ctx.boundary(now)
        with ctx.rec.span("infer"):
            _sr, wav = ctx.engine.infer(r["mel"], r["text"], max_text_tokens_per_sentence=mix["max_text_tokens_per_sentence"],
                                        **_gen(mix))
        end = time.perf_counter()
        calls.append({"start": now - t0, "end": end - t0, "stats": dict(ctx.engine.last_stats)})
        r["out"] = {"wav": np.asarray(wav).reshape(-1)}
        r["done_at"] = end - t0
        done.append(r)
    window = calls[-1]["end"]
    audio = sum(c["stats"]["audio_s"] for c in calls)
    report = [f"{len(calls)} requests in {window:.3f} s, {audio:.2f} s of audio; "
              f"request seconds median {np.median([c['end'] - c['start'] for c in calls]):.4f}"]
    return {"window_s": window, "calls": calls, "requests": done, "t0": t0, "report": report}


def path(ctx) -> Dict[str, Any]:
    mix, e = ctx.mix, ctx.cfg["engine"]
    g = mix["generation"]
    return {"pos_off": 1 if e["fast_latents"] else 2, "quant_kv": e["quant_kv"], "beams": g.get("num_beams", 3) > 1,
            "knobs": {k: g[k] for k in ("do_sample", "top_k", "top_p", "temperature", "repetition_penalty")},
            "max_split": mix["max_text_tokens_per_sentence"], "vocode": "sentence", "stream_vocode": None}


def release(ctx) -> None:
    pass
