"""The arithmetic of the metrics, shared by the readers in benchmark/metrics/
(one file a metric). Each reader takes the run's observations and returns a
number, or None when the run holds nothing to read (the harness then leaves
the metric out of the result line)."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from counts import flops as F
from portbench.trace import own


def tail(waits: List[float], missing: List[float], q: float) -> Optional[float]:
    """The q-quantile (nearest rank) of all requests' waits, where a request
    that never finished ranks beyond every finished one; if the rank falls
    among those, the wait they had reached when the loop ended, the largest
    (a lower bound of theirs)."""
    n = len(waits) + len(missing)
    if n == 0:
        return None
    rank = max(math.ceil(q * n), 1)
    done = sorted(waits)
    if rank <= len(done):
        return done[rank - 1]
    return max(missing)


def request_tail(obs: Dict[str, Any], stream: bool, mark: str, q: float) -> Optional[float]:
    """The q-tail of (mark - due) over the window's streaming (or whole-file)
    requests. In a traced run, over those due before the profiler opened
    (its start holds the host for seconds, which every request then in
    flight would carry), a request without its mark by then ranking beyond
    the others at the wait it had reached."""
    cut = obs.get("opened")
    cut = None if cut is None else cut - obs["t0"]
    reqs = [r for r in obs["requests"] if bool(r.get("stream")) == stream and (cut is None or r["due"] < cut)]
    got = [r for r in reqs if r.get(mark) is not None and r.get("out") is not None and (cut is None or r[mark] <= cut)]
    waits = [r[mark] - r["due"] for r in got]
    missing = [(r["cut_at"] if cut is None else cut) - r["due"] for r in reqs if not any(r is g for g in got)]
    return tail(waits, missing, q)


def audio_rate(obs: Dict[str, Any]) -> Optional[float]:
    calls = obs.get("calls")
    if not calls:
        return None
    return sum(c["stats"]["audio_s"] for c in calls) / obs["window_s"]


def decode_ms_per_step(obs: Dict[str, Any]) -> Optional[float]:
    calls = obs.get("calls") or []
    steps = sum(c["stats"]["gpt_steps"] for c in calls)
    return 1e3 * sum(c["stats"]["gpt_gen_s"] for c in calls) / steps if steps else None


def vocoder_ms_per_audio_s(obs: Dict[str, Any]) -> Optional[float]:
    calls = obs.get("calls") or []
    audio = sum(c["stats"]["audio_s"] for c in calls)
    return 1e3 * sum(c["stats"]["bigvgan_s"] for c in calls) / audio if audio else None


def _events(obs: Dict[str, Any]) -> List[Any]:
    """The window's graph events, up to the profiler's close in a traced run
    (closing it holds the host for seconds, which an open loop's queue
    would carry into every later count)."""
    until = obs.get("until")
    return [e for e in obs["rec"].events if until is None or e[0] <= until]


def chunk_ms_per_step(obs: Dict[str, Any]) -> Optional[float]:
    """A slot session's decode chunk wall time per step: the chunks' summed
    seconds (SlotSession.chunk_s) over the steps the slot blocks ran, over
    the ticks up to the profiler's close in a traced run."""
    until = obs.get("until")
    steps = sum(int(e[3] or 0) for e in _events(obs) if e[1] == "slot" and e[2] in ("replay", "run", "warm"))
    secs = sum(s for t, s in obs.get("ticks", []) if s is not None and (until is None or obs["t0"] + t <= until))
    return 1e3 * secs / steps if steps else None


def window_captures(obs: Dict[str, Any]) -> int:
    """Warm runs and captures of any graph stage inside the window (up to
    the profiler's close in a traced run)."""
    return sum(1 for e in _events(obs) if e[2] in ("warm", "capture"))


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    """The share of [a0, a1] inside [b0, b1] (a point counts whole inside)."""
    if a1 <= a0:
        return 1.0 if b0 <= a0 <= b1 else 0.0
    return max(0.0, min(a1, b1) - max(a0, b0)) / (a1 - a0)


def kernel_roofline(obs: Dict[str, Any], function: str) -> Optional[float]:
    """A kernel's bound over its own device time in the traced window, in %:
    the bound seconds that the frozen counts gave the window's work for the
    kernel (Recorder.bounds, by its __global__ function's name), over the
    own time of the profiler's events of that function (the trace's
    `kernels`). None where the window ran none of it, or no work named it."""
    tr = obs.get("trace")
    if not tr:
        return None
    own_s, _launches = own(tr["kernels"], function)
    if own_s <= 0:
        return None
    bound = sum(_overlap(t0, t1, tr["start"], tr["stop"]) * b.get(function, 0.0) for t0, t1, b in obs["rec"].bounds)
    return 100.0 * bound / own_s if bound else None


def idle_share(obs: Dict[str, Any]) -> Optional[float]:
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def step_mfu(obs: Dict[str, Any]) -> Optional[float]:
    """The model FLOPs of the work done in the traced window over the card's
    dense bf16 peak for the window's length, in %."""
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    work = sum(_overlap(t0, t1, tr["start"], tr["stop"]) * f for t0, t1, f in obs["rec"].work)
    return 100.0 * work / (tr["window_s"] * F.PEAK_BF16) if work else None
