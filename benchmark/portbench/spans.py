"""The arithmetic of the metrics read from the program's own spans
(indextts_tpu_torch/tracing.py), shared by their readers in
benchmark/metrics/. The program records its spans only while a profiler
runs, so they cover the traced sub-window; a span counts when it lies
wholly inside it (`obs["trace"]`'s start and stop, perf_counter seconds;
the spans' t0 / t1 are perf_counter nanoseconds). A reader returns None
without a trace or without such spans, and so on a program that has no
spans (no indextts_tpu_torch.tracing).

A span record is (id, parent, name, t0, t1, attrs), as tracing.spans()
gives it; each function takes the records as an argument for the tests,
else reads the program's ring."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

Record = Sequence[Any]


def program_spans() -> List[Record]:
    try:
        from indextts_tpu_torch import tracing
    except ImportError:  # a program without spans
        return []
    return tracing.spans()


def in_window(obs: Dict[str, Any], records: Optional[List[Record]] = None) -> List[Record]:
    """The spans that lie wholly inside the traced window, in order."""
    tr = obs.get("trace")
    if not tr:
        return []
    lo, hi = tr["start"] * 1e9, tr["stop"] * 1e9
    return [s for s in (program_spans() if records is None else records) if lo <= s[3] and s[4] <= hi]


def _admits(obs, records) -> List[Record]:
    return [s for s in in_window(obs, records) if s[2] == "slot.admit"]


def admit_wait_ms(obs: Dict[str, Any], records: Optional[List[Record]] = None) -> Optional[float]:
    """The mean wait of a slot row for its admission, from its queueing
    (submit, or the harvest that queued a streamed request's next row) to
    the start of its slot.admit span, over the window's admissions."""
    waits = [s[5]["waited_ns"] for s in _admits(obs, records)]
    return 1e-6 * sum(waits) / len(waits) if waits else None


def admit_ms_per_row(obs: Dict[str, Any], records: Optional[List[Record]] = None) -> Optional[float]:
    """The mean length of the window's slot.admit spans: a row's prefill
    and its write into the slot state."""
    spans = _admits(obs, records)
    return 1e-6 * sum(s[4] - s[3] for s in spans) / len(spans) if spans else None


def _is(span: Record, kind: str) -> bool:
    return span[2].endswith("." + kind)


def block_ms_per_step(obs: Dict[str, Any], records: Optional[List[Record]] = None) -> Optional[float]:
    """The decode blocks' host time per step they ran: the replays' spans
    (<stage>.block with event replay: the replay and its one read) summed,
    over the steps they ran. Warm and eager blocks are left out."""
    replays = [s for s in in_window(obs, records) if _is(s, "block") and s[5].get("event") == "replay"]
    steps = sum(int(s[5]["ran"]) for s in replays)
    return 1e-6 * sum(s[4] - s[3] for s in replays) / steps if steps else None


def loop_host_ms_per_block(obs: Dict[str, Any], records: Optional[List[Record]] = None) -> Optional[float]:
    """The decode loops' host time outside their blocks, per block: over the
    window's <stage>.loop spans, each one's length less its child blocks'
    (the bind, the knobs' upload, the draws, the loop's own bookkeeping),
    over the number of those blocks."""
    spans = in_window(obs, records)
    loops = {s[0]: s for s in spans if _is(s, "loop")}
    blocks = [s for s in spans if _is(s, "block") and s[1] in loops]
    if not blocks:
        return None
    inside = sum(s[4] - s[3] for s in blocks)
    outside = sum(s[4] - s[3] for s in loops.values()) - inside
    return 1e-6 * outside / len(blocks)
