"""The traced sub-window: one torch.profiler window per process, opened and
closed at call or tick boundaries, read once.

What it gives (`Tracer.summary`):
  window_s      the traced window's length on the host clock
  busy_s        the union of the device's operation intervals (kernels,
                copies, sets) inside it; overlapping kernels count once
  kernels       every device operation's own time and launches in the
                window, by its full name (a kernel roofline reads its
                __global__ function's entries, `own`)
  k1            K1's own device time and launches seen (from `kernels`),
                beside the launches its wrapper counted over the window
                (ops/cuda/antialias.launches, which counts replayed
                launches too)
  blocks        the decode loops' block graphs against the replays the
                graph stages logged in the window: each replay launches
                BLOCK predicate kernels (csrc/graph_block.cu), and the
                device operations of one replay (one correlation id) are
                its head, its predicates and its IF bodies' steps, the same
                for every replay of a captured lane that ran as many steps,
                and at least one a step; `lost` says where that fails
  device_ops    the ten device operations that took most time, by name
  idle_gaps     the device's idle time, by the benchmark's span the host was
                in (the innermost one around the gap's middle), largest ten

The profiler's events are taken whole from its results
(kineto_results.events()); nothing is written to disk. One window a process:
after a profiled run of replayed CUDA-graph blocks, a later profile in the
same process has been seen to record fewer kernels than ran.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from counts.flops import K1_KERNEL

PREDICATE_KERNEL = "block_predicate_kernel"


def own(kernels: Dict[str, Dict[str, float]], function: str) -> Tuple[float, int]:
    """The own device time and launches of the kernels whose name holds the
    __global__ function `function`, from a summary's `kernels`."""
    hits = [v for name, v in kernels.items() if function in name]
    return sum(v["own_s"] for v in hits), sum(v["launches"] for v in hits)


class Tracer:
    def __init__(self, rec, after_s: float, seconds: float, device: str = "cuda"):
        self.rec = rec
        self.on_card = device == "cuda"  # no device trace is taken off the card
        self.after_s, self.seconds = float(after_s), float(seconds)
        self.t0: Optional[float] = None  # the measured window's start
        self.opened: Optional[float] = None  # when the profiler's start was called
        self.start: Optional[float] = None
        self.stop: Optional[float] = None
        self._prof = None
        self._k1_before = 0

    def boundary(self, now: float) -> None:
        """Called by a driver between calls or ticks: opens the profiler at
        the first boundary `after_s` into the window, closes it at the first
        one `seconds` later."""
        if not self.on_card:
            return
        if self.t0 is None:
            self.t0 = now
        if self.start is None and now - self.t0 >= self.after_s:
            self._open()
        elif self.start is not None and self.stop is None and now - self.start >= self.seconds:
            self._close()

    def _open(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from indextts_tpu_torch.ops.cuda import antialias

        self.opened = time.perf_counter()
        torch.cuda.synchronize()
        self._k1_before = antialias.launches
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self.rec.profiling = True
        self.start = time.perf_counter()

    def _close(self) -> None:
        import torch

        from indextts_tpu_torch.ops.cuda import antialias

        torch.cuda.synchronize()
        self.stop = time.perf_counter()
        self.rec.profiling = False
        self._prof.stop()
        self.k1_launches = antialias.launches - self._k1_before

    def finish(self) -> None:
        """Close a window still open at the end of the measured window."""
        if self.start is not None and self.stop is None:
            self._close()

    def summary(self) -> Optional[Dict[str, Any]]:
        if self.stop is None:
            return None
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        dev: List[Tuple[int, int, str]] = []
        notes: List[Tuple[int, int, str]] = []
        launches: Dict[int, List[int]] = defaultdict(lambda: [0, 0, 0])  # correlation id: first start, ops, predicates
        for e in events:
            if e.is_user_annotation():
                # the benchmark's spans: their host ranges name the idle gaps; the
                # device-side copies of the same ranges are no device operation
                if e.device_type() == DeviceType.CPU:
                    notes.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
                g = launches[e.correlation_id()]
                g[0] = min(g[0], e.start_ns()) if g[1] else e.start_ns()
                g[1] += 1
                g[2] += PREDICATE_KERNEL in e.name()
        self._prof = None
        by_name: Dict[str, float] = defaultdict(float)
        kernels: Dict[str, Dict[str, float]] = {}
        for s, t, name in dev:
            by_name[name[:120]] += (t - s) * 1e-9
            k = kernels.setdefault(name, {"own_s": 0.0, "launches": 0})
            k["own_s"] += (t - s) * 1e-9
            k["launches"] += 1
        k1_s, k1_n = own(kernels, K1_KERNEL)
        dev.sort()
        busy, gaps = 0, []
        cur_s = cur_t = None
        for s, t, _n in dev:
            if cur_t is None:
                cur_s, cur_t = s, t
            elif s > cur_t:
                busy += cur_t - cur_s
                gaps.append((cur_t, s))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        if cur_t is not None:
            busy += cur_t - cur_s
        window_s = self.stop - self.start
        idle: Dict[str, float] = defaultdict(float)
        # the spans nest (one host thread), so a stack swept in time order
        # holds the innermost open span on top
        notes.sort()
        stack: List[Tuple[int, int, str]] = []
        k = 0
        for a, b in gaps:
            mid = (a + b) // 2
            while k < len(notes) and notes[k][0] <= mid:
                while stack and stack[-1][1] < notes[k][0]:
                    stack.pop()
                stack.append(notes[k])
                k += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            idle[stack[-1][2] if stack else "host, outside the benchmark's spans"] += (b - a) * 1e-9
        edge = window_s - busy * 1e-9 - sum(idle.values())
        if edge > 0:
            idle["before the first or after the last device operation"] += edge
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"window_s": window_s, "busy_s": busy * 1e-9, "start": self.start, "stop": self.stop,
                "kernels": kernels, "k1": {"own_s": k1_s, "seen": k1_n, "counted": self.k1_launches},
                "blocks": self._blocks(launches),
                "device_ops": top(by_name), "idle_gaps": top(idle), "device_events": len(dev)}

    def _blocks(self, launches: Dict[int, List[int]]) -> Dict[str, Any]:
        """The block check (module docstring, `blocks`)."""
        from indextts_tpu_torch.graphs import BLOCK

        replays, gen, lanes = [], defaultdict(int), []
        for t, stage, event, detail, lane in self.rec.events:
            if stage not in ("dec", "slot"):
                continue
            if event == "capture":
                gen[lane] += 1
            elif event == "replay" and self.start <= t <= self.stop:
                replays.append(int(detail))
                lanes.append((stage, repr(lane), gen[lane]))
        seen = sorted((g for g in launches.values() if g[2]), key=lambda g: g[0])
        out: Dict[str, Any] = {"replays": len(replays), "steps": sum(replays),
                               "predicates": sum(g[2] for g in seen), "expected": BLOCK * len(replays),
                               "launches": len(seen), "lost": None}
        if out["predicates"] != out["expected"]:
            out["lost"] = (f"the trace recorded {out['predicates']} block predicate launches where "
                           f"{out['expected']} ran ({len(replays)} block replays of {BLOCK} IF steps)")
            return out
        if len(seen) != len(replays) or any(g[2] != BLOCK for g in seen):
            # the predicates do not group by launch: the per-launch check cannot be made
            out["per_launch"] = False
            return out
        out["per_launch"] = True
        ops: Dict[Tuple[Any, int], int] = {}
        for g, ran, lane in zip(seen, replays, lanes):
            body = g[1] - BLOCK
            if ran and body < ran + 1:
                out["lost"] = f"a block replay of {ran} steps recorded {body} operations besides its predicates"
                return out
            if ops.setdefault((lane, ran), body) != body:
                out["lost"] = (f"two replays of one lane, {ran} steps each, recorded {ops[(lane, ran)]} and {body} "
                               f"operations besides their predicates")
                return out
        return out
