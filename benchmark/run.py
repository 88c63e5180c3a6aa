"""Run one benchmark cell of the PyTorch / CUDA port (indextts_tpu_torch) once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Loads the cell's configuration with weights made
from the seed, warms the shapes its traffic reaches (set-up), drives the
traffic for --seconds, checks what was served against the plain reference
(benchmark/reference/), and prints one JSON line last on standard output:
correct, attempted, failed, the metrics (--trace 0: the cell's end-to-end
metrics; --trace 1: its per-layer metrics, read from one profiled
sub-window), the device, and last the numbers compared with their limits.
Needs a CUDA device; exits non-zero, printing no result, without one.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from contextlib import redirect_stdout  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)  # the program under test, from the checkout

# top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "indextts_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, each name
    compared whole (indextts_tpu_torch is not indextts_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _caches(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(root, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")


class Ctx:
    """What a driver works with: the engine, the recorder, the cell's mix
    and configuration, the seed, and the traced sub-window's boundary hook."""

    def __init__(self, cell, engine, rec, seed: int, device, tracer=None):
        self.cell, self.engine, self.rec, self.seed, self.device = cell, engine, rec, seed, device
        self.mix, self.cfg = cell.mix, cell.config
        self.tracer = tracer
        self.pool = None  # a driver's preset voices, made by its warm-up or its first call

    def boundary(self, now: float) -> None:
        if self.tracer is not None:
            self.tracer.boundary(now)


def open_engine(cell, seed: int, device, root: str = ROOT):
    """The system under test for `cell` with the seed's weights, and the
    benchmark's recorder on it. The configuration the engine reads goes to
    a fixed directory of the run's TMPDIR (or of the checkout's build/)."""
    from portbench import observe
    from portbench import setup as S

    _caches(root)
    workdir = os.path.join(os.environ.get("TMPDIR") or os.path.join(root, "build"), "portbench-" + cell.name)
    eng = S.engine(cell.reference, cell.config, seed, device, workdir)
    rec = observe.Recorder(cell.config, cell.counts)
    observe.instrument_engine(eng, rec)
    return eng, rec


def run_cell(workload: str, seed: int, seconds: float, trace: bool, root: str = ROOT, device: str = "cuda",
             cell=None, warm: bool = True, control: bool = False) -> Dict[str, Any]:
    """One run of one cell; returns the result line's object. `device` and
    `cell` are for the CPU tests (a tiny configuration); a run of the
    benchmark takes the CUDA device and the cell as BENCHMARK.json states it.
    `warm` and `control` are for the readings that set the limits
    (control.py): without the warm-up, the window's traffic captures each
    key as it first reaches it; with `control`, the control (the reference
    in the precision below the configuration's) is judged on the same
    sample beside the program, and its numbers and verdict come back under
    "control"."""
    from portbench.cell import Cell

    cell = cell or Cell(root, workload)
    import torch

    if device == "cuda":
        chips = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"run.py: the cell needs {chips} CUDA device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            sys.exit(3)
    from portbench import judge
    from portbench import setup as S
    from portbench.trace import Tracer

    eng, rec = open_engine(cell, seed, device, root)
    tracer = Tracer(rec, device=device, **cell.mix["trace"]) if trace else None
    ctx = Ctx(cell, eng, rec, seed, device, tracer)
    if warm:
        cell.driver.warm(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    rec.on = rec.keep_codes = True
    obs = cell.driver.measure(ctx, seconds)
    rec.on = False
    if tracer is not None:
        tracer.finish()
        obs["trace"] = tracer.summary()
        # closing the profiler holds the host for seconds; an open loop's counters stop there
        obs["until"] = tracer.stop
        obs["opened"] = tracer.opened
    obs["rec"], obs["cfg"], obs["mix"] = rec, cell.config, cell.mix
    kind = "per_layer" if trace else "end_to_end"
    metrics: Dict[str, Any] = {}
    for m in cell.metrics(kind):
        value = cell.reader(m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev: Dict[str, Any] = {"platform": "gpu" if device == "cuda" else "cpu",
                           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                           "count": int(cell.entry["chips"]),
                           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0}
    if trace:
        tr = obs.get("trace")
        dev["busy_s"] = tr["busy_s"] if tr else 0.0
        dev["window_s"] = tr["window_s"] if tr else 0.0
        if tr:
            print(f"[{cell.name}] trace: {tr['device_events']} device operations; K1 {tr['k1']}; "
                  f"blocks {tr['blocks']}", file=sys.stderr)
        lost = tr and trace_lost(tr)
        if lost:
            print(f"run.py: {lost}: the profiler lost events; no share is read from this trace", file=sys.stderr)
            sys.exit(4)
    requests = obs["requests"]
    attempted = len(requests)
    failed = sum(1 for r in requests if r.get("out") is None)
    _report(obs, cell.name)
    if trace and device == "cuda":
        print(f"[{cell.name}] step.mfu is against the dense bf16 peak at the card's full power; the card: "
              f"{_power_limit()}", file=sys.stderr)

    # the program's state goes before the reference runs on the same device
    path = cell.driver.path(ctx)
    cell.driver.release(ctx)
    ctx.engine = eng = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    w_gpt, w_voc = S.weights(cell.reference, cell.config, seed, device)
    ref = judge.Model(cell.config, cell.reference, w_gpt, w_voc, device)
    ctl = judge.Model(cell.config, cell.reference, w_gpt, w_voc, device, control=True) if control else None
    del w_gpt, w_voc
    picked = judge.pick(requests, int(cell.mix["judge"]["requests"]), seed)
    results = [judge.judge_request(ref, requests[i], rec.codes, requests[i]["out"], path, ctl,
                                   draws=judge.draw_seed(seed, i)) for i in picked]
    verdict = judge.summarize(results, cell.limits)
    ctl_verdict = judge.summarize([judge.as_control(r) for r in results], cell.limits) if control else None
    print(f"checked {verdict['judged']} requests, {verdict['tokens']} served codes "
          f"({verdict['greedy_tokens']} greedy)", file=sys.stderr)
    if control:
        for name, c in ctl_verdict["checks"].items():
            print(f"control {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
        print(f"control correct = {ctl_verdict['correct']}", file=sys.stderr)
    for name, c in verdict["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: forbidden modules loaded: {bad}", file=sys.stderr)
        sys.exit(5)
    out = {"correct": verdict["correct"], "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if trace and obs.get("trace"):
        out["breakdown"] = {"device_ops": obs["trace"]["device_ops"], "idle_gaps": obs["trace"]["idle_gaps"]}
    if control:
        out["control"] = {"correct": ctl_verdict["correct"], "checks": ctl_verdict["checks"]}
    out["checks"] = verdict["checks"]
    return out


def trace_lost(tr: Dict[str, Any]) -> Optional[str]:
    """Why a traced window cannot be read, or None: the profiler recorded
    fewer K1 launches than the wrapper counted, or the decode blocks'
    kernels do not add up (portbench.trace.Tracer's block check)."""
    if tr["k1"]["seen"] != tr["k1"]["counted"]:
        return f"the trace recorded {tr['k1']['seen']} K1 launches where {tr['k1']['counted']} ran"
    return tr["blocks"].get("lost")


def _report(obs: Dict[str, Any], name: str) -> None:
    """What the metrics are taken from, on standard error: medians and
    sample counts of the latencies, the generator's lateness, the calls."""
    for line in obs.get("report", []):
        print(f"[{name}] {line}", file=sys.stderr)


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them (or why not)."""
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return p.stdout.strip() or f"not read (nvidia-smi exit {p.returncode})"


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # every row runs to its budget by construction (the stop code's bias), which the engine warns of
    warnings.filterwarnings("ignore", message="WARN: generation stopped")
    # the program's own messages go to standard error: the result is standard output's one line
    with redirect_stdout(sys.stderr):
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    print(json.dumps(_finite(out)))


def _finite(v):
    """The result with every number that is not finite as null (strict JSON)."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


if __name__ == "__main__":
    main()
