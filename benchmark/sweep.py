"""Find an open-loop cell's knee: the highest arrival rate the system
sustains. One engine, warmed once; for each rate, the cell's mix at that
rate for --seconds, then the latencies of the requests due in the first and
the second half of the window (a queue that grows makes the second half
wait longer) and how long after the window the last of them finished.

    python3 benchmark/sweep.py --workload slots-mixed --seed 7 --seconds 20 --rates 4,6,8,10

The rate is then fixed in the mix's file; the benchmark's runs never sweep.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True, help="comma-separated requests per second")
    a = p.parse_args()
    from portbench.cell import Cell

    cell = Cell(run.ROOT, a.workload)
    with run.redirect_stdout(sys.stderr):
        eng, rec = run.open_engine(cell, a.seed, "cuda")
        ctx = run.Ctx(cell, eng, rec, a.seed, "cuda")
        cell.driver.warm(ctx)
    for rate in (float(r) for r in a.rates.split(",")):
        cell.mix = ctx.mix = dict(cell.mix, rate_per_s=rate)
        rec.on = True
        with run.redirect_stdout(sys.stderr):
            obs = cell.driver.measure(ctx, a.seconds)
        rec.on = False
        captures = sum(1 for e in rec.events if e[2] == "capture")
        rec.events.clear()
        rec.spans.clear()
        rec.work.clear()
        reqs = obs["requests"]
        half = a.seconds / 2
        row = {"rate": rate, "requests": len(reqs), "finished": sum(r.get("out") is not None for r in reqs),
               "last_done_after_window_s": max((r.get("done_at") or r["cut_at"]) for r in reqs) - a.seconds,
               "captures": captures}
        for kind, mark in (("stream", "first_at"), ("whole", "done_at")):
            for part, sel in (("first_half", lambda r: r["due"] < half), ("second_half", lambda r: r["due"] >= half)):
                w = [r[mark] - r["due"] for r in reqs if bool(r["stream"]) == (kind == "stream") and sel(r)
                     and r.get(mark) is not None]
                row[f"{kind}_{part}_p50"] = float(np.median(w)) if w else None
                row[f"{kind}_{part}_p90"] = float(np.quantile(w, 0.9)) if w else None
        print(json.dumps(row), flush=True)
        cell.driver.release(ctx)


if __name__ == "__main__":
    main()
