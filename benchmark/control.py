"""Readings that set a cell's limits: the program's numbers over many seeds,
and the control's (the reference computed in fp8, the step below the bf16
the configurations state) over the first few, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,... --control 3 \
        --seconds 10 --out build/control_<cell>.json

Each seed is one run of the cell (run.run_cell) without the warm-up, for
--seconds at the cell's own load (its captures happen as the traffic first
reaches each key, which changes no output), judged on the run's sample as
every run is. On the first --control seeds the control is judged too, on
the same prompts and served codes: at each step the code it draws from its
own support (for greedy rows, the code it puts first), and its waveform;
its verdict against the cell's limits is printed beside the program's. The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402


def readings(workload: str, seed: int, seconds: float, control: bool, **kw) -> dict:
    """One seed's numbers: the program's checks and, with `control`, the
    control's checks and verdict."""
    out = run.run_cell(workload, seed, seconds, False, warm=False, control=control, **kw)
    row = {"seed": seed, "correct": out["correct"], **{k: c["value"] for k, c in out["checks"].items()}}
    if control:
        row["ctrl_correct"] = out["control"]["correct"]
        row.update({"ctrl_" + k: c["value"] for k, c in out["control"]["checks"].items()})
    return row


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", type=int, default=3, help="judge the control on the first N seeds")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    rows = []
    for k, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        with run.redirect_stdout(sys.stderr):
            r = readings(a.workload, seed, a.seconds, k < a.control)
        r["seconds"] = time.perf_counter() - t
        rows.append(r)
        print(json.dumps(r), file=sys.stderr, flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
