"""On the card: one short run of a cell through the command the benchmark
states, its last line the result. Skips without a CUDA device (run on the
card with: python -m pytest -m cuda benchmark/tests)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "single-beam", "--seed", str(2**31 + 5),
                        "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
