"""Whole runs of tiny cells on the CPU: a cell added from new files alone,
in a directory of its own, is found and run without an edit; every entry
driver's run comes out correct; and the check fails a run whose timed path
is broken underneath, once for each fault a served cell can have."""

import json
import os

import numpy as np
import pytest

import run
import tiny
from portbench.cell import Cell

SEED = 2**31 + 101


def _run(root, name, seconds=1.5, trace=False):
    return run.run_cell(name, SEED, seconds, trace, root=root, device="cpu",
                        cell=Cell(root, name, os.path.join(root, "benchmark")))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("name", ["slots-mixed", "batch-offline", "single-beam"])
def test_each_driver_runs_correct(root, name):
    out = _run(root, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert list(out)[-1] == "checks"


def test_a_cell_added_from_new_files(root, tmp_path):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "batch-duo", "config": "indextts-1.5-serve", "traffic": "batch-duo",
                              "chips": 1, "why": "a mix added by files alone"})
    with open(os.path.join(root, "benchmark", "workloads", "batch-offline.json")) as f:
        mix = json.load(f)
    mix["call"]["requests"] = 2
    with open(os.path.join(root, "benchmark", "workloads", "batch-duo.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "benchmark", "limits", "batch-duo.json"), "w") as f:
        json.dump(tiny.LIMITS, f)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "batch-offline" in m["workloads"]:
            m["workloads"].append("batch-duo")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    out = _run(root, "batch-duo")
    assert out["correct"], out["checks"]
    assert "audio_s_per_s" in out["metrics"]


def test_traced_run_reads_per_layer_metrics_without_a_card(root):
    # on the CPU no profiled window opens: the trace readers find nothing and
    # are left out; the counters' readers still read
    out = _run(root, "batch-offline", trace=True)
    assert "engine.decode_ms_per_step" in out["metrics"] and "graphs.window_captures" in out["metrics"]
    assert "setup_s" not in out["metrics"]


# the faults: each patches the program underneath the harness


def _alter_a_token(monkeypatch):
    from indextts_tpu_torch.ops import sampling

    orig = sampling.inverse_cdf_token

    def bad(logits, u):
        tok = orig(logits, u)
        return torch_flip(tok, logits)

    def torch_flip(tok, logits):
        worst = logits.float().argmin(dim=-1)
        return worst.where(tok % 7 == 3, tok)

    monkeypatch.setattr(sampling, "inverse_cdf_token", bad)


def _alter_a_beam_token(monkeypatch):
    from indextts_tpu_torch.models import gpt_decode

    orig = gpt_decode._select_successors

    def bad(logp_joint, generator, gen, nb):
        vals, idx = orig(logp_joint, generator, gen, nb)
        return vals, idx.where(idx % 7 != 3, idx + 1)

    monkeypatch.setattr(gpt_decode, "_select_successors", bad)


def _alter_the_answer(monkeypatch):
    from indextts_tpu_torch import engine

    orig = engine.IndexTTS._emit

    def bad(self, wav, output_path, sr):
        wav = np.asarray(wav).copy()
        wav[..., wav.shape[-1] // 2:] //= 2
        return orig(self, wav, output_path, sr)

    monkeypatch.setattr(engine.IndexTTS, "_emit", bad)


def _leave_half_the_batch_out(monkeypatch):
    from indextts_tpu_torch import engine

    orig = engine.IndexTTS._vocode_many

    def bad(self, chunks):
        out = orig(self, chunks)
        return [w if i % 2 == 0 else np.zeros_like(w) for i, w in enumerate(out)]

    monkeypatch.setattr(engine.IndexTTS, "_vocode_many", bad)


def _step_returns_its_state(monkeypatch):
    from indextts_tpu_torch.models import gpt

    def bad(self, x, k_cache, v_cache, pos, bias, heads):
        return x  # the block's step leaves the hidden state as it came

    monkeypatch.setattr(gpt.GPT2Block, "step", bad)


@pytest.mark.parametrize("fault,cells", [
    (_alter_a_token, ["slots-mixed", "batch-offline"]),
    (_alter_a_beam_token, ["single-beam"]),
    (_alter_the_answer, ["slots-mixed", "batch-offline", "single-beam"]),
    (_leave_half_the_batch_out, ["batch-offline"]),
    (_step_returns_its_state, ["batch-offline", "single-beam"]),
])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault, cells):
    fault(monkeypatch)
    for name in cells:
        out = _run(root, name, seconds=1.0)
        assert not out["correct"], (fault.__name__, name, out["checks"])


def test_the_control_fails_the_limits(root):
    # the reference computed in fp8 in the program's place reads beyond the
    # cell's limits (here the tiny cells'; on the card, PERF.md's readings)
    import control

    r = control.readings("slots-mixed", SEED, 1.5, True, root=root, device="cpu",
                         cell=Cell(root, "slots-mixed", os.path.join(root, "benchmark")))
    assert r["ctrl_wav_rel_err"] > tiny.LIMITS["wav_rel_err"] or r["ctrl_logit_gap"] > tiny.LIMITS["logit_gap"]
    assert r["wav_rel_err"] <= tiny.LIMITS["wav_rel_err"] and r["logit_gap"] <= tiny.LIMITS["logit_gap"]
    # the verdict run_cell gives the control is the same summary every run's check gives
    assert r["ctrl_correct"] is False and r["correct"] is True
