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


@pytest.mark.parametrize("name", ["slots-mixed", "batch-offline", "single-beam", "batch-offline-serve"])
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


def _files(d):
    out = {}
    for base, _dirs, files in os.walk(d):
        for f in files:
            if "__pycache__" not in base:
                with open(os.path.join(base, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(base, f), d)] = fh.read()
    return out


TOY_SCALED = """

_forward = forward


def forward(*args, **kwargs):
    logits, latents = _forward(*args, **kwargs)
    return 1.5 * logits, latents
"""


@pytest.mark.parametrize("scaled", [False, True], ids=["copy", "logits_x1.5"])
def test_an_architecture_added_from_new_files(tmp_path, scaled):
    # a second architecture, toy-copy, arrives as its reference and counts (here
    # copies of unifiedvoice-gpt2's), a configuration naming it and a cell; no
    # file of the harness changes. Its reference scaling its logits by 1.5 reads
    # `correct` false: the judge calls the reference the configuration names.
    # The cell's mix samples every row from half the probability mass, whose
    # edge a scaled score moves (a greedy row's best it does not)
    root = tiny.make_root(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    before = _files(bench)
    for part in ("reference", "counts"):
        with open(os.path.join(bench, part, "models", "unifiedvoice-gpt2.py")) as f:
            src = f.read()
        with open(os.path.join(bench, part, "models", "toy-copy.py"), "w") as f:
            f.write(src + (TOY_SCALED if scaled and part == "reference" else ""))
    with open(os.path.join(bench, "configs", "indextts-1.5.json")) as f:
        cfg = json.load(f)
    cfg["architecture"] = "toy-copy"
    with open(os.path.join(bench, "configs", "toy-copy.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "workloads", "batch-offline.json")) as f:
        mix = json.load(f)
    mix["generation"].update(top_k=0, top_p=0.5)
    mix["greedy_every"] = 0  # no greedy row
    with open(os.path.join(bench, "workloads", "batch-toy.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "toy", "source": "https://example.org/toy",
                            "file": "benchmark/configs/toy-copy.json", "reduced": [],
                            "why": "a second architecture by files alone"})
    spec["workloads"].append({"name": "batch-toy", "config": "toy", "traffic": "batch-toy", "chips": 1,
                              "why": "the toy architecture under a sampled batch mix"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "batch-offline" in m["workloads"]:
            m["workloads"].append("batch-toy")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(bench, "limits", "batch-toy.json"), "w") as f:
        json.dump(tiny.LIMITS, f)
    cell = Cell(root, "batch-toy", bench)
    assert cell.reference.__file__.endswith(os.path.join("models", "toy-copy.py"))
    out = run.run_cell("batch-toy", SEED, 1.5, False, root=root, device="cpu", cell=cell)
    after = _files(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {os.path.join("reference", "models", "toy-copy.py"),
                                        os.path.join("counts", "models", "toy-copy.py"),
                                        os.path.join("configs", "toy-copy.json"),
                                        os.path.join("workloads", "batch-toy.json"),
                                        os.path.join("limits", "batch-toy.json")}
    assert "audio_s_per_s" in out["metrics"] and out["checks"]["rows_missing"]["value"] == 0
    if scaled:
        assert not out["correct"] and out["checks"]["logit_gap"]["value"] > tiny.LIMITS["logit_gap"], out["checks"]
    else:
        assert out["correct"], out["checks"]


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


def _int8_step_returns_its_state(monkeypatch):
    from indextts_tpu_torch.models import gpt_decode

    def bad(block, x, k8, ks, v8, vs, pos, bias, heads):
        return x  # the block's step through the int8 cache leaves the hidden state as it came

    monkeypatch.setattr(gpt_decode, "_decode_block_q", bad)


@pytest.mark.parametrize("fault,cells", [
    (_alter_a_token, ["slots-mixed", "batch-offline", "batch-offline-serve"]),
    (_alter_a_beam_token, ["single-beam"]),
    (_alter_the_answer, ["slots-mixed", "batch-offline", "single-beam", "batch-offline-serve"]),
    (_leave_half_the_batch_out, ["batch-offline", "batch-offline-serve"]),
    (_step_returns_its_state, ["batch-offline", "single-beam"]),
    (_int8_step_returns_its_state, ["batch-offline-serve", "slots-mixed"]),
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
