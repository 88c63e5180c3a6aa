"""BENCHMARK.json keeps to the benchmark's contract: its keys, names and
units of the allowed characters, every cell reporting set-up, another
end-to-end metric and a per-layer one, and a file for everything it names."""

import json
import os
import re

import pytest

from portbench.cell import Cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def spec():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_command(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert 1 <= len(spec["command"]) <= 32 and all(_line(w) for w in spec["command"])
    assert not any(w.startswith("/") or ".." in w for w in spec["command"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51


def test_names_units_and_entries(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"]) and os.path.exists(os.path.join(ROOT, c["file"]))
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in spec[kind]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _reports(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_every_cell_reports_what_it_must(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        cell = w["name"]
        mine = [m["name"] for m in spec["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2, cell
        layers = [m for m in spec["per_layer"] if _reports(m, cell)]
        assert layers, cell
        for m in layers:  # the end-to-end metric a per-layer one moves is reported where it is
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
    for c in spec["configs"]:
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)


def test_a_file_for_everything_named(spec):
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            arch = json.load(f)["architecture"]
        for part in ("reference", "counts"):
            assert os.path.exists(os.path.join(BENCH, part, "models", arch + ".py")), (c["name"], part)
    for w in spec["workloads"]:
        with open(os.path.join(BENCH, "workloads", w["traffic"] + ".json")) as f:
            mix = json.load(f)
        assert os.path.exists(os.path.join(BENCH, "drivers", mix["entry"] + ".py"))
        assert os.path.exists(os.path.join(BENCH, "limits", w["name"] + ".json"))
    cell = Cell(os.path.dirname(BENCH), spec["workloads"][0]["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] != "setup_s":
            assert hasattr(cell.reader(m["name"]), "read"), m["name"]


def test_a_split_metric_reads_with_its_base_reader(spec, tmp_path):
    # step.mfu.slots has no file of its own: it reads with step.mfu's; a
    # file of its own, where a metric has one, comes first
    cell = Cell(os.path.dirname(BENCH), spec["workloads"][0]["name"])
    assert cell.reader("step.mfu.slots").__file__.endswith(os.path.join("metrics", "step.mfu.py"))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "step.mfu.py").write_text("def read(obs):\n    return 1\n")
    (tmp_path / "metrics" / "step.mfu.slots.py").write_text("def read(obs):\n    return 2\n")
    cell.bench_dir = str(tmp_path)
    assert cell.reader("step.mfu.slots").read(None) == 2 and cell.reader("step.mfu.x").read(None) == 1


def test_the_contracts_time_budget(spec):
    # a full check with the 24 cells a benchmark may grow to fits its 43200 s
    cells, rs = 24, spec["run_seconds"]
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
