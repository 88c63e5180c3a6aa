"""What a cell is made of, found by name: BENCHMARK.json's entries, the
configuration file, the architecture it names (its plain reference,
benchmark/reference/models/<architecture>.py, and its frozen counts,
benchmark/counts/models/<architecture>.py), the traffic mix
(benchmark/workloads/<traffic>.json), the cell's limits
(benchmark/limits/<cell>.json), its entry driver
(benchmark/drivers/<entry>.py) and each metric's reader
(benchmark/metrics/<metric>.py, or its base's for a split metric). Adding
a cell, a mix, a metric or an architecture adds files and entries; nothing
here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: str) -> ModuleType:
    """The module in the file at `path`, named by its file and the two
    folders above it (an architecture's reference and counts share a file
    name)."""
    parts = os.path.normpath(os.path.splitext(path)[0]).split(os.sep)[-3:]
    name = "portbench_" + "_".join(parts).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of BENCHMARK.json's workloads, with everything it names."""

    def __init__(self, root: str, name: str, bench_dir: str = BENCH_DIR):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        conf = [c for c in self.spec["configs"] if c["name"] == self.entry["config"]][0]
        self.config = load_json(os.path.join(root, conf["file"]))
        self.mix = load_json(os.path.join(bench_dir, "workloads", self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bench_dir, "limits", name + ".json"))
        self.driver = load_module(os.path.join(bench_dir, "drivers", self.mix["entry"] + ".py"))
        arch = self.config["architecture"] + ".py"
        self.reference = load_module(os.path.join(bench_dir, "reference", "models", arch))
        self.counts = load_module(os.path.join(bench_dir, "counts", "models", arch))
        self.bench_dir = bench_dir

    def metrics(self, kind: str) -> List[Dict[str, Any]]:
        """The cell's end_to_end or per_layer metrics: those that list it, or
        list no cells (setup_s is the harness's own)."""
        return [m for m in self.spec[kind] if m["name"] != "setup_s"
                and ("workloads" not in m or self.name in m["workloads"])]

    def reader(self, metric: str) -> ModuleType:
        """metrics/<metric>.py; a metric split by the end-to-end metric it
        moves (<base>.<part>, such as step.mfu.slots) without a file of its
        own reads with its base's reader."""
        name = metric
        while True:
            path = os.path.join(self.bench_dir, "metrics", name + ".py")
            if os.path.exists(path) or "." not in name:
                return load_module(path)
            name = name.rsplit(".", 1)[0]
