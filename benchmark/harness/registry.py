"""Find everything a cell needs by the names in ``BENCHMARK.json``: its
configuration file, its traffic mix ``traffic/<traffic>.json`` (which
names the driver ``drivers/<driver>.py`` that reads it), its limits
``limits/<cell>.json``, and the reader ``metrics/<metric>.py`` of each
per-layer metric. A later change adds a cell, a mix or a metric as new
files and entries; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its files resolved."""

    def __init__(self, root: str, name: str, bench_dir: str = BENCH_DIR):
        self.root = root
        self.bench_dir = bench_dir
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        conf = [c for c in self.bench["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = load_json(os.path.join(root, conf["file"]))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bench_dir, "limits",
                                             name + ".json"))

    def driver(self) -> ModuleType:
        return importlib.import_module(
            f"benchmark.drivers.{self.traffic['driver']}")

    def end_to_end(self) -> List[Dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list that move a metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str) -> ModuleType:
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
