"""A checkout of the benchmark at a size the CPU holds: the real cells'
configurations at 64^2 crops (ResNet-101 cut to one block a stage,
batch 2; WideResNet-38 whole, 9 classes), short mixes, the real cells'
limits, in a temporary directory; the drivers' code is the
repository's."""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "benchmark")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PHASE2 = "tiny-r.tphase2"
VALIDATE = "tiny-w.tvalidate"
DP = "tiny-r.tdp"
REAL = {PHASE2: "r101-voc15-5.phase2", VALIDATE: "wrn38-cocovoc.validate",
        DP: "r101-voc15-5.step0-dp4"}


def _dump(obj, *path):
    with open(os.path.join(*path), "w") as f:
        json.dump(obj, f)


def make_root(tmp: str) -> str:
    """Write the tiny checkout under `tmp`; returns its root (which holds
    BENCHMARK.json, and the benchmark's data files under bench/)."""
    root = os.path.join(tmp, "root")
    bench = os.path.join(root, "bench")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(BENCH, "configs", "r101-voc15-5.json")) as f:
        r = json.load(f)
    r.update(blocks=[1, 1, 1, 1], crop_size=64, batch_size=2,
             dtype="float32")
    _dump(r, bench, "configs", "tiny-r.json")
    with open(os.path.join(BENCH, "configs", "wrn38-cocovoc.json")) as f:
        w = json.load(f)
    # WideResNet-38 at its full depth (its float8 error grows with depth),
    # at small images
    w.update(crop_size=64, dtype="float32", classes=[6, 3])
    w["eval"]["crop_size_val"] = 64
    _dump(w, bench, "configs", "tiny-w.json")
    _dump({"driver": "phase2", "n_batches": 4, "check_steps": 3,
           "warmup_steps": 4, "trace_steps": 2},
          bench, "traffic", "tphase2.json")
    _dump({"driver": "validate", "sizes_wh": [[100, 75], [75, 100]],
           "per_size": 2, "objects": 3, "warmup_cycles": 1,
           "sample_cycles": 1, "sample_from_cycles": 2, "trace_cycles": 2},
          bench, "traffic", "tvalidate.json")
    _dump({"driver": "step0_dp", "world": 4, "n_batches": 4,
           "check_steps": 3, "warmup_steps": 4, "trace_steps": 2},
          bench, "traffic", "tdp.json")
    for tiny, real in REAL.items():
        shutil.copy(os.path.join(BENCH, "limits", real + ".json"),
                    os.path.join(bench, "limits", tiny + ".json"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"] = [{"name": "tiny-r", "file": "bench/configs/tiny-r.json"},
                    {"name": "tiny-w", "file": "bench/configs/tiny-w.json"}]
    b["workloads"] = [{"name": t, "config": t.split(".")[0],
                       "traffic": t.split(".")[1], "chips": 1} for t in REAL]
    back = {v: k for k, v in REAL.items()}
    for m in b["end_to_end"]:          # the data-parallel cell's rate
        if m["name"] == "train_img_s":
            m["workloads"].append(REAL[DP])
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [back[w] for w in m["workloads"]]
    _dump(b, root, "BENCHMARK.json")
    return root


def cell(root: str, name: str):
    from benchmark.harness.registry import Cell
    return Cell(root, name, os.path.join(root, "bench"))
