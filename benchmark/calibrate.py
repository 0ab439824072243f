#!/usr/bin/env python3
"""Read the numbers that decide a cell's ``correct`` over many seeds in one
process, to set its limits: the program's readings (set-up, the compared
steps or a sample of answers, then the reference), and with
``--control-seeds`` the control's (the reference in float8, the next
precision below the configuration's bfloat16, in the program's place) and
the faults' the driver names (``CONTROLS``), planted in the reference in
the program's place.

    python3 benchmark/calibrate.py --workload r101-voc15-5.phase2 \\
        --seeds 11 12 13 --control-seeds 11 12 13

One JSON line a seed and kind on standard output. Not run by the
benchmark's own runs."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=ROOT)
    p.add_argument("--bench-dir", default=None)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness.registry import BENCH_DIR, Cell

    cell = Cell(a.root, a.workload, a.bench_dir or BENCH_DIR)
    dev = torch.device(a.device)
    for seed in sorted(set(a.seeds) | set(a.control_seeds) |
                       set(a.witness_seeds)):
        t0 = time.perf_counter()
        drv = cell.driver().Driver(cell.config, cell.traffic, seed, dev)
        try:
            rows = readings(drv, seed, a)
        finally:
            if hasattr(drv, "close"):
                drv.close()
        for kind, r, detail in rows:
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "kind": kind, "readings": r, "detail": detail,
                              "s": round(time.perf_counter() - t0, 3)}),
                  flush=True)
        del drv
    return 0


def readings(drv, seed, a):
    """[(kind, readings, detail)] of one seed."""
    drv.setup()
    drv.sample_run()
    drv.release()
    rows = []
    if seed in a.seeds:
        rows.append(("program", drv.check(), getattr(drv, "detail", None)))
    kinds = ((drv.CONTROLS if seed in a.control_seeds else ()) +
             (drv.WITNESSES if seed in a.witness_seeds else ()))
    for kind in kinds:
        r = drv.control_readings(kind)
        rows.append((kind, r, getattr(drv, "detail", None)))
    return rows


if __name__ == "__main__":
    sys.exit(main())
