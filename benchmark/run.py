#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload r101-voc15-5.phase2 --seed 7 \\
        --seconds 40 --trace 0

from the root of a checkout on a machine with the chips the cell asks
for. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window. The last line of standard output
is one JSON object (correct, attempted, failed, metrics, device, [breakdown],
checks); the last lines of standard error give each number compared beside
its limit. Without enough CUDA devices, or if JAX or the JAX package is
loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    args = parse(argv)
    set_caches()
    sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import runner
    from benchmark.harness.registry import Cell

    cell = Cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = runner.run(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T_START, cell)
    bad = runner.forbidden_modules()
    if bad:
        print(f"loaded modules a run may not load: {bad}", file=sys.stderr)
        return 3
    for line in runner.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
