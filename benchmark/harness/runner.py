"""One run of one cell: set-up (timed as ``setup_s``), the measured window
(``--trace 0``) or the traced window and its per-layer readers (``--trace
1``), then the program's state freed and the reference's comparison, and
the result line. The caller has checked the chips and prints the line."""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark.harness import compare
from benchmark.harness.registry import Cell
from benchmark.harness.trace import Trace, chrome_events

FORBIDDEN = ("jax", "jaxlib", "flax", "cl4wsis_tpu")
GIB = 2 ** 30


class ReaderContext:
    """What a per-layer reader reads: the trace of the traced window, the
    profiler, the work the driver counted in it and the chips used."""

    def __init__(self, trace: Trace, prof, work: Dict, chips: int):
        self.trace = trace
        self.prof = prof
        self.work = work
        self.chips = chips


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that a run may not load, compared
    whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device: torch.device, chips: int, peak: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": peak}


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        cell: Optional[Cell] = None) -> Dict:
    """The result line's object; "checks" (each number compared and its
    limit) comes last."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or Cell(root, workload)
    dev = torch.device(device)
    drv = cell.driver().Driver(cell.config, cell.traffic, seed, dev)
    try:
        return _run(drv, cell, workload, seconds, trace, dev, t_start)
    finally:
        close = getattr(drv, "close", None)
        if close is not None:
            close()


def _run(drv, cell: Cell, workload: str, seconds: float, trace: bool,
         dev: torch.device, t_start: float) -> Dict:
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    out: Dict = {}
    if not trace:
        win = drv.window(seconds)
        metrics = dict(win["metrics"])
        metrics["setup_s"] = setup_s
        metrics["peak_mem_gib"] = win["peak_bytes"] / GIB
        units = {m["name"]: m["unit"] for m in cell.end_to_end()}
        missing = set(units) - set(metrics)
        if missing:
            raise RuntimeError(f"{workload}: no reading of {sorted(missing)}")
        out["metrics"] = {k: {"value": metrics[k], "unit": u}
                          for k, u in units.items()}
        attempted, failed, peak = win["attempted"], win["failed"], \
            win["peak_bytes"]
        busy = None
    else:
        prof, window_s, work = drv.traced()
        tr = Trace(chrome_events(prof), window_s)
        # busy time averaged over the cards: this process's trace, and the
        # other ranks' busy times where the driver runs several
        others = work.get("busy_others", [])
        work["busy_s"] = (tr.busy_s() + sum(others)) / (1 + len(others))
        ctx = ReaderContext(tr, prof, work, cell.chips)
        out["metrics"] = {}
        for m in cell.per_layer():
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        attempted, failed, peak = work["attempted"], work["failed"], \
            work["peak_bytes"]
        busy = (work["busy_s"], window_s)
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        del prof, ctx, tr

    t_window = time.perf_counter()
    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = drv.check()
    print(f"{workload}: set-up {setup_s:.3f} s, window and its reading "
          f"{t_window - t_start - setup_s:.3f} s, reference "
          f"{time.perf_counter() - t_window:.3f} s", file=sys.stderr)
    checks = compare.judge(readings, cell.limits)
    out = {"correct": compare.passed(checks), "attempted": attempted,
           "failed": failed, **out,
           "device": device_info(dev, cell.chips, peak)}
    if busy is not None:
        out["device"]["busy_s"], out["device"]["window_s"] = busy
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": _plain(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    if failed:
        out["correct"] = False
    return out


def _plain(v):
    """A reading as JSON can hold it: a number, or "inf" / "nan"."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v


def check_lines(result: Dict) -> List[str]:
    return [f"check {k}: {v['value']} (limit {v['limit']})"
            for k, v in result["checks"].items()]
