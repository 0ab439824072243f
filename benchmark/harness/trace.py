"""What a traced run reads from ``torch.profiler``: the Chrome trace's
device events and their union (a frozen copy of the union arithmetic of
the port's ``utils/device_time.py``), kernel time by name, the device
time of the kernels each operator launched, and the breakdown of the
result line (the device operations that took most time and the longest
idle gaps, named by the host operator running in each)."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, hi = 0.0, None
    for lo, end in sorted(intervals):
        if hi is None or lo > hi:
            busy += end - lo
            hi = end
        elif end > hi:
            busy += end - hi
            hi = end
    return busy


def normalize_kernel_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments, parameters or
    a trailing instance number, so that its launches pool together."""
    name = re.sub(r"^void ", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return re.sub(r"[.\d_]+$", "", name) or name


def chrome_events(prof) -> List[Dict]:
    """The complete ("X") events of the profile's Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            blob = json.load(f)
    finally:
        os.remove(path)
    events = blob["traceEvents"] if isinstance(blob, dict) else blob
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


class Trace:
    """The device and host events of one traced window (one process's), and
    the window's host-clock length in seconds."""

    def __init__(self, events: List[Dict], window_s: float):
        self.window_s = window_s
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host_ops = [e for e in events if e.get("cat") == "cpu_op"]

    def busy_s(self) -> float:
        """Union of the device events, averaged over the devices in the
        trace."""
        by_dev: Dict[str, List[Tuple[float, float]]] = {}
        for e in self.device:
            dev = str(e.get("args", {}).get("device", e.get("pid")))
            by_dev.setdefault(dev, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        return sum(union_us(v) for v in by_dev.values()) / 1e6 / \
            max(len(by_dev), 1)

    def kernel_s(self, pattern: str) -> float:
        """Summed device time of the kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(float(e["dur"]) for e in self.kernels
                   if rx.search(str(e["name"]))) / 1e6

    def device_ops(self) -> List[List]:
        agg: Dict[str, float] = {}
        for e in self.device:
            k = normalize_kernel_name(str(e["name"]))
            agg[k] = agg.get(k, 0.0) + float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(agg.items(), key=lambda kv: -kv[1])
                ][:TOP]

    def idle_gaps(self) -> List[List]:
        """The longest gaps between device events (first device), each named
        by the innermost host operator running at its middle."""
        iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in self.device)
        gaps, hi = [], None
        for lo, end in iv:
            if hi is not None and lo > hi:
                gaps.append((hi, lo))
            hi = end if hi is None else max(hi, end)
        ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      str(e["name"])) for e in self.host_ops)
        starts = [o[0] for o in ops]
        out = []
        for lo, end in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
            mid = (lo + end) / 2
            name, best = "host (no operator)", None
            for o in ops[:bisect.bisect_right(starts, mid)][-400:]:
                if o[1] >= mid and (best is None or o[1] - o[0] < best):
                    name, best = o[2], o[1] - o[0]
            out.append([name, (end - lo) / 1e6])
        return out


def op_device_s(prof, names: Tuple[str, ...]) -> float:
    """Device time (s) of the kernels that the operators named `names`
    launched, children included, from the profiler's attribution."""
    total = 0.0
    for e in prof.key_averages():
        if e.key in names:
            total += getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0))
    return total / 1e6
