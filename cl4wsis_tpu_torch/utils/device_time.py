"""Device time from the Chrome traces that ``torch.profiler`` writes
(counterpart of ``cl4wsis_tpu/utils/device_time.py``, which reads the
xplane files of ``jax.profiler``).

The host clock around a step measures what the host waited for; the
trace records what the card did. A trace is the JSON file of
``profile.export_chrome_trace`` (``StepTimer`` and the CLI's
``--profile_dir`` write ``trace_steps_*.json``); a directory stands for
every ``*.json`` under it.

* The device events are those of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``; they carry the device in ``args.device`` (else in
  ``pid``) and the stream in ``tid``.
* A device event pairs with the host call that launched it by
  ``args.correlation`` (the runtime or driver launch event of the same
  id) or, where no launch event has that id, by ``args["External id"]``
  (the operator of that id).
* A step is a host range named ``<name>#<n>``: ``ProfilerStep#n`` of a
  profiler with a schedule, or ``StepTimer``'s ``train_step#n``. Its
  device time is the busy time of the device events launched inside it,
  from any host thread (the backward runs on autograd's own thread).
* A stage span is a host range of ``utils/logging.span`` named
  ``<part>.<stage>`` (torch's own ranges, such as
  ``Optimizer.step#Adam.step``, and the step ranges hold a ``#``). A
  device event belongs to the innermost stage span (the shortest) that
  holds its launch on the host clock, from any thread; a stage's device
  time is the busy time of the events that belong to it. Each gap
  between the first device's events is put down to the stage of the
  event that ends it: the device waited for that launch.

Busy time is the length of the union of the events' intervals, so work
that overlaps on two streams counts once. A trace without device events
(one taken on the CPU) gives 0 busy time and no planes.

    python -m cl4wsis_tpu_torch.utils.device_time <trace.json or dir>
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_RANGE = re.compile(r"^(.*)#(\d+)$")
STAGE_SPAN = re.compile(r"^\w+\.\w+$")
HOST_RANGE_CATS = ("user_annotation", "cpu_op")


def trace_files(path: str) -> List[str]:
    """`path` itself, or every ``*.json`` under it."""
    if os.path.isfile(path):
        return [path]
    return sorted(glob.glob(os.path.join(path, "**", "*.json"),
                            recursive=True))


def load_events(path: str) -> List[Dict]:
    """The complete ("X") events of one Chrome trace file."""
    with open(path) as f:
        blob = json.load(f)
    events = blob["traceEvents"] if isinstance(blob, dict) else blob
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _device_of(e: Dict) -> str:
    dev = e.get("args", {}).get("device", e.get("pid"))
    return f"cuda:{dev}"


def _device_events(events: Iterable[Dict]) -> List[Dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


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


def _intervals(events: Iterable[Dict]) -> List[Tuple[float, float]]:
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events]


def device_time_report(path: str) -> Dict:
    """{"device_busy_s": busy time summed over devices, "span_s": the
    longest span from a device's first event's start to its last one's
    end, "planes": {"cuda:<i>": {"busy_s", "span_s"}}}; over several
    files each device's busy times and spans add up."""
    planes: Dict[str, Dict[str, float]] = {}
    for path_i in trace_files(path):
        by_dev: Dict[str, List[Dict]] = {}
        for e in _device_events(load_events(path_i)):
            by_dev.setdefault(_device_of(e), []).append(e)
        for dev, evs in by_dev.items():
            iv = _intervals(evs)
            p = planes.setdefault(dev, {"busy_s": 0.0, "span_s": 0.0})
            p["busy_s"] += union_us(iv) / 1e6
            p["span_s"] += (max(hi for _, hi in iv) -
                            min(lo for lo, _ in iv)) / 1e6
    return {"device_busy_s": sum(p["busy_s"] for p in planes.values()),
            "span_s": max((p["span_s"] for p in planes.values()),
                          default=0.0),
            "planes": planes}


def _launch_times(events: List[Dict]) -> List[Tuple[float, Dict]]:
    """(host time of the launch, device event) for every device event whose
    launch the trace holds."""
    by_corr, by_ext = {}, {}
    for e in events:
        args = e.get("args", {})
        if e.get("cat") in LAUNCH_CATS and "correlation" in args:
            by_corr[args["correlation"]] = float(e["ts"])
        elif e.get("cat") == "cpu_op" and "External id" in args:
            by_ext.setdefault(args["External id"], float(e["ts"]))
    out = []
    for e in _device_events(events):
        args = e.get("args", {})
        t = by_corr.get(args.get("correlation"))
        if t is None:
            t = by_ext.get(args.get("External id"))
        if t is not None:
            out.append((t, e))
    return sorted(out, key=lambda te: te[0])


def module_step_times(path: str) -> Dict[str, List[float]]:
    """Per-step device time (s) of each family of step ranges: {"<name>":
    [busy time of the device events launched in <name>#0, #1, ...]} in
    the order of the ranges, over every file."""
    out: Dict[str, List[float]] = {}
    for path_i in trace_files(path):
        events = load_events(path_i)
        launched = _launch_times(events)
        starts = [t for t, _ in launched]
        ranges = []
        for e in events:
            m = STEP_RANGE.match(str(e.get("name", "")))
            if m and e.get("cat") in HOST_RANGE_CATS:
                ranges.append((float(e["ts"]), m.group(1),
                               float(e["ts"]) + float(e["dur"])))
        for lo, name, hi in sorted(ranges):
            a, b = bisect.bisect_left(starts, lo), bisect.bisect_right(starts,
                                                                      hi)
            busy = union_us(_intervals(e for _, e in launched[a:b]))
            out.setdefault(name, []).append(busy / 1e6)
    return out


def normalize_kernel_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments, parameters or
    a trailing instance number, so that its launches pool together."""
    name = re.sub(r"^void ", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return re.sub(r"[.\d_]+$", "", name) or name


def op_breakdown(path: str, top: int = 40) -> List[Tuple[str, float, int]]:
    """Device time by normalised kernel or copy name, [(name, total_s,
    count)] largest first, the `top` first."""
    agg: Dict[str, List[float]] = {}
    for path_i in trace_files(path):
        for e in _device_events(load_events(path_i)):
            ent = agg.setdefault(normalize_kernel_name(str(e["name"])),
                                 [0.0, 0])
            ent[0] += float(e["dur"]) / 1e6
            ent[1] += 1
    rows = sorted(((k, v[0], int(v[1])) for k, v in agg.items()),
                  key=lambda r: -r[1])
    return rows[:top]


def main_module_times(path: str) -> List[float]:
    """The per-step device times of the step family with the largest total
    (the train step of a timed loop); empty without step ranges."""
    steps = module_step_times(path)
    return max(steps.values(), key=sum) if steps else []


def _stage_spans(events: List[Dict]) -> List[Tuple[float, float, str]]:
    """(start, end, name) of every stage span, by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   str(e["name"])) for e in events
                  if e.get("cat") == "user_annotation"
                  and STAGE_SPAN.match(str(e.get("name", ""))))


def _innermost(spans: List[Tuple[float, float, str]]
               ) -> Callable[[float], Optional[str]]:
    """host time -> the name of the shortest span holding it (start
    included, end not), or None."""
    cuts = sorted({t for lo, hi, _ in spans for t in (lo, hi)})
    names: List[Optional[str]] = []
    for a in cuts:
        held = [(hi - lo, name) for lo, hi, name in spans if lo <= a < hi]
        names.append(min(held)[1] if held else None)

    def at(t: float) -> Optional[str]:
        i = bisect.bisect_right(cuts, t) - 1
        return names[i] if i >= 0 else None
    return at


def _gaps(events: List[Dict]) -> List[Tuple[float, Dict]]:
    """(length, the event that ends it) of every gap between the first
    device's events."""
    devs = sorted({_device_of(e) for e in events}, key=lambda d: (len(d), d))
    first = sorted((e for e in events if _device_of(e) == devs[0]),
                   key=lambda e: (float(e["ts"]), float(e["dur"])))
    out, hi = [], None
    for e in first:
        lo = float(e["ts"])
        if hi is not None and lo > hi:
            out.append((lo - hi, e))
        hi = lo + float(e["dur"]) if hi is None else max(
            hi, lo + float(e["dur"]))
    return out


def span_times(path: str) -> Dict[str, Dict[str, float]]:
    """For each stage span name, over every file: {"count": its ranges,
    "busy_s": the device time of the events that belong to it, "idle_s":
    the gaps put down to it, and "busy_s_each", "idle_s_each": those over
    the count}."""
    acc: Dict[str, List[float]] = {}
    for path_i in trace_files(path):
        events = load_events(path_i)
        spans = _stage_spans(events)
        for _, _, name in spans:
            acc.setdefault(name, [0, 0.0, 0.0])[0] += 1
        at = _innermost(spans)
        owner: Dict[int, str] = {}
        mine: Dict[str, List[Dict]] = {}
        for t, e in _launch_times(events):
            name = at(t)
            if name is not None:
                owner[id(e)] = name
                mine.setdefault(name, []).append(e)
        for name, evs in mine.items():
            acc[name][1] += union_us(_intervals(evs)) / 1e6
        device = _device_events(events)
        for gap, e in (_gaps(device) if device else []):
            if id(e) in owner:
                acc[owner[id(e)]][2] += gap / 1e6
    return {name: {"count": int(n), "busy_s": busy, "idle_s": idle,
                   "busy_s_each": busy / n, "idle_s_each": idle / n}
            for name, (n, busy, idle) in sorted(acc.items())}


if __name__ == "__main__":
    import sys
    rep = device_time_report(sys.argv[1])
    rep["module_steps"] = module_step_times(sys.argv[1])
    rep["spans"] = span_times(sys.argv[1])
    rep["ops"] = op_breakdown(sys.argv[1], top=15)
    print(json.dumps(rep, indent=2))
