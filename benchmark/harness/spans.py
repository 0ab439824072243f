"""The program's stage spans in a traced window: a frozen copy of the
attribution of the port's ``utils/device_time.span_times``.

A stage span is a ``user_annotation`` host range named ``<part>.<stage>``
(torch's own ranges, such as ``Optimizer.step#Adam.step``, hold a ``#``).
A device event (kernel, copy, set) belongs to the innermost, that is the
shortest, stage span that holds its launch on the host clock, from any
thread: the runtime or driver launch event of the same ``correlation``,
or, where none has it, the operator of the same ``External id``. A
stage's device time is the union of the events that belong to it. Each
gap between the first device's events is put down to the stage of the
event that ends it, whose launch the device waited for.

A window is attributed once per profile, kept while the profile lives,
for every reader of the window."""

from __future__ import annotations

import bisect
import re
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.harness.trace import DEVICE_CATS, union_us

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STAGE_SPAN = re.compile(r"^\w+\.\w+$")
RUNTIME = re.compile(r"^cu(da)?[A-Z]")      # cudaLaunchKernel, cuLaunchKernel

_BY_PROF: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _iv(events: Iterable[Dict]) -> List[Tuple[float, float]]:
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events]


def _device(e: Dict) -> str:
    return str(e.get("args", {}).get("device", e.get("pid")))


def _launches(events: List[Dict]) -> List[Tuple[float, Dict]]:
    """(host time of the launch, device event) of every device event whose
    launch the trace holds."""
    by_corr, by_ext = {}, {}
    for e in events:
        args = e.get("args", {})
        if e.get("cat") in LAUNCH_CATS and "correlation" in args:
            by_corr[args["correlation"]] = float(e["ts"])
        elif e.get("cat") == "cpu_op" and "External id" in args:
            by_ext.setdefault(args["External id"], float(e["ts"]))
    out = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args", {})
        t = by_corr.get(args.get("correlation"))
        if t is None:
            t = by_ext.get(args.get("External id"))
        if t is not None:
            out.append((t, e))
    return out


def attribute(events: List[Dict]) -> Dict[str, Dict]:
    """{stage name: {"count": its ranges, "events": the device events that
    belong to it, "idle_us": the gaps put down to it}}."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    str(e["name"])) for e in events
                   if e.get("cat") == "user_annotation"
                   and STAGE_SPAN.match(str(e.get("name", ""))))
    out: Dict[str, Dict] = {}
    for _, _, name in spans:
        out.setdefault(name, {"count": 0, "events": [], "idle_us": 0.0})
        out[name]["count"] += 1
    cuts = sorted({t for lo, hi, _ in spans for t in (lo, hi)})
    inner: List[Optional[str]] = []
    for a in cuts:
        held = [(hi - lo, name) for lo, hi, name in spans if lo <= a < hi]
        inner.append(min(held)[1] if held else None)
    owner: Dict[int, str] = {}
    for t, e in _launches(events):
        i = bisect.bisect_right(cuts, t) - 1
        name = inner[i] if i >= 0 else None
        if name is not None:
            owner[id(e)] = name
            out[name]["events"].append(e)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if device:
        first = min({_device(e) for e in device}, key=lambda d: (len(d), d))
        hi = None
        for e in sorted((e for e in device if _device(e) == first),
                        key=lambda e: (float(e["ts"]), float(e["dur"]))):
            lo, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if hi is not None and lo > hi and id(e) in owner:
                out[owner[id(e)]]["idle_us"] += lo - hi
            hi = end if hi is None else max(hi, end)
    return out


def host_events(prof) -> List[Dict]:
    """The host events of the profile as the Chrome trace has them, from
    the profiler's own parsed events (its ``events()``, on the clock of its
    ranges, not of the trace): stage spans as ``user_annotation``, calls
    of the CUDA runtime or driver as ``cuda_runtime`` with their
    ``correlation``, every other range as ``cpu_op`` with its ``External
    id``. (A profile's Chrome trace can be saved once, and the runner
    saves it first.)"""
    from torch.autograd import DeviceType
    out = []
    for fe in prof.events():
        if fe.device_type != DeviceType.CPU:
            continue
        name = str(fe.name)
        if STAGE_SPAN.match(name):
            cat, args = "user_annotation", {}
        elif RUNTIME.match(name):
            cat, args = "cuda_runtime", {"correlation": fe.id}
        else:
            cat, args = "cpu_op", {"External id": fe.id}
        lo, hi = float(fe.time_range.start), float(fe.time_range.end)
        out.append({"ph": "X", "cat": cat, "name": name, "tid": fe.thread,
                    "ts": lo, "dur": hi - lo, "args": args})
    return out


def of(ctx) -> Dict[str, Dict]:
    """`attribute` of the traced window, computed once a profile: the host
    events of the profile (launches and spans share its clock) and the
    device events of the window's trace (on the trace's clock)."""
    if ctx.prof not in _BY_PROF:
        _BY_PROF[ctx.prof] = attribute(host_events(ctx.prof) +
                                       ctx.trace.device)
    return _BY_PROF[ctx.prof]


def device_ms(ctx, names: Tuple[str, ...], per: str) -> Optional[float]:
    """Device ms of the events that belong to the stages `names` (their
    union), over ``ctx.work[per]``; None without device events, without
    such a stage, or without work."""
    if not ctx.trace.device or not ctx.work.get(per):
        return None
    stages = of(ctx)
    found = [stages[n] for n in names if n in stages]
    if not found:
        return None
    busy = union_us(_iv(e for s in found for e in s["events"]))
    return busy / 1e3 / ctx.work[per]


def idle_ms(ctx, name: str, per: str) -> Optional[float]:
    """Idle ms of the first device put down to stage `name`, over
    ``ctx.work[per]``; None as for `device_ms`."""
    if not ctx.trace.device or not ctx.work.get(per):
        return None
    stage = of(ctx).get(name)
    if stage is None:
        return None
    return stage["idle_us"] / 1e3 / ctx.work[per]
