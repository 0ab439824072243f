"""The stage-span readers (``harness/spans.py``, ``metrics/*_ms.*``) on
hand-written Chrome traces: each reading, nothing where the trace has no
such span (as at a program without spans) or no device event (a CPU
trace), one read of a profile, the host events of a real profile, and
the same attribution as the port's ``utils/device_time.span_times``."""

from __future__ import annotations

import json
import types

import pytest

from benchmark.harness.runner import ReaderContext
from benchmark.harness.trace import DEVICE_CATS, Trace
from benchmark.tests.tiny import REPO

PHASE2 = "r101-voc15-5.phase2"
VALIDATE = "wrn38-cocovoc.validate"
NEW = {PHASE2: ("frozen_ms.train", "targets_ms.train", "factory_ms.train",
                "instance_ms.train", "factory_idle_ms.train"),
       VALIDATE: ("forward_ms.infer", "postproc_ms.infer",
                  "postproc_idle_ms.infer")}


class FakeProf:
    """What the readers use of a profile: its parsed host events, built
    from the host events of a hand-written trace (a runtime call under its
    correlation, any other range under its External id)."""

    def __init__(self, events):
        from torch.autograd import DeviceType
        self.host = [types.SimpleNamespace(
            name=e["name"], thread=e["tid"], device_type=DeviceType.CPU,
            id=e["args"].get("correlation", e["args"].get("External id", 0)),
            time_range=types.SimpleNamespace(start=e["ts"],
                                             end=e["ts"] + e["dur"]))
            for e in events if e["cat"] not in DEVICE_CATS]
        self.reads = 0

    def events(self):
        self.reads += 1
        return self.host


def _range(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 9,
            "tid": tid, "ts": float(ts), "dur": float(dur), "args": {}}


def _launched(corr, at, lo, dur, tid=1, cat="kernel"):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 9, "tid": tid, "ts": float(at), "dur": 2.0,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": f"k{corr}", "pid": 0, "tid": 7,
             "ts": float(lo), "dur": float(dur),
             "args": {"device": 0, "correlation": corr}}]


def phase2_trace(spans=True):
    """Two steps 10 ms apart. A step's stages on the host (µs): frozen
    [0, 100), instance_forward [100, 150), targets [150, 200),
    label_factory [200, 300), targets [300, 320), instance_update
    [320, 400) holding torch's Optimizer.step range [380, 395). Its kernels:
    frozen 400, instance forward 100, targets 50, the factory 200 after a
    gap of 50 and 100 after a gap of 100, targets 20, the update 180
    (launched from a second thread) and 100 (inside torch's range)."""
    ev, corr = [], 0
    for s in range(2):
        h, d = 10000 * s, 10000 * s
        if spans:
            ev += [_range("phase2.frozen", h, 100),
                   _range("phase2.instance_forward", h + 100, 50),
                   _range("phase2.targets", h + 150, 50),
                   _range("phase2.label_factory", h + 200, 100),
                   _range("phase2.targets", h + 300, 20),
                   _range("phase2.instance_update", h + 320, 80)]
        ev.append(_range("Optimizer.step#Adam.step", h + 380, 15))
        for at, lo, dur, tid in ((10, 1000, 400, 1), (110, 1400, 100, 1),
                                 (160, 1500, 50, 1), (210, 1600, 200, 1),
                                 (250, 1900, 100, 1), (310, 2000, 20, 1),
                                 (330, 2020, 180, 2), (385, 2200, 100, 1)):
            ev += _launched(corr, h + at, d + lo, dur, tid)
            corr += 1
    return ev


PHASE2_WANT = {"frozen_ms.train": 0.4, "targets_ms.train": 0.07,
               "factory_ms.train": 0.3, "instance_ms.train": 0.38,
               "factory_idle_ms.train": 0.15}


def validate_trace(spans=True):
    """One image: eval.forward [0, 100) launches a 4 ms kernel;
    eval.postproc [100, 200) two of 100 µs, the first after a gap of 100;
    the answer's copy to the host, launched after both, after a gap of
    100."""
    ev = [_range("eval.forward", 0, 100), _range("eval.postproc", 100, 100)
          ] if spans else []
    ev += _launched(0, 10, 1000, 4000)
    ev += _launched(1, 120, 5100, 100)
    ev += _launched(2, 150, 5200, 100)
    ev += _launched(3, 250, 5400, 10, cat="gpu_memcpy")
    return ev


VALIDATE_WANT = {"forward_ms.infer": 4.0, "postproc_ms.infer": 0.2,
                 "postproc_idle_ms.infer": 0.1}


def _ctx(events, work):
    return ReaderContext(Trace(events, 1.0), FakeProf(events), work, 1)


def _cell(name):
    from benchmark.harness.registry import Cell
    return Cell(REPO, name)


@pytest.mark.parametrize("cell,trace,work,want", [
    (PHASE2, phase2_trace, {"steps": 2, "images": 32}, PHASE2_WANT),
    (VALIDATE, validate_trace, {"steps": 1, "images": 1}, VALIDATE_WANT)])
def test_readers_on_a_hand_trace(cell, trace, work, want):
    """Each reading, from one read of the profile."""
    c = _cell(cell)
    assert set(NEW[cell]) <= {m["name"] for m in c.per_layer()}
    ctx = _ctx(trace(), work)
    got = {name: c.reader(name).read(ctx) for name in NEW[cell]}
    assert got == pytest.approx(want)
    assert ctx.prof.reads == 1


@pytest.mark.parametrize("cell,trace", [(PHASE2, phase2_trace),
                                        (VALIDATE, validate_trace)])
def test_nothing_without_the_spans_or_device_events(cell, trace):
    """A program without spans (the parent's) and a CPU trace (spans, no
    device events) give no reading, and raise nothing."""
    c = _cell(cell)
    work = {"steps": 2, "images": 2}
    no_spans = _ctx(trace(spans=False), work)
    cpu = _ctx([e for e in trace() if e["cat"] == "user_annotation"], work)
    for name in NEW[cell]:
        assert c.reader(name).read(no_spans) is None, name
        assert c.reader(name).read(cpu) is None, name


@pytest.mark.parametrize("trace", [phase2_trace, validate_trace])
def test_same_attribution_as_the_port(tmp_path, trace):
    """The frozen copy gives what the port's reader gives."""
    from benchmark.harness import spans
    from benchmark.harness.trace import union_us
    from cl4wsis_tpu_torch.utils import device_time
    events = trace()
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    port = device_time.span_times(str(path))
    ours = spans.attribute(events)
    assert sorted(port) == sorted(ours)
    for name, s in ours.items():
        busy = union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in s["events"])
        assert port[name]["count"] == s["count"]
        assert port[name]["busy_s"] * 1e6 == pytest.approx(busy)
        assert port[name]["idle_s"] * 1e6 == pytest.approx(s["idle_us"])


def test_entries_name_one_cell_each():
    with open(f"{REPO}/BENCHMARK.json") as f:
        bench = json.load(f)
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            m = by_name[name]
            assert m["workloads"] == [cell] and m["better"] == "lower"
            assert m["source"] == "device_trace"
            assert m["moves"] == ("train_img_s" if cell == PHASE2
                                  else "infer_img_s")


def test_host_events_as_the_chrome_trace_has_them():
    """A real CPU profile: the host events read from the profiler's parsed
    events give the spans of its Chrome trace, and its operators under
    their External ids (less an operator nested in one of its own name,
    which the parsed events fold into it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import spans
    from benchmark.harness.trace import chrome_events
    from cl4wsis_tpu_torch.utils.logging import span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with span("t.outer"):
                a = torch.randn(32, 32)
                with span("t.inner"):
                    (a @ a).sum()
    host = spans.host_events(prof)
    exported = chrome_events(prof)

    def key(evs, cat):
        return sorted((e["name"], e["args"].get("External id"))
                      for e in evs if e["cat"] == cat)
    assert set(key(host, "cpu_op")) <= set(key(exported, "cpu_op"))
    assert "aten::mm" in {n for n, _ in key(host, "cpu_op")}
    assert [n for n, _ in key(host, "user_annotation")] == \
        [n for n, _ in key(exported, "user_annotation")]
    assert {n: s["count"] for n, s in spans.attribute(host).items()} == \
        {"t.outer": 2, "t.inner": 2}
