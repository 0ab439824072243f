"""The port's stage spans (``utils/logging.span``) and their reader
(``utils/device_time.span_times``) on the CPU: a tiny phase-2 step and
eval forward enter no RecordFunction of theirs without a profiler, enter
each span as often as the step or image does under one, and give the same
numbers both ways, bit for bit; the attribution rules on a hand-written
Chrome trace."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cl4wsis_tpu_torch.data.synthetic import synthetic_batches
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.train import schedule
from cl4wsis_tpu_torch.train.eval import make_eval_forward
from cl4wsis_tpu_torch.train.phase2 import make_phase2_train_step
from cl4wsis_tpu_torch.train.state import TrainState
from cl4wsis_tpu_torch.utils import device_time
from cl4wsis_tpu_torch.utils.logging import span
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler
from torch_one_thread import one_torch_thread  # noqa: F401

TINY = (1, 1, 1, 1)
CLASSES = (3, 2)
SIZE = 64
STEPS = 2
# per step, and per image
PHASE2_SPANS = {"phase2.frozen": 1, "phase2.instance_forward": 1,
                "phase2.targets": 2, "phase2.label_factory": 1,
                "phase2.instance_update": 1}
EVAL_SPANS = {"eval.forward": 1, "eval.postproc": 1}
# (image size, target size): the bucketed path, then the exact one
IMAGES = (((60, 44), (60, 44)), ((48, 40), (60, 50)))


def _run():
    """STEPS phase-2 steps, then the eval forward on IMAGES, from fixed
    weights and batches: the steps' metrics, the parameters and Adam's
    state after them (its first moments hold the gradients), the
    answers."""
    torch.manual_seed(0)
    model = make_model(CLASSES, "resnet101", 16, SIZE,
                       backbone_structure=TINY)
    model_old = make_model(CLASSES[:1], "resnet101", 16, SIZE,
                           backbone_structure=TINY)
    with torch.no_grad():   # old class 1 wins every pixel: a nonzero loss
        model.cls[0].bias[1] += 0.15
    pl, pg = PseudoLabeler(5), PeakGenerator(4, 2)
    opt = schedule.make_optimizer(model, "adam", group_scale={
        "body": 0.0, "seg": 0.0, "instance": 10.0, "pseudo": 0.0})
    state = TrainState(model, opt, schedule.make_schedule("poly", 1e-4, 10))
    step = make_phase2_train_step(model, model_old, pl, pg, CLASSES[0],
                                  nms_kernel=15, device="cpu")
    gen = torch.Generator().manual_seed(0)
    metrics = []
    for b in synthetic_batches(2, SIZE, 4, seed=1, n_batches=STEPS):
        l1h = b["l1h"][:, 1:].copy()
        l1h[:, CLASSES[0] - 1:] = 1.0       # every new class labelled
        metrics.append(step(state, {"image": torch.from_numpy(b["image"]),
                                    "l1h": torch.from_numpy(l1h)}, gen))
    fwd = make_eval_forward(model, 4, device="cpu", dtype=torch.float32,
                            val_thresh=0.1, val_kernel=15, beta=3.0,
                            max_ctr=8, max_cluster=4)
    g = torch.Generator().manual_seed(6)
    answers = [fwd(torch.rand((1, h, w, 3), generator=g), target)
               for (h, w), target in IMAGES]
    return {"metrics": metrics,
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
            "adam": [{k: v.clone() for k, v in s.items()}
                     for s in opt.state.values()],
            "answers": answers}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The run without a profiler, the names of every RecordFunction it
    entered, and the run under a CPU profiler with its Chrome trace."""
    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counting(name, args=None):
        entered.append(name)
        return enter(name, args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.ops.profiler, "_record_function_enter_new",
                   counting)
        off = _run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _run()
    path = str(tmp_path_factory.mktemp("spans") / "trace.json")
    prof.export_chrome_trace(path)
    return {"off": off, "on": on, "entered": entered, "trace": path}


def test_span_is_one_null_context_without_a_profiler():
    assert span("phase2.frozen") is span("eval.postproc")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("phase2.frozen"),
                          torch.profiler.record_function)
    assert span("phase2.frozen") is span("eval.postproc")


def test_no_record_function_from_the_spans_without_a_profiler(runs):
    """Zero RecordFunction entries from the program's spans; torch's own
    range around Adam's step, entered without a profiler too, shows that
    the count sees every entry."""
    ours = set(PHASE2_SPANS) | set(EVAL_SPANS)
    assert [n for n in runs["entered"] if n in ours] == []
    assert runs["entered"].count("Optimizer.step#Adam.step") == STEPS


def test_each_span_once_a_stage_under_a_profiler(runs):
    """The trace holds each stage span as often as each step or image
    enters it, all found by the reader; the CPU trace has no device
    time."""
    got = device_time.span_times(runs["trace"])
    want = {**{k: v * STEPS for k, v in PHASE2_SPANS.items()},
            **{k: v * len(IMAGES) for k, v in EVAL_SPANS.items()}}
    assert {k: v["count"] for k, v in got.items()} == want
    assert all(v["busy_s"] == v["idle_s"] == 0 for v in got.values())


def _equal(a, b, where):
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_numbers_bit_for_bit_with_spans_on_and_off(runs):
    """Losses and metrics, parameters, Adam's moments and the answers, the
    same with the spans entered (profiler on) and not."""
    _equal(runs["on"], runs["off"], "run")
    assert all(float(m["loss"]) > 0 for m in runs["off"]["metrics"])
    assert any(bool(s["exp_avg"].any()) for s in runs["off"]["adam"])


# ------------------------------------------------ attribution on a trace


def _range(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 9, "tid": tid,
            "ts": float(ts), "dur": float(dur), "args": {}}


def _launched(corr, at, lo, dur, tid=1, device=0, stream=7):
    """A kernel [lo, lo + dur) on `device` and its runtime launch at `at`
    on host thread `tid`."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 9, "tid": tid, "ts": float(at), "dur": 2.0,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": device,
             "tid": stream, "ts": float(lo), "dur": float(dur),
             "args": {"device": device, "correlation": corr}}]


def _hand_trace():
    """Host ranges on thread 1: a step range train_step#2 [0, 1000), the
    stage p.outer [100, 600) holding p.inner [200, 300), which holds
    torch's Optimizer.step#Adam.step [250, 280); p.other [700, 800) and
    [850, 900). Launches, each with its kernel on device 0 unless said:
    1 in p.outer; 2 from thread 2 in p.inner; 3 inside torch's range in
    p.inner; 4 in the step range alone (no stage); 5 from thread 2 and 6
    (stream 13, overlapping 5) in the first p.other; 7 in the second;
    8 in p.outer, on device 1; a kernel with no launch event."""
    ev = [_range("train_step#2", 0, 1000), _range("p.outer", 100, 500),
          _range("p.inner", 200, 100),
          _range("Optimizer.step#Adam.step", 250, 30),
          _range("p.other", 700, 100), _range("p.other", 850, 50),
          _range("step#0", 1000, 900, tid=7, cat="gpu_user_annotation")]
    ev += _launched(1, 150, 1000, 100)                 # gap: first event
    ev += _launched(2, 210, 1150, 100, tid=2)          # gap 50 -> inner
    ev += _launched(3, 260, 1250, 50)                  # no gap
    ev += _launched(4, 650, 1400, 50)                  # gap 100 -> none
    ev += _launched(5, 720, 1500, 100, tid=2)          # gap 50 -> other
    ev += _launched(6, 730, 1550, 100, stream=13)      # overlaps 5
    ev += _launched(7, 860, 1700, 20)                  # gap 50 -> other
    ev += _launched(8, 160, 1700, 100, device=1)       # device 1: no gaps
    orphan = _launched(9, 0, 1800, 40)[1]              # gap 80 -> none
    orphan["args"]["correlation"] = 99
    return ev + [orphan]


HAND_WANT = {  # µs: count, busy, idle
    "p.outer": (1, 100 + 100, 0),
    "p.inner": (1, 150, 50),
    "p.other": (2, 150 + 20, 50 + 50)}


@pytest.fixture
def hand(tmp_path):
    path = tmp_path / "hand.json"
    path.write_text(json.dumps({"traceEvents": _hand_trace()}))
    return device_time.span_times(str(path))


def test_span_times_finds_the_stages_alone(hand):
    """Stage spans alone: neither the step range nor torch's own range,
    nor the device's projection of a range."""
    assert list(hand) == ["p.inner", "p.other", "p.outer"]


@pytest.mark.parametrize("name", sorted(HAND_WANT))
def test_span_times_attribution(hand, name):
    """A launch from a second thread counts in the span holding it; the
    innermost stage holds a launch (torch's range inside it is no stage);
    overlapping kernels count once; a gap goes to the span of the launch
    that ends it; a launch outside every stage, and a kernel without a
    launch, belong to none; per occurrence is over the span's count."""
    count, busy, idle = HAND_WANT[name]
    got = hand[name]
    assert got["count"] == count
    assert got["busy_s"] * 1e6 == pytest.approx(busy)
    assert got["idle_s"] * 1e6 == pytest.approx(idle)
    assert got["busy_s_each"] * 1e6 == pytest.approx(busy / count)
    assert got["idle_s_each"] * 1e6 == pytest.approx(idle / count)


def test_span_times_leaves_out_launches_outside_every_stage(hand):
    """The stages' busy time is the device time less launch 4's kernel and
    the kernel without a launch; their idle is the gaps less those the
    two end."""
    busy = sum(v["busy_s"] for v in hand.values()) * 1e6
    idle = sum(v["idle_s"] for v in hand.values()) * 1e6
    assert busy == pytest.approx(520)
    assert idle == pytest.approx(150)
