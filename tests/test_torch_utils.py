"""The port's visualisation, logging extras, confusion figure, test-time
augmentation, the last two bindings of the mask library, and the reader of
the profiler's Chrome traces, against the JAX package on the CPU (or, for
the trace reader, against a numpy interval union on hand-written traces)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from PIL import Image

from cl4wsis_tpu.data import native as jnative
from cl4wsis_tpu.metrics.stream import StreamSegMetrics as JaxMetrics
from cl4wsis_tpu.models.tta import test_augmentation as jax_tta
from cl4wsis_tpu.utils import logging as jlogging
from cl4wsis_tpu.utils import visualize as jvis
from cl4wsis_tpu_torch.data import native
from cl4wsis_tpu_torch.metrics.stream import StreamSegMetrics
from cl4wsis_tpu_torch.models import tta
from cl4wsis_tpu_torch.utils import device_time
from cl4wsis_tpu_torch.utils import visualize as vis
from cl4wsis_tpu_torch.utils.logging import Logger, StepTimer
from torch_one_thread import one_torch_thread  # noqa: F401

# ------------------------------------------------------------- visualize


def test_colour_tables_equal_jax():
    """Every table and map of the module, exactly."""
    for name in ("voc_cmap", "cityscapes_cmap", "ade_cmap"):
        got, want = getattr(vis, name)(), getattr(jvis, name)()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(vis.voc_cmap(normalized=True),
                                  jvis.voc_cmap(normalized=True))
    for ds in ("voc", "cityscapes", "ade", "coco", "coco-voc"):
        np.testing.assert_array_equal(vis.color_map(ds), jvis.color_map(ds))
    with pytest.raises(ValueError):
        vis.color_map("kitti")
    np.testing.assert_array_equal(vis._COLORS, jvis._COLORS)
    assert vis._COLORS.shape == (73, 3)


def test_label_maps_and_denorm_equal_jax():
    rs = np.random.RandomState(0)
    labels = rs.randint(-3, 300, (7, 9))
    np.testing.assert_array_equal(vis.label_to_color_image(labels),
                                  jvis.label_to_color_image(labels))
    np.testing.assert_array_equal(vis.Label2Color(vis.voc_cmap())(labels),
                                  jvis.Label2Color(jvis.voc_cmap())(labels))
    np.testing.assert_array_equal(vis.label_to_one_hot(labels % 5, 5),
                                  jvis.label_to_one_hot(labels % 5, 5))
    image = rs.randn(2, 4, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(vis.denorm(image), jvis.denorm(image))
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.3, 0.4)
    np.testing.assert_array_equal(vis.Denormalize(mean, std)(image),
                                  jvis.Denormalize(mean, std)(image))


def _jax_sample(image, ins):
    """The JAX CLI's --sample_num composition (cl4wsis_tpu/cli/main.py)."""
    img = np.clip(jvis.denorm(image[0]), 0, 1)
    ins_rgb = (jvis.label_to_color_image(ins % 72 + 1) * 255
               * (ins >= 0)[..., None])
    return np.concatenate([(img * 255).astype(np.uint8), ins_rgb],
                          axis=1).astype(np.uint8)


def test_sample_image_equals_the_jax_cli_composition():
    """Exactly; ids 72 and 145 (= 72 mod 73) stay coloured, -1 is black."""
    rs = np.random.RandomState(1)
    image = rs.randn(1, 6, 8, 3).astype(np.float32)
    ins = rs.randint(-1, 200, (6, 8))
    ins[0, :3] = (72, 145, -1)
    got = vis.sample_image(image[0], ins)
    np.testing.assert_array_equal(got, _jax_sample(image, ins))
    assert got.shape == (6, 16, 3) and got.dtype == np.uint8
    assert got[0, 8:10].max(axis=-1).min() > 0 and got[0, 10].max() == 0


# ---------------------------------------------------------------- logger

@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_add_image_png_equals_jax(tmp_path, kind):
    rs = np.random.RandomState(2)
    image = (rs.randint(0, 256, (5, 7, 3)).astype(np.uint8)
             if kind == "uint8" else rs.rand(5, 7, 3).astype(np.float32) * 1.2)
    ours = Logger(str(tmp_path / "port"), summary=False)
    theirs = jlogging.Logger(str(tmp_path / "jax"), summary=False)
    for lg in (ours, theirs):
        lg.add_image("val e0/sample", image, 3)
    name = os.path.join("images", "val e0_sample_3.png")
    got = np.asarray(Image.open(tmp_path / "port" / name))
    want = np.asarray(Image.open(tmp_path / "jax" / name))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (5, 7, 3)
    Logger(str(tmp_path / "rank1"), rank=1, summary=False).add_image("a",
                                                                     image)
    assert not (tmp_path / "rank1").exists()


def test_confusion_figure_equals_jax(tmp_path):
    """The same normalised image data as JAX's figure, and the figure
    saves through add_figure."""
    rs = np.random.RandomState(3)
    ours, theirs = StreamSegMetrics(4), JaxMetrics(4)
    pairs = [(rs.randint(0, 4, (1, 8, 8)), rs.randint(0, 4, (1, 8, 8)))
             for _ in range(2)]
    for m in (ours, theirs):
        for truth, pred in pairs:
            m.update(truth, pred)
    ours.confusion_matrix[3] = 0            # a class never seen: a 0 row
    theirs.confusion_matrix[3] = 0
    fig, jfig = ours.confusion_figure(), theirs.confusion_figure()
    got = np.asarray(fig.axes[0].images[0].get_array())
    np.testing.assert_array_equal(got, jfig.axes[0].images[0].get_array())
    np.testing.assert_allclose(got[:3].sum(1), 1.0)
    Logger(str(tmp_path), summary=False).add_figure("Conf", fig, 1)
    assert (tmp_path / "figures" / "Conf_1.png").exists()


# ------------------------------------------------------------------- TTA

W3 = np.random.RandomState(4).randn(3, 3, 3, 5).astype(np.float32) * 0.3


def _jax_apply(x):
    """A 3x3 conv to 5 class logits (NHWC), position-dependent, so that
    the scales and the flip matter."""
    return lax.conv_general_dilated(x, jnp.asarray(W3), (1, 1), "SAME",
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _port_apply(x):
    w = torch.from_numpy(W3).permute(3, 2, 0, 1)
    return torch.nn.functional.conv2d(x, w, padding=1)


@pytest.mark.parametrize("do_flip", [True, False])
@pytest.mark.parametrize("fusion", ["mean", "sum"])
def test_test_augmentation_matches_jax(do_flip, fusion):
    """Scales (0.75, 1, 1.25) on a 20x24 batch of 2: fused logits within
    1e-5 of JAX's, the argmax equal where the top two logits are apart."""
    x = np.random.RandomState(5).randn(2, 20, 24, 3).astype(np.float32)
    scales = (0.75, 1.0, 1.25)
    want, want_pred = jax.jit(lambda x: jax_tta(_jax_apply, x, scales,
                                                do_flip, fusion))(x)
    got, pred = tta.test_augmentation(
        _port_apply, torch.from_numpy(x).permute(0, 3, 1, 2), scales,
        do_flip, fusion)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    top2 = np.sort(want, axis=1)[:, -2:]
    apart = top2[:, 1] - top2[:, 0] > 1e-4
    np.testing.assert_array_equal(pred.numpy()[apart],
                                  np.asarray(want_pred)[apart])
    with pytest.raises(ValueError):
        tta.test_augmentation(_port_apply, got, fusion="max")


# ---------------------------------------------------------------- native

@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_stats_equal_jax(connectivity):
    rs = np.random.RandomState(6)
    mask = rs.rand(40, 33) < 0.45
    got, got_st = native.connected_components_stats(mask, connectivity)
    want, want_st = jnative.connected_components_stats(mask, connectivity)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_st, want_st)
    assert got.max() == len(got_st) > 5
    with pytest.raises(RuntimeError):
        native.connected_components_stats(mask, connectivity, max_comp=2)


def test_mask_iou_equals_jax():
    rs = np.random.RandomState(7)
    a = rs.rand(4, 12, 10) < 0.5
    b = rs.rand(3, 12, 10) < 0.3
    b[2] = False                                  # an empty mask
    got = native.mask_iou(a, b)
    np.testing.assert_array_equal(got, jnative.mask_iou(a, b))
    assert got.shape == (4, 3) and (got[:, 2] == 0).all()
    with pytest.raises(ValueError):
        native.mask_iou(a, b[:, :6])


# ----------------------------------------------------------- device time

def _kernel(ts, dur, corr, dev=0, stream=7, name="void k<4>(int)",
            cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": dev, "tid": stream,
            "ts": float(ts), "dur": float(dur),
            "args": {"device": dev, "stream": stream, "correlation": corr,
                     "External id": corr + 1000}}


def _launch(ts, corr, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "pid": 9,
            "tid": 9, "ts": float(ts), "dur": 1.0,
            "args": {"correlation": corr, "External id": corr + 1000}}


def _grid_union(intervals):
    """numpy: the number of microseconds covered (integer intervals)."""
    grid = np.zeros(4000, bool)
    for lo, hi in intervals:
        grid[int(lo):int(hi)] = True
    return int(grid.sum())


def _random_trace(rs, n_steps=3):
    """Overlapping kernels, copies and memsets on two streams of device 0
    and on device 1; each launched inside one of `n_steps` host step
    ranges; a launch through the driver; a GPU range that is no work."""
    events, per_dev = [], {0: [], 1: []}
    per_step = [[] for _ in range(n_steps)]
    corr = 0
    for s in range(n_steps):
        lo = 1000 * s
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": f"train_step#{s}", "pid": 9, "tid": 9,
                       "ts": float(lo), "dur": 900.0, "args": {}})
        for _ in range(12):
            dev, stream = ((0, 7), (0, 13), (1, 7))[rs.randint(3)]
            t0 = lo + rs.randint(0, 850)
            dur = rs.randint(1, 400)
            cat = rs.choice(["kernel", "kernel", "gpu_memcpy", "gpu_memset"])
            name = f"void k_{'abc'[corr % 3]}<float>(int)"
            events.append(_kernel(t0 + 20, dur, corr, dev, stream, cat=cat,
                                  name=name))
            events.append(_launch(t0, corr, rs.choice(["cuda_runtime",
                                                       "cuda_driver"])))
            per_step[s].append((t0 + 20, t0 + 20 + dur))
            per_dev[dev].append((t0 + 20, t0 + 20 + dur))
            corr += 1
    events.append({"ph": "X", "cat": "gpu_user_annotation", "name": "step#0",
                   "pid": 0, "tid": 7, "ts": 0.0, "dur": 3900.0, "args": {}})
    return events, per_step, per_dev


def _write(path, events):
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_time_against_a_numpy_union(tmp_path, seed):
    """Busy time per device, per step and by kernel name, against a numpy
    interval union on a hand-written trace."""
    events, per_step, per_dev = _random_trace(np.random.RandomState(seed))
    _write(tmp_path / "trace.json", events)
    rep = device_time.device_time_report(str(tmp_path))
    assert set(rep["planes"]) == {"cuda:0", "cuda:1"}
    for d in (0, 1):
        p = rep["planes"][f"cuda:{d}"]
        assert p["busy_s"] * 1e6 == pytest.approx(_grid_union(per_dev[d]))
        lo = min(a for a, _ in per_dev[d])
        assert p["span_s"] * 1e6 == pytest.approx(
            max(b for _, b in per_dev[d]) - lo)
    assert rep["device_busy_s"] * 1e6 == pytest.approx(
        sum(_grid_union(v) for v in per_dev.values()))
    steps = device_time.module_step_times(str(tmp_path / "trace.json"))
    assert list(steps) == ["train_step"]
    assert [s * 1e6 for s in steps["train_step"]] == pytest.approx(
        [_grid_union(iv) for iv in per_step])
    assert device_time.main_module_times(str(tmp_path)) == steps["train_step"]
    ops = device_time.op_breakdown(str(tmp_path), top=10)
    dev_events = [e for e in events if e["cat"] in device_time.DEVICE_CATS]
    assert sum(n for _, _, n in ops) == len(dev_events)
    assert sum(t for _, t, _ in ops) * 1e6 == pytest.approx(
        sum(e["dur"] for e in dev_events))
    assert {name for name, _, _ in ops} == {"k_a", "k_b", "k_c"}
    assert [t for _, t, _ in ops] == sorted((t for _, t, _ in ops),
                                            reverse=True)


def test_device_time_pairs_by_external_id_and_sums_files(tmp_path):
    """A device event whose launch event is missing pairs with its operator
    by External id; two files add up; a kernel name loses its template
    arguments, parameters and instance number."""
    op = {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 9, "tid": 9,
          "ts": 10.0, "dur": 5.0, "args": {"External id": 1005}}
    rng = {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#4",
           "pid": 9, "tid": 9, "ts": 0.0, "dur": 50.0, "args": {}}
    k = _kernel(30, 8, 5, name="void at::native::gemm_kernel_12<float>(int)")
    _write(tmp_path / "a.json", [rng, op, k])
    _write(tmp_path / "b.json", [_kernel(0, 3, 1), _kernel(2, 3, 2)])
    assert device_time.module_step_times(str(tmp_path / "a.json")) == {
        "ProfilerStep": [pytest.approx(8e-6)]}
    rep = device_time.device_time_report(str(tmp_path))
    assert rep["planes"]["cuda:0"]["busy_s"] == pytest.approx(13e-6)
    assert device_time.op_breakdown(str(tmp_path / "a.json")) == [
        ("at::native::gemm_kernel", pytest.approx(8e-6), 1)]


def test_a_cpu_trace_has_no_device_time(tmp_path):
    """StepTimer's trace of a CPU run: its three step ranges are found,
    with 0 device time, and the report has no plane."""
    timer = StepTimer(str(tmp_path))
    a = torch.randn(64, 64)
    for i in range(6):
        timer.start_step(i)
        (a @ a).sum()
        timer.end_step(i)
    timer.close()
    assert os.listdir(tmp_path) == ["trace_steps_2-4.json"]
    assert device_time.device_time_report(str(tmp_path)) == {
        "device_busy_s": 0, "span_s": 0.0, "planes": {}}
    assert device_time.module_step_times(str(tmp_path)) == {
        "train_step": [0.0, 0.0, 0.0]}
    assert device_time.op_breakdown(str(tmp_path)) == []
