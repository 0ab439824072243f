"""The harness on the CPU at a tiny size: the flags, the result line's
keys, lookup by name, the work counts against hand sums, and the modules
a run loads."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.tests import tiny
from benchmark.tests.tiny import DP, PHASE2, REPO, VALIDATE

RUN_PY = os.path.join(REPO, "benchmark", "run.py")
SEED = 2 ** 31 + 977            # larger than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _run(root, name, trace):
    from benchmark.harness import runner
    return runner.run(root, name, SEED, 1.0, trace, "cpu",
                      cell=tiny.cell(root, name))


def test_flags():
    sys.path.insert(0, os.path.dirname(RUN_PY))
    import importlib
    run = importlib.import_module("run")
    a = run.parse(["--workload", "x", "--seed", str(SEED), "--seconds",
                   "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("x", SEED, 10.0, 1)
    for bad in (["--seed", "1", "--seconds", "1"],
                ["--workload", "x", "--seed", "1", "--seconds", "1",
                 "--trace", "2"]):
        with pytest.raises(SystemExit):
            run.parse(bad)


@pytest.mark.parametrize("name", [PHASE2, VALIDATE, DP])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(root, name, trace):
    res = _run(root, name, trace)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    cell = tiny.cell(root, name)
    want = {m["name"] for m in (cell.per_layer() if trace
                                else cell.end_to_end())}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    else:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res, allow_nan=False)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])


def test_found_by_name(root):
    """A configuration, a mix, a limits file and a metric dropped in as new
    files are found by the names BENCHMARK.json gives them."""
    from benchmark.harness.registry import Cell
    bench = os.path.join(root, "bench")
    with open(os.path.join(bench, "configs", "tiny-r.json")) as f:
        cfg = json.load(f)
    cfg["classes"] = [11, 10]
    with open(os.path.join(bench, "configs", "new-cfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "newmix.json"), "w") as f:
        json.dump({"driver": "phase2", "n_batches": 2, "check_steps": 1,
                   "warmup_steps": 1, "trace_steps": 1}, f)
    with open(os.path.join(bench, "limits", "new-cfg.newmix.json"), "w") as f:
        json.dump({"loss_gap": 0.5}, f)
    with open(os.path.join(bench, "metrics", "new_metric.x.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append({"name": "new-cfg",
                         "file": "bench/configs/new-cfg.json"})
    b["workloads"].append({"name": "new-cfg.newmix", "config": "new-cfg",
                           "traffic": "newmix", "chips": 1})
    b["per_layer"].append({"name": "new_metric.x", "unit": "%",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "setup_s",
                           "workloads": ["new-cfg.newmix"]})
    alt = os.path.join(root, "alt")
    os.makedirs(alt)
    with open(os.path.join(alt, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    os.symlink(bench, os.path.join(alt, "bench"))
    cell = Cell(alt, "new-cfg.newmix", bench)
    assert cell.config["classes"] == [11, 10]
    assert cell.traffic["n_batches"] == 2
    assert cell.limits == {"loss_gap": 0.5}
    assert cell.driver().__name__ == "benchmark.drivers.phase2"
    assert [m["name"] for m in cell.per_layer()] == ["new_metric.x"]
    assert cell.reader("new_metric.x").read(None) == 42.0
    assert "setup_s" in {m["name"] for m in cell.end_to_end()}


def test_flops_against_hand_sums():
    from benchmark.harness import work
    conv = torch.nn.Conv2d(8, 16, 3, padding=1, bias=False).to("meta")
    x = torch.empty(2, 8, 10, 12, device="meta")
    assert work.count_flops(lambda: conv(x)) == 2 * 2 * 16 * 10 * 12 * 8 * 9
    y = torch.empty(2, 8, 10, 12, device="meta", requires_grad=True)
    # forward, then the input's and the weight's gradients: 3x forward
    assert work.count_flops(lambda: conv(y).sum().backward()) == \
        3 * 2 * 2 * 16 * 10 * 12 * 8 * 9


def test_kernel_bytes_against_hand_sums():
    from benchmark.harness import work
    cfg = {"batch_size": 2, "crop_size": 8, "classes": [4, 3],
           "phase2": {"max_peaks": 5, "max_ctr": 2, "max_cluster": 1,
                      "max_comp": 4},
           "eval": {"max_ctr": 3}}
    hw = 64
    topk_cam = 2 * 3 * hw * 4 + 2 * 3 * 5 * 8
    topk_nms = 2 * 3 * hw * 4 + 2 * 3 * 2 * 8
    cc = 2 * (2 * 2 * hw * 4)
    rt = 8 * 2 * hw * 4
    stamps = (2 * 4 * 13 + 2 * 6 * hw * 4) + (2 * 9 * 13 + 2 * 6 * hw * 4)
    assert work.phase2_kernel_bytes(cfg) == \
        topk_cam + topk_nms + cc + rt + stamps
    assert work.eval_kernel_bytes(cfg, 5, 7) == \
        2 * (2 * 35 * 4) + (6 * 35 * 4 + 6 * 3 * 8) + 8 * 35 * 4


def test_run_loads_no_jax(root, tmp_path):
    """A whole tiny run in a fresh process loads neither JAX nor the JAX
    package (top-level names compared whole)."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.harness import runner\n"
        f"root = {root!r}\n"
        f"res = runner.run(root, {PHASE2!r}, 5, 0.5, False, 'cpu', "
        f"cell=tiny.cell(root, {PHASE2!r}))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        "print(json.dumps(runner.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path),
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, bad = (json.loads(x) for x in out.stdout.strip().split("\n")[-2:])
    assert "cl4wsis_tpu_torch" in loaded
    assert bad == [] and not {"jax", "jaxlib", "flax", "cl4wsis_tpu"} & \
        set(loaded)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(REPO, "benchmark", "reference")
    for f in sorted(os.listdir(ref)):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert tops <= {"torch", "numpy", "__future__", "typing",
                            "contextlib", "dataclasses", "collections",
                            "functools", "math"}, (f, tops)


def test_benchmark_sources_import_no_jax():
    bench = os.path.join(REPO, "benchmark")
    for d, _, files in os.walk(bench):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(d, f))}
                assert not tops & {"jax", "jaxlib", "flax", "cl4wsis_tpu"}, f


def test_no_result_without_a_card(tmp_path):
    """run.py exits non-zero and prints no result line where torch sees
    fewer CUDA devices than the cell asks for (always so here)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, RUN_PY, "--workload",
                          "r101-voc15-5.phase2", "--seed", "1", "--seconds",
                          "1"], capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
