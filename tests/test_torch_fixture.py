"""The painted-fixture protocol of the port against the JAX package's: the
fixture writer (``cl4wsis_tpu_torch/data/fixture.py`` against
``tests/test_data._write_fake_voc``), the runner's stage flags
(``scripts/run_rebuild_fixture_torch.py`` against
``scripts/run_rebuild_fixture.py``), the runner through all three stages
on the CPU at a tiny size with the JAX runner's reader on its logs, and
the two examples for 2 steps (the protocol's step-0 training against
JAX's is in tests/test_torch_fixture_step0.py)."""

import argparse
import importlib.util
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from cl4wsis_tpu_torch.data.fixture import write_fake_voc
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_runner = _load("scripts/run_rebuild_fixture.py", "jax_fixture_runner")
runner = _load("scripts/run_rebuild_fixture_torch.py", "torch_fixture_runner")


def test_writer_matches_the_jax_fixture(tmp_path):
    """48 images at 64^2, rich, wrap, paint: the same JSON bytes and the
    same JPEG bytes (one Pillow here), so the same pixels."""
    from test_data import _write_fake_voc
    kw = dict(n_images=48, size=64, rich=True, wrap=True, paint=True)
    _write_fake_voc(str(tmp_path / "jax"), **kw)
    write_fake_voc(str(tmp_path / "port"), **kw)
    for split in ("train", "val"):
        name = f"voc/pascal_sbd_{split}.json"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    body = json.loads(
        (tmp_path / "port/voc/pascal_sbd_train.json").read_text())
    assert len(body["images"]) == 48 and len(body["annotations"]) == 96
    assert {a["category_id"] for a in body["annotations"]} == set(range(1, 21))
    jpgs = sorted(os.listdir(tmp_path / "port/voc/JPEGImages"))
    assert jpgs == sorted(os.listdir(tmp_path / "jax/voc/JPEGImages"))
    assert len(jpgs) == 48
    for name in jpgs:
        port = tmp_path / "port/voc/JPEGImages" / name
        ref = tmp_path / "jax/voc/JPEGImages" / name
        assert port.read_bytes() == ref.read_bytes(), name
    # the painted objects are there: a class-coloured block on the noise
    arr = np.asarray(Image.open(tmp_path / "port/voc/JPEGImages" / jpgs[0]))
    ann = body["annotations"][0]
    x0, y0, w, h = ann["bbox"]
    block = arr[y0 + 2:y0 + h - 2, x0 + 2:x0 + w - 2].reshape(-1, 3).mean(0)
    colour = [(ann["category_id"] * m) % 200 + 55 for m in (37, 91, 151)]
    assert np.abs(block - colour).max() < 8


def _args(**kw):
    base = dict(batch=4, size=64, seed=42, epochs=250, cl_epochs=None,
                torch_init=False, lr0="3e-4", device="cuda", tiny=False)
    return argparse.Namespace(**(base | kw))


@pytest.mark.parametrize("torch_init", [False, True])
@pytest.mark.parametrize("stage", ["step0", "phase1", "phase2"])
def test_stage_args_match_the_jax_runner(stage, torch_init):
    """Flag for flag the JAX runner's, then the port's --device."""
    for kw, jax_kw in (({}, {}), ({"epochs": 100, "device": "cpu"},
                                  {"epochs": 100}),
                       # --cl_epochs: phase 1 and phase 2 as a separate
                       # JAX run of that length
                       ({"cl_epochs": 100},
                        {} if stage == "step0" else {"epochs": 100})):
        port = runner._stage_args(stage, _args(torch_init=torch_init, **kw),
                                  "/r")
        want = jax_runner._stage_args(stage, _args(torch_init=torch_init,
                                                   **jax_kw), "/r")
        device = kw.get("device", "cuda")
        assert port == want + ["--device", device]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The runner at --tiny --device cpu on 8 painted images, 1 epoch a
    stage (2 batches of 4): its records."""
    root = tmp_path_factory.mktemp("fixture")
    records = runner.run_seed(runner.get_parser().parse_args(
        ["--root", str(root), "--tiny", "--device", "cpu", "--paint",
         "--wrap", "--images", "8", "--epochs", "1"]), str(root))
    return root, records


def test_runner_takes_the_fixture_through_three_stages(tiny_run):
    """rc 0 in each stage, finite losses, a checkpoint each, and the JAX
    runner's reader gets the same losses and final metrics from the
    port's logs as the port's reader."""
    root, records = tiny_run
    assert [r["stage"] for r in records] == ["step0", "phase1", "phase2"]
    logs = str(root / "rebuild_logs")
    for rec in records:
        assert rec["rc"] == 0
        assert len(rec["loss"]) == 1 and math.isfinite(rec["loss"][0])
        assert rec["step_ms"] > 0 and rec["vals"] == [rec["final"]]
        jax_view = jax_runner._collect(logs, "voc-15-5-ov",
                                       runner.NAMES[rec["stage"]])
        assert jax_view == {"loss": rec["loss"], "final": rec["final"]}
    assert set(records[0]["final"]) == {"map", "map50"}
    assert set(records[1]["final"]) == {"Mean IoU", "Mean Acc"}
    assert set(records[2]["final"]) == {"map", "map50"}
    ck = root / "rebuild_ckpt" / "step" / "voc-15-5-ov"
    assert sorted(os.listdir(ck)) == ["RB1_1", "RB2_1", "RB_0"]


def test_infer_example_serves_the_phase2_checkpoint(tiny_run, tmp_path):
    root, _ = tiny_run
    infer = _load("examples/infer_torch.py", "infer_torch")
    out = tmp_path / "pred.json"
    coco = infer.main(str(root / "rebuild_ckpt/step/voc-15-5-ov/RB2_1"),
                      str(root / "data/voc/JPEGImages/img_000.jpg"),
                      device="cpu", backbone="resnet18", crop_size=64,
                      out=str(out))
    assert json.loads(out.read_text()) == coco
    for r in coco:
        assert 1 <= r["category_id"] <= 20 and r["image_id"] == 0


def test_train_synthetic_example_two_steps():
    example = _load("examples/train_synthetic_torch.py",
                    "train_synthetic_torch")
    res = example.main(2, device="cpu")
    assert 0.0 <= res["map50"] <= 1.0 and 0.0 <= res["map"] <= 1.0

