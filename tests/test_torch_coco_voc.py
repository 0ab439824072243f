"""The COCO-to-VOC recipe through the port's CLI on the CPU: the chain step
0 -> phase 1 -> phase 2 on the recipe's own WideResNet-38 (Config.finalize
unpatched; the body cut to one block a module for time), with validation
after each run and serving the phase-2 checkpoint; and the recipe's crops
reaching the data. (The norms through the CLI are in
tests/test_torch_norms.py, the wide pretrained file in
tests/test_torch_trainer.py.)"""

import shutil

import numpy as np
import pytest
import torch

from cl4wsis_tpu_torch.cl import ckpt
from cl4wsis_tpu_torch.cl.ckpt import load_checkpoint
from cl4wsis_tpu_torch.cli import main as cli_main
from cl4wsis_tpu_torch.models import assembly
from cl4wsis_tpu_torch.models.wide_resnet import WiderResNet38A2
from cl4wsis_tpu_torch.serve import Predictor
from cl4wsis_tpu_torch.train import schedule
from tests.test_coco_data import _write_fake_coco
from tests.test_data import _write_fake_voc
from tests.test_torch_cli_data import (PHASE1, PHASE2, STEP0, _ck, _results,
                                       _run)
from torch_one_thread import one_torch_thread  # noqa: F401

WRN16 = (1, 1, 1, 1, 1, 1)


@pytest.fixture
def wrn16(monkeypatch):
    """WideResNet-38's structure cut to one block a module, widths kept
    (~121 M parameters with the heads)."""
    monkeypatch.setitem(assembly._WIDE_STRUCTURES, "wider_resnet38_a2",
                        WRN16)


def test_coco_voc_chain_with_wide_resnet(tmp_path, wrn16):
    """Step 0 on COCO, phase 1 and phase 2 on VOC images in
    the COCO label space, each validating; the recipe's WideResNet at
    output stride 8 unpatched. Phase 2 keeps phase 1's body and seg bit for
    bit; Predictor.from_checkpoint serves the phase-2 checkpoint (center
    biases +0.3) bit-equal to a Predictor over the trainer's model."""
    root = str(tmp_path)
    _write_fake_coco(root, n_images=4)
    _write_fake_voc(root, n_images=4)
    task = "coco-voc-voc-ov"
    made = []
    small = ["--batch_size", "4"]      # one batch of the 4 images a run
    try:
        assert _run(root, STEP0 + small + ["--name", "W"], "coco-voc", "voc",
                    rec=made.append) == 0
        (r0,) = _results(root, "W", task)
        assert np.isfinite(r0["map"])
        step0 = _ck(root, "W_0", task)
        assert _run(root, PHASE1 + small + ["--name", "W1", "--step_ckpt",
                                            step0, "--lr_policy", "warmup"],
                    "coco-voc", "voc", rec=made.append) == 0
        (r1,) = _results(root, "W1", task)
        assert r1["Total samples"] == 4
        p1 = _ck(root, "W1_1", task)
        assert _run(root, PHASE2 + small + ["--name", "W2", "--step_ckpt",
                                            step0, "--seg_ckpt", p1],
                    "coco-voc", "voc", rec=made.append) == 0
        (r2,) = _results(root, "W2", task)
        assert np.isfinite(r2["map"])
        for t in made:
            assert isinstance(t.model.body, WiderResNet38A2)
            assert (t.cfg.backbone, t.cfg.output_stride) == (
                "wider_resnet38_a2", 8)
        assert made[0].classes == [61] and made[2].classes == [61, 20]
        assert [t.cfg.max_iters for t in made] == [1, 1, 1]
        assert made[1].pseudolabeler.conv1.in_channels == 4096
        b1, sd = load_checkpoint(p1)["model"], made[2].model.state_dict()
        frozen = [k for k in b1
                  if schedule.default_group_fn(k) in ("body", "seg")]
        assert len(frozen) > 100
        assert all(torch.equal(sd[k], b1[k]) for k in frozen)

        p2 = _ck(root, "W2_1", task)
        state = load_checkpoint(p2)["model"]
        for k in state:
            if k.startswith("instance_head.classifier.center.cls.") and \
                    k.endswith(".bias"):
                state[k] += 0.3
        ckpt.save_checkpoint(p2 + "_lifted", {"model": state})
        kw = dict(device="cpu", dtype="float32", val_kernel=15)
        served = Predictor.from_checkpoint(p2 + "_lifted", (61, 20),
                                           "wider_resnet38_a2", 8, 48, **kw)
        assert isinstance(served.model.body, WiderResNet38A2)
        ref = Predictor(made[2].model, state, **kw)
        img = (np.random.RandomState(0).rand(40, 56, 3) * 255).astype(
            np.uint8)
        got, want = served(img), ref(img)
        for k in ("ins_map", "labels", "scores", "valid", "seg"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)
        assert len(got.instances()) > 0
    finally:
        shutil.rmtree(tmp_path / "ck", ignore_errors=True)


def test_coco_voc_data_takes_the_recipe_crops(monkeypatch):
    """main() builds the data from the finalized config: --dataset coco-voc
    crops training images at the recipe's 448 and validates at 512 (the
    flags' defaults are 512 / 512); --tiny keeps the flags' crops."""
    seen = []

    class Stop(Exception):
        pass

    def build_data(cfg):
        seen.append((cfg.crop_size, cfg.crop_size_val))
        raise Stop

    monkeypatch.setattr(cli_main, "build_data", build_data)
    argv = ["--dataset", "coco-voc", "--task", "voc", "--device", "cpu"]
    for extra in ([], ["--tiny", "--crop_size", "48", "--crop_size_val",
                       "40"]):
        with pytest.raises(Stop):
            cli_main.main(argv + extra)
    assert seen == [(448, 512), (48, 40)]
