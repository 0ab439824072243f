"""The port's CLI on real-data fixtures, end to end on the CPU at a tiny
size (the port of tests/test_cli_voc.py and of the coco-voc chain of
tests/test_cli_chain_coco.py): the mini-VOC chain step 0 -> phase 1 ->
phase 2 with the three validation modes, --test, --pseudo with
--val_on_trainset, the COCO-to-VOC chain, and the first batch of
build_data against the JAX package's."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from cl4wsis_tpu.cli import main as jax_cli
from cl4wsis_tpu.cli.config import parse_config as jax_parse_config
from cl4wsis_tpu_torch.cl.ckpt import load_checkpoint
from cl4wsis_tpu_torch.cli import config as port_config
from cl4wsis_tpu_torch.cli import main as cli
from cl4wsis_tpu_torch.cli.config import parse_config
from cl4wsis_tpu_torch.data.loader import Loader
from cl4wsis_tpu_torch.train import schedule
from tests.test_coco_data import _write_fake_coco
from tests.test_data import _write_fake_voc
from torch_one_thread import one_torch_thread  # noqa: F401

TINY = ["--tiny", "true", "--epochs", "1", "--batch_size", "8",
        "--crop_size", "48", "--crop_size_val", "48", "--dtype", "float32",
        "--kernel", "15", "--val_kernel", "15", "--pretrained", "false",
        "--device", "cpu", "--num_workers", "0"]
STEP0 = ["--step", "0", "--bce", "true", "--optim", "adam", "--lr", "5e-5"]
PHASE1 = ["--step", "1", "--weakly", "true", "--phase", "1", "--optim",
          "sgd", "--lr", "1e-3", "--pseudo_ep", "0", "--affinity", "true",
          "--loss_de", "1"]
PHASE2 = ["--step", "1", "--weakly", "true", "--phase", "2", "--optim",
          "adam", "--lr", "5e-5"]


@pytest.fixture
def voc_root(tmp_path):
    """A 16-image mini-VOC (classes 16 and 1, 48^2) and, beside it, the
    checkpoint root, removed after the test (a tiny model's checkpoint
    with Adam moments is ~0.5 GB)."""
    _write_fake_voc(str(tmp_path), n_images=16, size=48)
    yield str(tmp_path)
    shutil.rmtree(tmp_path / "ck", ignore_errors=True)


def _run(root, argv, dataset="voc", task="15-5", rec=None):
    return cli.main(["--data_root", root, "--dataset", dataset, "--task",
                     task, "--checkpoint", os.path.join(root, "ck"),
                     "--logdir", os.path.join(root, "logs")] + TINY + argv,
                    on_trainer=rec)


def _results(root, name, task="voc-15-5-ov"):
    path = os.path.join(root, "logs", task, name, f"{name}.jsonl")
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["type"] == "results"]


def _ck(root, name, task="voc-15-5-ov"):
    return os.path.join(root, "ck", "step", task, name)


def test_voc_chain_with_three_validation_modes(voc_root):
    """Step 0 validates instance mAP, phase 1 the CAM mIoU, phase 2
    instance mAP; the validation set is the mini-VOC's 16 images. Phase 2
    keeps phase 1's body and seg bit for bit."""
    made = []
    assert _run(voc_root, STEP0 + ["--name", "t"], rec=made.append) == 0
    (r0,) = _results(voc_root, "t")
    assert set(r0) >= {"map", "map50", "ap", "truncated_centers"}
    step0 = _ck(voc_root, "t_0")
    assert _run(voc_root, PHASE1 + ["--name", "t1", "--step_ckpt", step0],
                rec=made.append) == 0
    (r1,) = _results(voc_root, "t1")
    assert r1["Total samples"] == 16 and "Mean Precision" in r1
    p1 = _ck(voc_root, "t1_1")
    assert _run(voc_root, PHASE2 + ["--name", "t2", "--step_ckpt", step0,
                                    "--seg_ckpt", p1], rec=made.append) == 0
    (r2,) = _results(voc_root, "t2")
    assert np.isfinite(r2["map"]) and len(r2["ap"]) > 0
    assert os.path.exists(_ck(voc_root, "t2_1"))
    # the trainers read the real loader: at step 0 the 8 images with the
    # base class 1, at step 1 the 16 with the new class 16, in batches of 8
    assert [t.cfg.max_iters for t in made] == [1, 2, 2]
    b1, sd = load_checkpoint(p1)["model"], made[2].model.state_dict()
    frozen = [k for k in b1 if schedule.default_group_fn(k) in ("body", "seg")]
    assert len(frozen) > 100
    assert all(torch.equal(sd[k], b1[k]) for k in frozen)


def test_voc_deeplabv3_and_test_only(voc_root):
    """--model DeeplabV3 validates the semantic mIoU; --test then evaluates
    the saved checkpoint without training and gives the same results."""
    argv = STEP0 + ["--name", "dl", "--model", "DeeplabV3"]
    assert _run(voc_root, argv) == 0
    (r,) = _results(voc_root, "dl")
    assert r["Total samples"] == 16 and 0 <= r["Mean IoU"] <= 1
    path = _ck(voc_root, "dl_0")
    mtime = os.path.getmtime(path)
    assert _run(voc_root, argv + ["--test", "true", "--continue_ckpt",
                                  "true"]) == 0
    assert os.path.getmtime(path) == mtime
    again = _results(voc_root, "dl")
    assert len(again) == 2 and again[0] == again[1]


def test_voc_pseudo_supervised_and_val_on_trainset(voc_root):
    """--pseudo trains step 1 supervised from precomputed labels;
    --val_on_trainset validates on the train split."""
    pdir = os.path.join(voc_root, "voc", "mylab", "ins_seg_mylab")
    os.makedirs(pdir)
    masks = np.zeros((1, 48, 48), bool)
    masks[0, 8:24, 8:24] = True
    for i in range(16):
        np.save(os.path.join(pdir, f"img_{i:03d}.npy"),
                {"mask": masks, "class": np.array([15])})
    assert _run(voc_root, STEP0 + ["--name", "b"]) == 0
    made = []
    assert _run(voc_root, ["--step", "1", "--name", "p", "--weakly", "true",
                           "--pseudo", "mylab", "--optim", "adam", "--lr",
                           "5e-5", "--step_ckpt", _ck(voc_root, "b_0"),
                           "--val_on_trainset", "true"],
                rec=made.append) == 0
    assert made[0].supervised_pseudo and made[0].pseudolabeler is None
    (r,) = _results(voc_root, "p")
    assert np.isfinite(r["map"])


def test_coco_voc_chain_with_resnet(tmp_path, monkeypatch):
    """The COCO-to-VOC chain: step 0 supervised on COCO, step 1 phase 1
    and phase 2 on VOC images in the COCO label space. Its recipe's
    WideResNet-38 is not ported (ROADMAP item 11), so the chain runs the
    ResNet-101 (tiny) body with the same data path."""
    root = str(tmp_path)
    _write_fake_coco(root, n_images=8)
    _write_fake_voc(root, n_images=8)
    finalize = port_config.Config.finalize

    def resnet(self, iters_per_epoch=0):
        cfg = finalize(self, iters_per_epoch)
        cfg.backbone, cfg.output_stride = "resnet101", 16
        cfg.pooling = cfg.crop_size // 16
        return cfg
    monkeypatch.setattr(port_config.Config, "finalize", resnet)
    task = "coco-voc-voc-ov"
    try:
        assert _run(root, STEP0 + ["--name", "FT", "--weight_decay", "0"],
                    "coco-voc", "voc") == 0
        step0 = _ck(root, "FT_0", task)
        assert _run(root, PHASE1 + ["--name", "P1", "--step_ckpt", step0,
                                    "--lr_policy", "warmup"],
                    "coco-voc", "voc") == 0
        p1 = _ck(root, "P1_1", task)
        assert os.path.exists(p1)
        made = []
        assert _run(root, PHASE2 + ["--name", "P2", "--step_ckpt", step0,
                                    "--seg_ckpt", p1],
                    "coco-voc", "voc", rec=made.append) == 0
        assert os.path.exists(_ck(root, "P2_1", task))
        assert made[0].classes == [61, 20]
        (r,) = _results(root, "P2", task)
        assert np.isfinite(r["map"])
    finally:
        shutil.rmtree(tmp_path / "ck", ignore_errors=True)


@pytest.mark.parametrize("ds,step,workers", [("voc", 1, 0), ("voc", 0, 2),
                                             ("coco", 0, 0),
                                             ("coco-voc", 0, 0),
                                             ("coco-voc", 1, 0)])
def test_build_data_first_batch_matches_jax(tmp_path, ds, step, workers):
    """The first batch of the port's build_data equals the JAX build_data's,
    with the loader's worker processes or without; the validation sets
    give the same first sample."""
    root = str(tmp_path)
    _write_fake_voc(root, n_images=8, size=64, rich=True, paint=True)
    _write_fake_coco(root, n_images=8)
    task = "15-5" if ds == "voc" else "voc"
    argv = ["--data_root", root, "--dataset", ds, "--task", task, "--step",
            str(step), "--batch_size", "4", "--crop_size", "48",
            "--crop_size_val", "40", "--seed", "3", "--num_workers",
            str(workers)]
    loader, val = cli.build_data(parse_config(argv + ["--device", "cpu"]))
    jloader, jval = jax_cli.build_data(jax_parse_config(argv))
    assert isinstance(loader, Loader) and len(loader) == len(jloader) > 0
    got, want = next(iter(loader.epoch(1))), next(iter(jloader.epoch(1)))
    loader.close()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert len(val) == len(jval)
    g, w = val[0], jval[0]
    for k in ("image", "seg", "gt_masks", "gt_labels"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_real_data_cli_without_device_raises_without_a_card(voc_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--data_root", voc_root, "--dataset", "voc",
                  "--checkpoint", os.path.join(voc_root, "ck")] + argv +
                 STEP0)
