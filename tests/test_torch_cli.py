"""The port's CLI (cl4wsis_tpu_torch.cli.main) end to end on the CPU, at a
tiny size: the three-stage chain of upstream scripts/run.sh (step 0 ->
step 1 phase 1 -> step 1 phase 2) on --synthetic data with the checkpoint
identities it must keep, --continue_ckpt, the three validation modes with
a validation set given, --test, and --sample_num's images."""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from cl4wsis_tpu_torch.cl.ckpt import load_checkpoint
from cl4wsis_tpu_torch.cli import main as cli
from cl4wsis_tpu_torch.data.synthetic import make_sample
from cl4wsis_tpu_torch.train import schedule
from cl4wsis_tpu_torch.utils.visualize import sample_image
from tests.test_data import _write_fake_voc
from tests.test_torch_cli_data import STEP0 as VOC_STEP0
from tests.test_torch_cli_data import _run as voc_run
from torch_one_thread import one_torch_thread  # noqa: F401

COMMON = ["--synthetic", "true", "--tiny", "true", "--dataset", "voc",
          "--task", "15-5", "--batch_size", "8", "--crop_size", "64",
          "--dtype", "float32", "--kernel", "15", "--val_kernel", "15",
          "--epochs", "1", "--device", "cpu"]
STEP0 = ["--step", "0", "--name", "exp", "--bce", "true", "--optim", "adam",
         "--lr", "5e-5"]
PHASE1 = ["--step", "1", "--name", "exp_p1", "--weakly", "true", "--phase",
          "1", "--optim", "sgd", "--lr", "1e-3", "--lr_policy", "warmup",
          "--loss_de", "1", "--affinity", "true", "--pseudo_ep", "0"]
PHASE2 = ["--step", "1", "--name", "exp_p2", "--weakly", "true", "--phase",
          "2", "--optim", "adam", "--lr", "5e-5"]


class Recorder:
    """Given to cli.main as `on_trainer`: keeps every trainer main() builds,
    with the model's tensors just after a resume."""

    def __init__(self):
        self.made = []

    def __call__(self, trainer):
        self.made.append(trainer)
        load_resume = trainer.load_resume

        def resume(path):
            epoch = load_resume(path)
            trainer.resumed = (
                {k: v.clone() for k, v in trainer.model.state_dict().items()},
                copy.deepcopy(trainer.state.optimizer.state_dict()),
                trainer.state.step)
            return epoch
        trainer.load_resume = resume


@pytest.fixture
def root(tmp_path):
    """The checkpoint root, removed after the test (a tiny model's step-0
    checkpoint with Adam moments is ~0.5 GB)."""
    path = tmp_path / "checkpoints"
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _run(argv, root, tmp_path, rec=None):
    return cli.main(COMMON + ["--checkpoint", str(root), "--logdir",
                              str(tmp_path / "logs")] + argv, on_trainer=rec)


def _ck(root, name):
    return os.path.join(root, "step", "voc-15-5-ov", name)


def test_three_stage_chain(tmp_path, root):
    """Each stage writes its checkpoint; phase 1 starts from step 0's
    weights; phase 2's body and seg equal the phase-1 checkpoint's bit for
    bit after its epoch (frozen), its old model equals step 0's model."""
    rec = Recorder()
    assert _run(STEP0, root, tmp_path, rec) == 0
    step0 = _ck(root, "exp_0")
    assert os.path.exists(step0)
    assert _run(PHASE1 + ["--step_ckpt", step0], root, tmp_path, rec) == 0
    p1 = _ck(root, "exp_p1_1")
    assert os.path.exists(p1)
    assert _run(PHASE2 + ["--step_ckpt", step0, "--seg_ckpt", p1], root,
                tmp_path, rec) == 0
    assert os.path.exists(_ck(root, "exp_p2_1"))

    s0 = load_checkpoint(step0)["model"]
    b1 = load_checkpoint(p1)
    assert set(b1) >= {"model", "pseudolabeler", "peakgenerator",
                       "optimizer"}
    t2 = rec.made[2]
    sd = t2.model.state_dict()
    n = 0
    for k, v in b1["model"].items():
        if schedule.default_group_fn(k) in ("body", "seg"):
            assert torch.equal(sd[k], v), k
            n += 1
    assert n > 100
    for k, v in t2.model_old.state_dict().items():
        assert torch.equal(v, s0[k]), k
    for mod in ("pseudolabeler", "peakgenerator"):
        got = getattr(t2, mod).state_dict()
        assert all(torch.equal(got[k], v) for k, v in b1[mod].items())
    # phase 1 trained from step 0's backbone, not from a fresh one
    t1 = rec.made[1]
    assert any(not torch.equal(t1.model_old.state_dict()[k],
                               t1.model.state_dict()[k])
               for k in s0 if k.startswith("body."))
    assert torch.equal(t1.model_old.state_dict()["body.mod1.conv1.weight"],
                       s0["body.mod1.conv1.weight"])


def test_continue_ckpt(tmp_path, root, capsys):
    """--continue_ckpt resumes at the next epoch with the parameters and
    the optimizer state of the saved checkpoint, bit for bit, and trains
    on from the step count it had."""
    rec = Recorder()
    argv = STEP0 + ["--name", "r"]
    assert _run(argv, root, tmp_path, rec) == 0
    path = _ck(root, "r_0")
    saved = load_checkpoint(path)
    assert saved["epoch"] == 0 and saved["step"] == 4
    assert _run(argv + ["--epochs", "2", "--continue_ckpt", "true"], root,
                tmp_path, rec) == 0
    assert f"resumed from {path} at epoch 1" in capsys.readouterr().out
    model, opt, step = rec.made[1].resumed
    assert step == 4
    for k, v in saved["model"].items():
        assert torch.equal(model[k], v), k
    assert opt["param_groups"] == saved["optimizer"]["param_groups"]
    for i, s in saved["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(opt["state"][i][k].cpu(), v), (i, k)
    after = load_checkpoint(path)
    assert after["epoch"] == 1 and after["step"] == 8


def _val_set(n=3, size=64):
    """Samples of the synthetic generator at crop size, as a validation set
    gives them: image (1, H, W, 3), seg, instance masks and labels."""
    rs = np.random.RandomState(9)
    out = []
    for _ in range(n):
        s = make_sample(rs, size, 20)
        ids = [i for i in np.unique(s["inst"]) if i != 0]
        out.append({"image": s["image"][None], "seg": s["seg"],
                    "gt_masks": np.stack([s["inst"] == i for i in ids]),
                    "gt_labels": np.array([int(s["seg"][s["inst"] == i][0]) - 1
                                           for i in ids])})
    return out


def _results(tmp_path, name):
    path = tmp_path / "logs" / "voc-15-5-ov" / name / f"{name}.jsonl"
    return [r for r in map(json.loads, path.read_text().splitlines())
            if r["type"] == "results"]


def test_validation_modes_and_test(tmp_path, root, monkeypatch):
    """With a validation set, main validates in all three modes: DeeplabV3
    mIoU (step 0), phase-1 CAM mIoU, instance mAP after phase 2; --test
    then evaluates the phase-2 checkpoint without training and gives the
    same results as the run's own final pass."""
    val = _val_set()
    monkeypatch.setattr(cli, "build_data",
                        lambda cfg: (cli.SyntheticLoader(cfg), val))
    assert _run(STEP0 + ["--model", "DeeplabV3", "--name", "dl"], root,
                tmp_path) == 0
    (r,) = _results(tmp_path, "dl")
    assert r["Total samples"] == 3 and 0 <= r["Mean IoU"] <= 1
    assert _run(STEP0, root, tmp_path) == 0
    step0 = _ck(root, "exp_0")
    assert _run(PHASE1 + ["--step_ckpt", step0, "--epochs", "2",
                          "--val_interval", "1"], root, tmp_path) == 0
    cam = _results(tmp_path, "exp_p1")
    assert len(cam) == 2 and all("Mean Precision" in r for r in cam)
    p1 = _ck(root, "exp_p1_1")
    assert _run(PHASE2 + ["--step_ckpt", step0, "--seg_ckpt", p1,
                          "--val_flip"], root, tmp_path) == 0
    (ins,) = _results(tmp_path, "exp_p2")
    assert set(ins) >= {"map", "map50", "ap", "truncated_centers"}
    p2 = _ck(root, "exp_p2_1")
    mtime = os.path.getmtime(p2)
    assert _run(PHASE2 + ["--step_ckpt", step0, "--ckpt", p2, "--test",
                          "--val_flip", "--name", "exp_p2"], root,
                tmp_path) == 0
    assert os.path.getmtime(p2) == mtime          # nothing trained or saved
    again = _results(tmp_path, "exp_p2")
    assert len(again) == 2 and again[1] == again[0]


def test_cli_refuses_what_is_not_ported(tmp_path, root):
    """Everything the JAX CLI runs is ported; what the CLI still refuses is
    what upstream cannot run either: a peak source other than the
    PeakGenerator (upstream train.py:88)."""
    with pytest.raises(NotImplementedError, match="peakgenerator"):
        _run(PHASE1 + ["--peak_from", "cam"], root, tmp_path)


def test_sample_num_writes_the_sample_images(tmp_path):
    """--sample_num 2 on the mini-VOC of tests/test_torch_cli_data.py,
    validated at 40^2 (the masks stay 48^2): step 0's validation writes
    two PNGs under images/, each the denormalised validation image beside
    its instances, equal to sample_image of the eval forward's own output
    at the image's size; the coloured pixels are those of ins_map >= 0."""
    _write_fake_voc(str(tmp_path), n_images=16, size=48)
    seen, vals = [], []
    make_forward, build_data = cli.make_instance_forward, cli.build_data

    def recording_forward(trainer):
        fwd = make_forward(trainer)

        def run(image, size):
            out = fwd(image, size)
            seen.append(out["ins_map"].numpy())
            return out
        return run

    def recording_data(cfg):
        loader, val = build_data(cfg)
        vals.append(val)
        return loader, val

    mp = pytest.MonkeyPatch()
    mp.setattr(cli, "make_instance_forward", recording_forward)
    mp.setattr(cli, "build_data", recording_data)
    try:
        assert voc_run(str(tmp_path), VOC_STEP0 + [
            "--name", "s", "--sample_num", "2", "--crop_size_val", "40"]) == 0
    finally:
        mp.undo()
        shutil.rmtree(tmp_path / "ck", ignore_errors=True)
    images = tmp_path / "logs" / "voc-15-5-ov" / "s" / "images"
    assert sorted(os.listdir(images)) == ["test_sample_0.png",
                                          "test_sample_1.png"]
    assert len(seen) == 2 + len(vals[0])    # the samples, then validation
    for i in range(2):
        png = np.asarray(Image.open(images / f"test_sample_{i}.png"))
        sample = vals[0][i]
        want = sample_image(sample["image"][0], seen[i])
        np.testing.assert_array_equal(png, want)
        h, w = seen[i].shape
        assert png.shape == (h, 2 * w, 3) and sample["image"].shape[1:3] == (
            h, w) != sample["gt_masks"].shape[1:]
        np.testing.assert_array_equal(png[:, w:].max(-1) > 0, seen[i] >= 0)
