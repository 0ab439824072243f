"""The VOC 10-5 recipe (scripts/run_10-5.sh) through the port's CLI on the
CPU at a tiny size (a ResNet-18 of one block a stage, whose checkpoints
are small) on --synthetic data: step 0, then phase 1 -> phase 2
for incremental steps 1 and 2 under one --name, each phase 2 reading and
then overwriting its phase-1 checkpoint, with the checkpoint identities
the chain must keep."""

import functools
import os
import shutil

import pytest
import torch

from cl4wsis_tpu_torch.cl.ckpt import load_checkpoint
from cl4wsis_tpu_torch.cli import main as cli
from cl4wsis_tpu_torch.train import schedule
from torch_one_thread import one_torch_thread  # noqa: F401

COMMON = ["--synthetic", "true", "--tiny", "true", "--dataset", "voc",
          "--task", "10-5", "--batch_size", "2", "--crop_size", "64",
          "--dtype", "float32", "--kernel", "15", "--val_kernel", "15",
          "--epochs", "1", "--device", "cpu", "--name", "m",
          "--backbone", "resnet18"]
STEP0 = ["--step", "0", "--bce", "true", "--optim", "adam", "--lr", "5e-5"]
PHASE1 = ["--weakly", "true", "--phase", "1", "--alpha", "0.5", "--lr",
          "1e-3", "--loss_de", "1", "--lr_policy", "warmup", "--affinity",
          "true", "--optim", "sgd", "--pseudo_ep", "0"]
PHASE2 = ["--weakly", "true", "--phase", "2", "--alpha", "0.5", "--lr",
          "5e-5", "--loss_de", "1", "--lr_policy", "warmup", "--affinity",
          "true", "--optim", "adam", "--weight_decay", "0"]


@pytest.fixture
def root(tmp_path, monkeypatch):
    """The checkpoint root; the chain's five runs take 2 synthetic batches
    each (torch on one thread: tests/torch_one_thread.py)."""
    path = tmp_path / "checkpoints"
    monkeypatch.setattr(cli, "SyntheticLoader",
                        functools.partial(cli.SyntheticLoader, n_batches=2))
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _frozen(state):
    return {k: v for k, v in state.items()
            if schedule.default_group_fn(k) in ("body", "seg")}


def test_10_5_chain_through_step_2(tmp_path, root):
    """Every run writes its checkpoint. At step 2 the model has three
    classifier and center groups and the old model two; the old model
    equals step 1's phase-2 checkpoint m_1; phase 2 reads phase 1's m_2
    and leaves its body and semantic branch as phase 1 wrote them, bit for
    bit, in the m_2 it writes over it, whose instance branch trained on
    from m_1's."""
    made = []
    path = os.path.join(root, "step", "voc-10-5-ov")

    def run(argv):
        assert cli.main(COMMON + ["--checkpoint", str(root), "--logdir",
                                  str(tmp_path / "logs")] + argv,
                        on_trainer=made.append) == 0

    run(STEP0)
    written = {}
    for step in (1, 2):
        run(["--step", str(step)] + PHASE1)
        written[f"p1_{step}"] = load_checkpoint(
            os.path.join(path, f"m_{step}"))["model"]
        run(["--step", str(step)] + PHASE2 + [
            "--seg_ckpt", os.path.join(path, f"m_{step}")])
    assert [t.cfg.step for t in made] == [0, 1, 1, 2, 2]
    assert [t.classes for t in made[3:]] == [[11, 5, 5]] * 2

    last = made[-1]
    assert {"cls.2.weight", "instance_head.classifier.center.cls.2.weight",
            "instance_head.classifier.center.cls.1.weight"} <= set(
                last.model.state_dict())
    assert last.model_old.classes == (11, 5)
    m1 = load_checkpoint(os.path.join(path, "m_1"))["model"]
    old = last.model_old.state_dict()
    assert set(old) == set(m1)
    for k, v in old.items():
        assert torch.equal(v, m1[k]), k
    for t in (made[2], last):   # each phase 2 started from its phase 1
        p1 = written[f"p1_{t.cfg.step}"]
        sd = t.model.state_dict()
        assert len(_frozen(p1)) > 50
        for k, v in _frozen(p1).items():
            assert torch.equal(sd[k], v), k
    m2 = load_checkpoint(os.path.join(path, "m_2"))
    assert set(m2) >= {"model", "pseudolabeler", "peakgenerator"}
    for k, v in _frozen(written["p1_2"]).items():
        assert torch.equal(m2["model"][k], v), k
    moved = [k for k in m1 if schedule.default_group_fn(k) == "instance"
             and not torch.equal(m2["model"][k], m1[k])]
    assert len(moved) > 10          # the instance branch trained on
