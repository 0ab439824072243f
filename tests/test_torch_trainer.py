"""The port's CL protocol, configuration, checkpoints and trainer
(cl4wsis_tpu_torch: cl/tasks, cli/config, cl/ckpt, train/trainer) against
the JAX package on the CPU, and the trainer's own contracts: epoch and
interval means, the per-phase learning-rate groups, loads that keep the
optimizer's parameters, and what a phase-2 epoch may move. Checkpoint
arithmetic is held exactly."""

import argparse
import dataclasses
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cl4wsis_tpu.cl import ckpt as jckpt
from cl4wsis_tpu.cl import tasks as jtasks
from cl4wsis_tpu.cli import config as jconfig
from cl4wsis_tpu.models import make_model as jax_make_model
from cl4wsis_tpu_torch.cl import ckpt, tasks
from cl4wsis_tpu_torch.cli import config
from cl4wsis_tpu_torch.cli import main as cli_main
from cl4wsis_tpu_torch.cli.main import SyntheticLoader
from cl4wsis_tpu_torch.core import dist
from cl4wsis_tpu_torch.train import schedule
from cl4wsis_tpu_torch.train import trainer as trainer_mod
from cl4wsis_tpu_torch.models import assembly
from cl4wsis_tpu_torch.models.wide_resnet import WiderResNet38A2
from cl4wsis_tpu_torch.train.trainer import Trainer, pretrained_name
from torch_one_thread import one_torch_thread  # noqa: F401

WRN16 = (1, 1, 1, 1, 1, 1)
TINY = (1, 1, 1, 1)
COMMON = ["--synthetic", "true", "--tiny", "true", "--dataset", "voc",
          "--task", "15-5", "--batch_size", "2", "--crop_size", "64",
          "--dtype", "float32", "--kernel", "15", "--val_kernel", "15",
          "--epochs", "1", "--device", "cpu"]


# ------------------------------------------------------ tasks, config

def test_task_tables_match_jax():
    assert tasks.get_task_list() == jtasks.get_task_list()
    n = 0
    for ds, names in jtasks.TASKS.items():
        for name, steps in names.items():
            for step in steps:
                assert tasks.get_per_task_classes(ds, name, step) == \
                    jtasks.get_per_task_classes(ds, name, step)
                assert tasks.get_task_labels(ds, name, step) == \
                    jtasks.get_task_labels(ds, name, step)
                assert tasks.get_task_dict(ds, name, step) == \
                    jtasks.get_task_dict(ds, name, step)
                n += 1
    assert n > 20
    with pytest.raises(ValueError):
        tasks.get_task_dict("voc", "15-5", 2)
    with pytest.raises(NotImplementedError):
        tasks.get_per_task_classes("voc", "14-6", 0)


CHAIN = ["--synthetic", "true", "--tiny", "true", "--dataset", "voc",
         "--task", "15-5", "--batch_size", "8", "--crop_size", "64",
         "--checkpoint", "ck", "--dtype", "float32", "--kernel", "15",
         "--val_kernel", "15", "--epochs", "1"]


@pytest.mark.parametrize("argv", [
    CHAIN + ["--step", "0", "--name", "exp", "--bce", "true", "--optim",
             "adam", "--lr", "5e-5"],
    CHAIN + ["--step", "1", "--name", "exp_p1", "--weakly", "true", "--phase",
             "1", "--optim", "sgd", "--lr", "1e-3", "--lr_policy", "warmup",
             "--loss_de", "1", "--affinity", "true", "--pseudo_ep", "0",
             "--step_ckpt", "ck/step/voc-15-5-ov/exp_0"],
    CHAIN + ["--step", "1", "--name", "exp_p2", "--weakly", "true", "--phase",
             "2", "--optim", "adam", "--lr", "5e-5", "--step_ckpt", "s0",
             "--seg_ckpt", "p1"],
    ["--dataset", "coco-voc", "--task", "voc", "--step", "1", "--weakly",
     "--phase", "2", "--overlap", "false"],
    ["--no_pretrained", "--local_rank", "0"],
    ["--random_seed", "3", "--model", "DeeplabV3", "--device", "cpu"],
], ids=["step0", "phase1", "phase2", "coco-voc", "no_pretrained", "seed"])
@pytest.mark.parametrize("iters", [0, 4])
def test_finalized_config_matches_jax(argv, iters):
    """Every field and derivation of the finalized config equals JAX's,
    except ``device``, which the port keeps and JAX ignores."""
    got = dataclasses.asdict(config.parse_config(argv).finalize(iters))
    want = dataclasses.asdict(jconfig.parse_config(argv).finalize(iters))
    assert got.pop("device") == ("cpu" if "--device" in argv else "cuda")
    assert got == want


def test_flag_set_matches_jax():
    def flags(parser):
        return {o for a in parser._actions for o in a.option_strings}
    assert flags(config.get_argparser()) == flags(jconfig.get_argparser())


# -------------------------------------------------------- checkpoints

def _jax_tiny_vars(classes, seed, branch="ins"):
    jm = jax_make_model(classes, "resnet101", 16, 64, branch=branch,
                        backbone_structure=TINY)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def step_vars():
    """JAX variables of the tiny step-0 model (16,), the step-1 model
    (16, 5) and the step-1 model without instance branch, randomised
    classifier biases so imprinting has something to copy."""
    old = _jax_tiny_vars((16,), 0)
    rs = np.random.RandomState(0)
    for tree, key in ((old["params"]["cls"], "cls_0"),
                      (old["params"]["instance_head"], "center_cls_0")):
        tree[key]["bias"] = rs.randn(*tree[key]["bias"].shape).astype(
            np.float32)
    return {"old": old, "new": _jax_tiny_vars((16, 5), 1),
            "none": _jax_tiny_vars((16, 5), 2, branch="none")}


@pytest.mark.parametrize("init_balanced", [False, True])
def test_expand_for_new_step_matches_jax(step_vars, init_balanced):
    """The port's expansion of converted state dicts equals JAX's expansion
    converted, tensor for tensor, bit for bit."""
    want = ckpt.convert_jax_variables(jax.tree_util.tree_map(
        np.asarray, jckpt.expand_for_new_step(
            step_vars["new"], step_vars["old"], [16, 5],
            init_balanced=init_balanced)))
    got = ckpt.expand_for_new_step(
        ckpt.convert_jax_variables(step_vars["new"]),
        ckpt.convert_jax_variables(step_vars["old"]), [16, 5],
        init_balanced=init_balanced)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    new_cls = got["cls.1.weight"]
    old_row = ckpt.convert_jax_variables(step_vars["old"])["cls.0.weight"][:1]
    assert torch.equal(new_cls, old_row.repeat(5, 1, 1, 1)) == init_balanced


def test_tree_merge_matches_jax_on_missing_and_extra_keys(step_vars):
    """A step-0 state dict (instance branch) into a branch-'none' model:
    keys only in the update are ignored, keys only in the base kept; the
    same on nested dicts; equal to JAX's merge."""
    base = ckpt.convert_jax_variables(step_vars["none"])
    upd = ckpt.convert_jax_variables(step_vars["old"])
    got = ckpt.tree_merge(base, upd)
    assert got.keys() == base.keys()
    assert torch.equal(got["body.mod1.conv1.weight"],
                       upd["body.mod1.conv1.weight"])
    assert torch.equal(got["cls.1.weight"], base["cls.1.weight"])
    want = ckpt.convert_jax_variables(jax.tree_util.tree_map(
        np.asarray, {c: jckpt.tree_merge(step_vars["none"][c],
                                         step_vars["old"][c])
                     for c in ("params", "batch_stats")}))
    assert all(torch.equal(got[k], want[k]) for k in want)
    nested = ({"a": {"x": 1, "y": 2}, "b": 3}, {"a": {"x": 9, "z": 7}, "c": 5})
    assert ckpt.tree_merge(*nested) == jckpt.tree_merge(*nested) == \
        {"a": {"x": 9, "y": 2}, "b": 3}


@pytest.mark.parametrize("dataset,overlap", [("voc", True), ("voc", False),
                                             ("coco-voc", True)])
def test_ckpt_path_matches_jax(dataset, overlap):
    args = ("checkpoints", dataset, "15-5", overlap, "exp", 1)
    assert ckpt.ckpt_path(*args) == jckpt.ckpt_path(*args)


def test_save_load_round_trip(tmp_path):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    opt = torch.optim.Adam(net.parameters())
    net(torch.randn(2, 3, 8, 8)).sum().backward()
    opt.step()
    tree = {"model": net.state_dict(), "optimizer": opt.state_dict(),
            "step": 7, "epoch": 2}
    path = str(tmp_path / "step" / "x_0")
    ckpt.save_checkpoint(path, tree)
    assert os.listdir(tmp_path / "step") == ["x_0"]
    back = ckpt.load_checkpoint(path)
    assert back["step"] == 7 and back["epoch"] == 2
    for k, v in tree["model"].items():
        assert torch.equal(back["model"][k], v)
    for i, s in tree["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(back["optimizer"]["state"][i][k], v)
    assert back["optimizer"]["param_groups"] == \
        tree["optimizer"]["param_groups"]


def _fake_iabn_state_dict(rs):
    """A torch iABN ResNet state dict as upstream's pretrained pickles hold
    it: 'module.' keys, negative BN weights, a classifier and a BN counter."""
    sd = {}

    def bn(prefix, c):
        sd[prefix + ".weight"] = torch.from_numpy(rs.randn(c).astype(np.float32))
        sd[prefix + ".bias"] = torch.from_numpy(rs.randn(c).astype(np.float32))
        sd[prefix + ".running_mean"] = torch.from_numpy(
            rs.randn(c).astype(np.float32))
        sd[prefix + ".running_var"] = torch.from_numpy(
            rs.rand(c).astype(np.float32) + 0.5)
        sd[prefix + ".num_batches_tracked"] = torch.tensor(5)

    def conv(key, *shape):
        sd[key] = torch.from_numpy(rs.randn(*shape).astype(np.float32))

    conv("module.mod1.conv1.weight", 64, 3, 7, 7)
    bn("module.mod1.bn1", 64)
    conv("module.mod2.block1.convs.conv1.weight", 64, 64, 1, 1)
    bn("module.mod2.block1.convs.bn1", 64)
    conv("module.mod2.block1.convs.conv2.weight", 64, 64, 3, 3)
    bn("module.mod2.block1.convs.bn2", 64)
    conv("module.mod2.block1.proj_conv.weight", 256, 64, 1, 1)
    bn("module.mod2.block1.proj_bn", 256)
    conv("module.classifier.fc.weight", 1000, 2048)
    return sd


def test_iabn_ingest_matches_jax(tmp_path):
    """convert_torch_resnet onto body.* equals JAX's convert_torch_resnet
    carried over by convert_jax_variables; |BN weight| taken; the pickle
    loads through load_torch_pretrained, a missing file gives None."""
    sd = _fake_iabn_state_dict(np.random.RandomState(3))
    got = ckpt.convert_torch_resnet(sd)
    j = jckpt.convert_torch_resnet({k: v.numpy() for k, v in sd.items()})
    want = ckpt.convert_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": {"body": j["params"]},
                     "batch_stats": {"body": j["batch_stats"]}}))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (got["body.mod1.bn1.weight"] >= 0).all()
    assert (sd["module.mod1.bn1.weight"] < 0).any()
    path = tmp_path / "resnet101_iabn_sync.pth.tar"
    torch.save({"state_dict": sd}, path)
    loaded = ckpt.load_torch_pretrained(str(path))
    assert all(torch.equal(loaded[k], got[k]) for k in got)
    assert ckpt.load_torch_pretrained(str(tmp_path / "absent")) is None
    # the model takes it: every ingested key is a body tensor of its shape
    model = trainer_mod.make_model((16,), backbone_structure=TINY)
    body = model.state_dict()
    assert all(body[k].shape == v.shape for k, v in got.items())


# what upstream's training scripts save beside the weights
PRETRAINED_EXTRAS = {
    "plain": {},
    "np_float64": {"epoch": 90, "best_prec1": np.float64(77.37)},
    "namespace": {"args": argparse.Namespace(arch="resnet101", lr=0.1)},
}


@pytest.mark.parametrize("extra", PRETRAINED_EXTRAS.values(),
                         ids=PRETRAINED_EXTRAS.keys())
def test_pretrained_file_with_extras_loads_as_in_jax(tmp_path, extra):
    """The port's load_torch_pretrained reads every file JAX's reads (a
    full pickle, not weights_only): with a numpy float64 or an
    argparse.Namespace beside the state dict too, key for key and value
    for value JAX's tree carried over by convert_jax_variables, and the
    trainer's body starts from it."""
    sd = _fake_iabn_state_dict(np.random.RandomState(4))
    pre = tmp_path / "pretrained"
    pre.mkdir()
    path = pre / "resnet101_iabn_sync.pth.tar"
    torch.save({"state_dict": sd, **extra}, path)
    got = ckpt.load_torch_pretrained(str(path))
    j = jckpt.load_torch_pretrained(str(path))
    want = ckpt.convert_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": {"body": j["params"]},
                     "batch_stats": {"body": j["batch_stats"]}}))
    assert got.keys() == want.keys() and len(got) == 20
    for k in want:
        assert torch.equal(got[k], want[k]), k
    cfg = config.parse_config([
        "--dataset", "voc", "--task", "15-5", "--step", "0", "--pretrained",
        "true", "--pretrained_path", str(pre), "--tiny", "true",
        "--crop_size", "48", "--device", "cpu", "--dtype", "float32"])
    body = Trainer(cfg, iters_per_epoch=1).model.state_dict()
    assert all(torch.equal(body[k], v) for k, v in got.items())


def _upstream_wide_state_dict(rs):
    """A WideResNet upstream-key state dict (as the iABN ImageNet pickle
    has it: 'module.' prefix, classifier.fc, BN weights of either sign)
    of the one-block-a-module body."""
    sd = {}
    for k, v in WiderResNet38A2(WRN16).state_dict().items():
        if k.endswith("running_var"):
            val = rs.uniform(0.5, 1.5, v.shape)
        else:
            val = rs.randn(*v.shape) * (0.1 if v.dim() == 4 else 1.0)
        sd["module." + k] = torch.from_numpy(val.astype(np.float32))
    sd["module.classifier.fc.weight"] = torch.zeros(10, 4096)
    return sd


def test_trainer_ingests_the_wide_resnet_pretrained_file(tmp_path,
                                                         monkeypatch):
    """The trainer of a wide backbone looks for
    wide_resnet38_ipabn_lr_256.pth.tar (the JAX trainer's name; a ResNet's
    file stays {backbone}_iabn_sync.pth.tar), converts the upstream keys
    (block bn1 and bn_out are norms) as the JAX converter does, with
    |weight|, and loads them into the body."""
    monkeypatch.setitem(assembly._WIDE_STRUCTURES, "wider_resnet38_a2",
                        WRN16)
    assert pretrained_name("wider_resnet38_a2") == \
        "wide_resnet38_ipabn_lr_256.pth.tar"
    assert pretrained_name("resnet101") == "resnet101_iabn_sync.pth.tar"
    sd = _upstream_wide_state_dict(np.random.RandomState(0))
    got = ckpt.convert_torch_resnet(sd)
    j = jckpt.convert_torch_resnet({k: v.numpy() for k, v in sd.items()})
    want = ckpt.convert_jax_variables({
        "params": {"body": j["params"]},
        "batch_stats": {"body": j["batch_stats"]}})
    assert got.keys() == want.keys()
    assert "body.mod7.block1.bn1.weight" in got and "body.bn_out.bias" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
    pre = tmp_path / "pretrained"
    pre.mkdir()
    torch.save({"state_dict": sd}, pre / "wide_resnet38_ipabn_lr_256.pth.tar")
    cfg = config.parse_config([
        "--dataset", "coco-voc", "--task", "voc", "--step", "0",
        "--pretrained", "true", "--pretrained_path", str(pre), "--tiny",
        "true", "--crop_size", "48", "--device", "cpu", "--dtype",
        "float32"])
    body = Trainer(cfg, iters_per_epoch=1).model.state_dict()
    assert all(torch.equal(body[k], v) for k, v in got.items())
    assert (body["body.bn_out.weight"] >= 0).all()
    assert (sd["module.bn_out.weight"] < 0).any()
    os.remove(pre / "wide_resnet38_ipabn_lr_256.pth.tar")
    fresh = Trainer(cfg, iters_per_epoch=1).model.state_dict()
    assert not torch.equal(fresh["body.bn_out.bias"], body["body.bn_out.bias"])


# ------------------------------------------------------- epoch means

class _FakeLogger:
    def __init__(self):
        self.scalars = []
        self.commits = 0

    def add_scalar(self, tag, value, step=None, intermediate=False):
        self.scalars.append((tag, float(value), step, intermediate))

    def commit(self, intermediate=False):
        self.commits += 1

    def debug(self, msg):
        pass


def _fake_trainer(print_interval=2, n_batches=5):
    """A Trainer shell that runs only train_epoch's aggregation, with a
    fake step that records the generator's seed."""
    t = object.__new__(Trainer)
    t.cfg = config.Config(print_interval=print_interval, epochs=1,
                          debug=False, profile_dir=None, device="cpu"
                          ).finalize(n_batches)
    t.supervised_pseudo = False
    t.state = None
    t.device = torch.device("cpu")
    losses = [1.0, 3.0, 5.0, 7.0, 9.0][:n_batches]
    seeds = []

    def fake_step(state, batch, generator):
        seeds.append(generator.initial_seed())
        return {"loss": torch.tensor(batch["loss"]),
                "l_seg": torch.tensor(2.0 * batch["loss"])}

    t._get_step = lambda epoch: fake_step
    t._device_batch = lambda b: b
    return t, [{"loss": v} for v in losses], losses, seeds


def test_epoch_metrics_are_means():
    t, batches, losses, seeds = _fake_trainer()
    m = t.train_epoch(3, batches)
    assert np.isclose(m["loss"], np.mean(losses))
    assert np.isclose(m["l_seg"], 2.0 * np.mean(losses))
    assert m["n_batches"] == len(losses) and m["epoch_time_s"] >= 0
    assert seeds == [t.cfg.seed + 3] * len(losses)


def test_interval_logging_means():
    t, batches, losses, _ = _fake_trainer(print_interval=2)
    log = _FakeLogger()
    t.train_epoch(0, batches, logger=log)
    tot = [(v, step) for tag, v, step, inter in log.scalars
           if tag == "Loss/tot" and inter]
    # 5 batches, interval 2 -> prints after batches 2 and 4
    assert len(tot) == 2
    assert np.isclose(tot[0][0], np.mean(losses[0:2]))
    assert np.isclose(tot[1][0], np.mean(losses[2:4]))
    assert tot[0][1] == 2 and tot[1][1] == 4
    assert {tag for tag, *_ in log.scalars} == {"Loss/tot", "Loss/SEG_out"}
    assert log.commits == 2
    m = t.train_epoch(1, batches, logger=log)
    assert np.isclose(m["loss"], np.mean(losses))


def test_loader_wait_is_the_hosts_wait_for_batches():
    """A loader that takes 50 ms a batch: the epoch's loader_wait_s holds
    every wait and lies inside the epoch's time; under a profiler each
    wait is a ``trainer.next_batch`` span, one more than the batches (the
    wait that finds the loader done)."""
    t, batches, losses, _ = _fake_trainer(n_batches=3)

    def slow():
        for b in batches:
            time.sleep(0.05)
            yield b
    m = t.train_epoch(0, slow())
    assert m["n_batches"] == 3
    assert 3 * 0.05 <= m["loader_wait_s"] <= m["epoch_time_s"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.train_epoch(0, slow())
    assert [e.name for e in prof.events()].count("trainer.next_batch") == 4


def test_empty_epoch_raises():
    t, _, _, _ = _fake_trainer()
    with pytest.raises(ValueError, match="no batches"):
        t.train_epoch(0, [])


# ------------------------------------------------- groups and steps

def _trainer(extra, iters=2):
    return Trainer(config.parse_config(COMMON + extra), iters_per_epoch=iters)


def _groups(t):
    return {g["name"]: g["scale"] for g in t.state.optimizer.param_groups}


def test_group_scales_per_phase():
    """Step 0: every group at 1 (lr_head is 1 at step 0). Phase 1: body 1,
    seg lr_head, the PseudoLabeler and PeakGenerator lr_pseudo / lr.
    Phase 2: only the instance branch, at lr_head; body and seg frozen."""
    t0 = _trainer(["--step", "0", "--lr", "0.01"])
    assert _groups(t0) == {"body": 1.0, "seg": 1.0, "instance": 1.0}
    t1 = _trainer(["--step", "1", "--weakly", "--phase", "1", "--lr", "0.001",
                   "--lr_pseudo", "0.01"])
    assert _groups(t1) == {"body": 1.0, "seg": 10.0, "pseudo": 10.0}
    assert isinstance(t1.state.model, torch.nn.ModuleDict)
    assert t1.state.model["pseudolabeler"] is t1.pseudolabeler
    t2 = _trainer(["--step", "1", "--weakly", "--phase", "2"])
    assert _groups(t2) == {"instance": 10.0}
    assert t2.model.detach_instance and t2.cfg.freeze and t2.cfg.freeze_seg
    for name, p in t2.model.named_parameters():
        assert p.requires_grad == (schedule.default_group_fn(name) ==
                                   "instance"), name


def test_step_choice(monkeypatch):
    """supervised_pseudo (--weakly --pseudo at step 1) runs the step-0 step
    with BCE; --dce alone picks the hard-pixel CE; phase 1 keys its program
    by pseudo_ep; an unknown peak_from raises."""
    made = []
    monkeypatch.setattr(trainer_mod, "make_step0_train_step",
                        lambda model, **kw: made.append(("p0", kw)) or "p0")
    monkeypatch.setattr(trainer_mod, "make_phase1_train_step",
                        lambda *a, **kw: made.append(("p1", kw)) or "p1")
    t = _trainer(["--step", "1", "--weakly", "--pseudo", "given"])
    assert t.supervised_pseudo and t.pseudolabeler is None
    assert t._get_step(0) == "p0" and made[-1][1]["seg_loss"] == "bce"
    t = _trainer(["--step", "0", "--dce"])
    assert t._get_step(0) == "p0" and made[-1][1]["seg_loss"] == "dce"
    t = _trainer(["--step", "1", "--weakly", "--phase", "1",
                  "--pseudo_ep", "1"])
    assert t._get_step(0) == "p1" and not made[-1][1]["use_pseudo"]
    assert t._get_step(1) == "p1" and made[-1][1]["use_pseudo"]
    assert len(made) == 4 and t._get_step(2) == "p1" and len(made) == 4
    with pytest.raises(NotImplementedError, match="peak_from"):
        _trainer(["--step", "1", "--weakly", "--phase", "2",
                  "--peak_from", "cam"])
    t = _trainer(["--remat"])         # --remat reaches the body
    assert t.model.body.remat
    # multi-GPU runs start under torchrun: the switch alone is refused
    monkeypatch.setenv("CL4WSIS_MULTIHOST", "1")
    for k in dist.TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        cli_main.main(["--synthetic", "--tiny", "--device", "cpu"])


# ------------------------------------------- loads and a phase-2 epoch

@pytest.fixture(scope="module")
def step0_ckpt(tmp_path_factory):
    """A step-0 checkpoint of the tiny model after one epoch."""
    root = tmp_path_factory.mktemp("ck")
    t = _trainer(["--step", "0", "--bce", "--optim", "adam", "--lr", "5e-5",
                  "--checkpoint", str(root)])
    t.train_epoch(0, SyntheticLoader(t.cfg, 2).epoch(0))
    path = t.default_ckpt_path()
    t.save(path, 0)
    yield path
    shutil.rmtree(root, ignore_errors=True)


def test_load_step_ckpt_keeps_the_optimizers_parameters(step0_ckpt):
    """load_step_ckpt after the optimizer is built copies into the model's
    own parameters (the optimizer's), and gives the old model tensors of
    its own, equal to step 0's."""
    t = _trainer(["--step", "1", "--weakly", "--phase", "2"])
    opt_params = [p for g in t.state.optimizer.param_groups
                  for p in g["params"]]
    t.load_step_ckpt(step0_ckpt)
    saved = ckpt.load_checkpoint(step0_ckpt)["model"]
    model = dict(t.model.named_parameters())
    trained = [p for n, p in model.items()
               if schedule.default_group_fn(n) == "instance"]
    assert [id(p) for p in opt_params] == [id(p) for p in trained]
    sd, old = t.model_variables(), t.model_old.state_dict()
    assert t.pseudolabeler_variables().keys() == \
        t.pseudolabeler.state_dict().keys()
    assert old.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(old[k], v), k
        if k in sd and not k.startswith(("cls.1", "instance_head."
                                         "classifier.center.cls.1")):
            assert torch.equal(sd[k], v), k
            assert sd[k].data_ptr() != old[k].data_ptr(), k


@pytest.mark.parametrize("run_refine", ["true", "false"])
def test_phase2_epoch_moves_only_the_instance_branch(step0_ckpt, run_refine):
    """After a phase-2 epoch (from step 0's weights), with and without the
    self-refinement: body and seg, their BN statistics included,
    bit-unchanged; every instance parameter tensor with a gradient moved;
    the old model bit-unchanged. The new rows start in torch's families
    (--torch_init true): their biases are not 0, so that weight decay
    moves them where two synthetic batches give the new classes no
    pseudo-label, and so no gradient (from flax's zero biases nothing
    would)."""
    t = _trainer(["--step", "1", "--weakly", "--phase", "2", "--optim",
                  "adam", "--lr", "5e-5", "--run_refine", run_refine,
                  "--torch_init", "true"])
    t.load_step_ckpt(step0_ckpt)
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    old_before = {k: v.clone() for k, v in t.model_old.state_dict().items()}
    m = t.train_epoch(0, SyntheticLoader(t.cfg, 2).epoch(0))
    assert m["n_batches"] == 2 and np.isfinite(m["loss"])
    after = t.model.state_dict()
    for k, v in before.items():
        group = schedule.default_group_fn(k)
        if group in ("body", "seg"):
            assert torch.equal(after[k], v), k
    moved = [k for k, p in t.model.named_parameters()
             if p.requires_grad and not torch.equal(before[k], p)]
    trained = [k for k, p in t.model.named_parameters() if p.requires_grad]
    assert moved == trained and len(trained) > 20
    for k, v in t.model_old.state_dict().items():
        assert torch.equal(old_before[k], v), k


@pytest.mark.parametrize("detach", [False, True])
def test_detach_instance_keeps_the_instance_loss_off_the_backbone(detach):
    """With detach_instance, a loss on the instance outputs reaches the
    decoder but no backbone weight; without it, both."""
    torch.manual_seed(0)
    model = trainer_mod.make_model((3, 2), crop_size=64, detach_instance=detach,
                                   backbone_structure=TINY)
    out = model(torch.randn(2, 3, 64, 64), interpolate=False)
    (out["center"].square().mean() + out["offset"].abs().mean()).backward()
    assert model.decoder.instance_decoder.aspp.project[0].weight.grad.abs().sum() > 0
    body_grad = model.body.mod1.conv1.weight.grad
    assert (body_grad is None) == detach
    assert model.cls[0].weight.grad is None


def test_label_factory_without_refinement_gives_the_pseudo_targets():
    """run_refine=False: the same pseudo targets and slots as with the
    refinement, and no refined targets."""
    from cl4wsis_tpu_torch.train.phase2 import label_factory
    rs = np.random.RandomState(5)
    B, C, H, W = 2, 4, 32, 32
    seg = torch.zeros(B, H, W, dtype=torch.int32)
    ys = torch.zeros(B, C, 3, dtype=torch.int32)
    xs = torch.zeros(B, C, 3, dtype=torch.int32)
    valid = torch.zeros(B, C, 3, dtype=torch.bool)
    for c in range(1, C):           # one box with one peak per new class
        y0, x0 = 8 * c - 6, 4 + 6 * c
        seg[:, y0:y0 + 6, x0:x0 + 5] = c + 1
        ys[:, c, 0], xs[:, c, 0], valid[:, c, 0] = y0 + 3, x0 + 2, True
    label = torch.ones(B, C)
    soft = torch.softmax(torch.from_numpy(rs.randn(B, C + 1, H, W)
                                          .astype(np.float32)), 1)
    center = torch.from_numpy(rs.rand(B, C, H, W).astype(np.float32))
    offset = torch.from_numpy(rs.randn(B, 2, H, W).astype(np.float32))
    kw = dict(num_classes=C, first_class=1, nms_kernel=7)
    full = label_factory(seg, label, ys, xs, valid, soft, center, offset, **kw)
    bare = label_factory(seg, label, ys, xs, valid, soft, center, offset,
                         run_refine=False, **kw)
    assert "refined" in full and "refined" not in bare
    for k in ("pc", "po", "pw", "p_trunc", "n_match"):
        assert torch.equal(full[k], bare[k]), k
    assert all(torch.equal(a, b) for a, b in zip(full["p_slots"],
                                                  bare["p_slots"]))
    assert int(full["n_match"].sum()) > 0
