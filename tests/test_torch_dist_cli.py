"""The port's CLI chain at 2 gloo ranks under torchrun on the CPU, the
counterpart of tests/test_multihost_cli.py:

    CL4WSIS_MULTIHOST=1 python -m torch.distributed.run --nproc_per_node 2 \\
        tests/test_torch_dist_cli.py <root> <val.pt> <voc root> <out>

Each rank joins the gloo group torchrun describes (``dist.init_from_env``)
and runs ``cli.main`` for step 0, step 0 again with --epochs 2
--continue_ckpt, phase 1 and phase 2 on --synthetic --tiny data at
--batch_size 2 (every rank the same batches, as the JAX CLI gives them;
2 a run),
with a small validation set patched in, then --test of the phase-2
checkpoint; main keeps the caller's group (a second group made in one
process under torchrun's store can meet the first one's keys there). It
also builds the real VOC loader of a fake VOC root, to read its rank
shard. The worker imports no JAX.

The one-process reference runs the same chain in this process at
--batch_size 4 on the ranks' global batch: the synthetic batch of 2
stacked twice. Its epoch losses are held to the ranks' within 1e-5
relative (float32 sums in another order), the merged validation of the
same checkpoint under --test exactly. Every run trains at --lr 0: the
tiny random model's training is chaotic (one process's own loss at its
4th step moves by 3% with its thread count), so the chain is held with
the weights fixed, and what it carries from step to step and from run to
run is the global batch statistics, the running stats, the optimizer
state and the checkpoints. The summed gradients are held at a nonzero
learning rate, one step from given weights, in test_torch_dist_steps.py
and test_torch_dist_jax_step.py.
"""

import copy
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from cl4wsis_tpu_torch.cli import main as cli
from cl4wsis_tpu_torch.cli.config import parse_config
from cl4wsis_tpu_torch.core import dist
from torch_one_thread import one_torch_thread  # noqa: F401

COMMON = ["--synthetic", "true", "--tiny", "true", "--dataset", "voc",
          "--task", "15-5", "--crop_size", "64", "--dtype", "float32",
          "--kernel", "15", "--val_kernel", "15", "--epochs", "1",
          "--device", "cpu", "--visualize", "false"]
STEP0 = ["--step", "0", "--name", "exp", "--bce", "true", "--optim", "sgd",
         "--lr", "0"]
PHASE1 = ["--step", "1", "--name", "exp_p1", "--weakly", "true", "--phase",
          "1", "--optim", "sgd", "--lr", "0", "--lr_policy", "warmup",
          "--loss_de", "1", "--affinity", "true", "--pseudo_ep", "0"]
PHASE2 = ["--step", "1", "--name", "exp_p2", "--weakly", "true", "--phase",
          "2", "--optim", "sgd", "--lr", "0"]
LOSS_RTOL = 1e-5
N_BATCHES = 2      # synthetic batches an epoch


def _ck(root, name):
    return os.path.join(root, "step", "voc-15-5-ov", name)


def chain(root, batch_size, val, test_ckpt=None):
    """The chain's runs through cli.main with `val` as the validation set;
    per run the epochs trained with their metrics and the validation
    results, and the validation samples this rank took (each by the sum
    of its label map). --test evaluates `test_ckpt` (this chain's phase 2
    without)."""
    s0, p1 = _ck(root, "exp_0"), _ck(root, "exp_p1_1")
    runs = {"step 0": STEP0, "resume": STEP0 + ["--epochs", "2",
                                                "--continue_ckpt", "true"],
            "phase 1": PHASE1 + ["--step_ckpt", s0],
            "phase 2": PHASE2 + ["--step_ckpt", s0, "--seg_ckpt", p1]}
    out = {}
    real_build, real_samples = cli.build_data, cli.eval_samples
    real_val = cli.validate_instances, cli.validate_semseg
    results, shards = [], []

    def sharded(*a):
        shards.append([int(s["seg"].sum()) for s in real_samples(*a)])
        return real_samples(*a)

    def recording(fn):
        def run(*a, **kw):
            results.append(fn(*a, **kw))
            return results[-1]
        return run
    try:
        cli.build_data = lambda cfg: (cli.SyntheticLoader(cfg, N_BATCHES),
                                      val)
        cli.eval_samples = sharded
        cli.validate_instances, cli.validate_semseg = map(recording,
                                                          real_val)
        for name, argv in runs.items():
            epochs = []

            def watch(trainer):
                train_epoch = trainer.train_epoch

                def run(epoch, *a, **kw):
                    epochs.append((epoch, train_epoch(epoch, *a, **kw)))
                    return epochs[-1][1]
                trainer.train_epoch = run
            results.clear()
            shards.clear()
            assert cli.main(COMMON + ["--batch_size", str(batch_size),
                                      "--checkpoint", str(root)] + argv,
                            on_trainer=watch) == 0
            out[name] = {"epochs": epochs, "val": list(results),
                         "shards": list(shards)}
        results.clear()
        shards.clear()
        assert cli.main(COMMON + PHASE2 + [
            "--batch_size", str(batch_size), "--checkpoint", str(root),
            "--step_ckpt", s0, "--test", "--ckpt",
            test_ckpt or _ck(root, "exp_p2_1")]) == 0
        out["test"] = {"val": list(results), "shards": list(shards)}
    finally:
        cli.build_data, cli.eval_samples = real_build, real_samples
        cli.validate_instances, cli.validate_semseg = real_val
    return out


def loader_shard(voc_root):
    """This rank's indices of epoch 0 of the real VOC loader the CLI
    builds (step 1 of 15-5, batch 2), and the dataset's size."""
    cfg = parse_config(["--dataset", "voc", "--data_root", voc_root,
                        "--task", "15-5", "--step", "1", "--weakly", "true",
                        "--phase", "1", "--batch_size", "2", "--crop_size",
                        "32", "--num_workers", "0", "--device", "cpu",
                        "--pretrained", "false"])
    loader, _ = cli.build_data(cfg.finalize())
    loader.sampler.epoch = 0
    return [i for b in loader.sampler for _, i in b], len(loader.dataset)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests.test_data import _write_fake_voc
    from tests.test_torch_cli import _val_set
    from tests.test_torch_dist import WORLD, free_port, rank_env

    tmp = tmp_path_factory.mktemp("dist_cli")
    val = _val_set()
    torch.save(val, tmp / "val.pt")
    voc = tmp / "voc_root"
    _write_fake_voc(str(voc), n_images=12, size=48, rich=True)
    env = {k: v for k, v in rank_env(0, WORLD, 0).items()
           if k not in dist.TORCHRUN_VARS}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(WORLD), "--master_addr", "127.0.0.1", "--master_port",
           str(free_port()), __file__, tmp / "ranks", tmp / "val.pt", voc,
           tmp / "out"]
    p = subprocess.run(list(map(str, cmd)), env=env, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, (p.stdout + p.stderr)[-6000:]
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(WORLD)]
    real = cli.SyntheticLoader.epoch

    def doubled(self, epoch):      # the ranks' global batch in one process
        half = copy.copy(self)
        half.cfg = dataclasses.replace(self.cfg,
                                       batch_size=self.cfg.batch_size // 2)
        for b in real(half, epoch):
            yield {k: np.concatenate([v, v]) for k, v in b.items()}
    cli.SyntheticLoader.epoch = doubled
    try:
        one = chain(tmp / "one", 4, val,
                    test_ckpt=_ck(tmp / "ranks", "exp_p2_1"))
    finally:
        cli.SyntheticLoader.epoch = real
    yield {"ranks": ranks, "one": one, "stdout": p.stdout,
           "ckpts": tmp / "ranks"}
    shutil.rmtree(tmp, ignore_errors=True)


def test_both_ranks_log_the_global_loss_of_one_process(runs):
    """Every run's epoch metrics (means summed over ranks) are identical on
    both ranks and equal the one process's on the global batch."""
    r0, r1 = runs["ranks"][0]["chain"], runs["ranks"][1]["chain"]
    for name, one in runs["one"].items():
        if name == "test":
            continue
        for (e0, m0), (e1, m1) in zip(r0[name]["epochs"],
                                      r1[name]["epochs"]):
            clock = {"epoch_time_s": 0, "loader_wait_s": 0}
            assert e0 == e1 and {**m0, **clock} == {**m1, **clock}, name
        assert [e for e, _ in r0[name]["epochs"]] == \
            [e for e, _ in one["epochs"]], name
        for (_, got), (_, want) in zip(r0[name]["epochs"], one["epochs"]):
            for k, v in want.items():
                if k not in ("epoch_time_s", "loader_wait_s", "n_batches"):
                    assert got[k] == pytest.approx(v, rel=LOSS_RTOL,
                                                   abs=1e-7), (name, k)
            assert got["n_batches"] == want["n_batches"] == N_BATCHES
            assert np.isfinite(got["loss"]) and got["loss"] > 0


def test_rank0_alone_writes_and_resume_runs_on_both_ranks(runs):
    """Rank 0 writes the four checkpoints, rank 1 none; --continue_ckpt
    resumes on both ranks at epoch 1, which alone they train."""
    saves = [r["saves"] for r in runs["ranks"]]
    assert saves[1] == []
    names = [os.path.basename(p) for p in saves[0]]
    assert names == ["exp_0.tmp", "exp_0.tmp", "exp_p1_1.tmp",
                     "exp_p2_1.tmp"]
    for name in ("exp_0", "exp_p1_1", "exp_p2_1"):
        assert os.path.exists(_ck(runs["ckpts"], name))
    for r in runs["ranks"]:
        assert [e for e, _ in r["chain"]["resume"]["epochs"]] == [1]
    assert runs["stdout"].count("exp_0 at epoch 1") == 2


def test_merged_validation_equals_one_process(runs):
    """Each rank validates its strided shard (rank 0 images 0 and 2, rank 1
    image 1) and the merge is global: both ranks hold the same results
    after each run (the CAM mIoU counting all 3 images), and --test of the
    ranks' phase-2 checkpoint equals the one process's --test of it."""
    r0, r1 = runs["ranks"][0]["chain"], runs["ranks"][1]["chain"]
    everyone = runs["one"]["test"]["shards"][0]
    for name in ("step 0", "phase 1", "phase 2", "test"):
        a, b = r0[name]["val"], r1[name]["val"]
        assert len(a) == len(b) == 1, name
        _same(a[0], b[0])
        assert r0[name]["shards"] == [everyone[0::2]], name
        assert r1[name]["shards"] == [everyone[1::2]], name
    assert len(everyone) == 3
    assert r0["phase 1"]["val"][0]["Total samples"] == 3
    assert 0 <= r0["test"]["val"][0]["map"] <= 1
    _same(r0["test"]["val"][0], runs["one"]["test"]["val"][0])


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_loader_rank_shards_partition_the_epoch(runs):
    """The CLI's real VOC loader on each rank: disjoint shards whose union
    is the epoch's first full batches, rank r taking every other index of
    the shuffled epoch."""
    (i0, n), (i1, _) = (r["loader"] for r in runs["ranks"])
    assert len(i0) == len(i1) > 0 and not set(i0) & set(i1)
    perm = np.arange(n)
    np.random.RandomState(42).shuffle(perm)
    assert i0 == perm[0::2][:len(i0)].tolist()
    assert i1 == perm[1::2][:len(i1)].tolist()


def test_main_makes_and_destroys_the_group_torchrun_describes(tmp_path):
    """python -m torch.distributed.run -m cl4wsis_tpu_torch.cli.main, as a
    user starts it: each rank's main makes the gloo group from torchrun's
    variables, trains step 0 on its batches, rank 0 writes the checkpoint
    and both leave the group."""
    from tests.test_torch_dist import WORLD, free_port, rank_env
    env = {k: v for k, v in rank_env(0, WORLD, 0).items()
           if k not in dist.TORCHRUN_VARS}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(WORLD), "--master_addr", "127.0.0.1", "--master_port",
           str(free_port()), "-m", "cl4wsis_tpu_torch.cli.main", *COMMON,
           *STEP0, "--batch_size", "2", "--checkpoint", str(tmp_path / "ck")]
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, (p.stdout + p.stderr)[-6000:]
    assert p.stdout.count("[done]") == WORLD
    assert p.stdout.count("[epoch 0] loss=") == 1       # rank 0 logs
    assert os.path.exists(_ck(tmp_path / "ck", "exp_0"))


def _worker(root, val_path, voc_root, out):
    torch.set_num_threads(1)
    val = torch.load(val_path, weights_only=False)
    saves = []
    real_save = torch.save

    def counting(obj, f, *a, **kw):
        saves.append(str(f))
        return real_save(obj, f, *a, **kw)
    assert dist.init_from_env("cpu")
    try:
        torch.save = counting
        try:
            res = {"chain": chain(root, 2, val)}
        finally:
            torch.save = real_save
        res["saves"] = saves
        res["loader"] = loader_shard(voc_root)
        torch.save(res, f"{out}{dist.rank()}.pt")
    finally:
        dist.destroy()


if __name__ == "__main__":
    _worker(*sys.argv[1:])
