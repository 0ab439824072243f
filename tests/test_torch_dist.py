"""Data-parallel runs of the port over 2 gloo ranks on the CPU
(cl4wsis_tpu_torch/core/dist.py): synchronised ABN, ABR and AIN, the losses
that count over the global batch, the metrics' synch and the refusals.

Every case is a function of the global inputs that runs the same code at
world 1 (in this process: the one-process reference over the whole batch)
and in 2 worker processes that run this file (each takes its rows through
``dist.rows_of``). The workers import no JAX: it is imported inside the
tests only. Tolerance: 1e-5 relative to the largest reference value,
float32 sums taken in another order.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cl4wsis_tpu_torch.core import dist
from cl4wsis_tpu_torch.core.abn import ABN
from cl4wsis_tpu_torch.core.norms import ABR, AIN
from cl4wsis_tpu_torch.metrics.stream import StreamSegMetrics
from cl4wsis_tpu_torch.metrics.voc_ap import InstanceAPAccumulator
from cl4wsis_tpu_torch.train import losses
from cl4wsis_tpu_torch.wss import losses as wss_losses
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RTOL = 1e-5


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's variables for a gloo group on this host, one thread a
    process (the tests run beside others)."""
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep +
                os.environ.get("PYTHONPATH", ""), CL4WSIS_MULTIHOST="1",
                RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                OMP_NUM_THREADS="1")


def run_ranks(script, args, world=WORLD, timeout=600):
    """Run `world` processes of `script` with `args` as the ranks of one
    gloo group; raise with their output if one fails or hangs."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, script, *map(str, args)],
                              env=rank_env(r, world, port),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return logs


# ---------------------------------------------------------------- cases

NORMS = {"abn": ABN, "abr": ABR, "ain": AIN}


def _inputs():
    rs = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    B, C, H, W = 8, 3, 5, 6
    data = {"x": t(B, C, H, W) * 2 + 1, "g": t(B, C, H, W),
            "w": t(C), "b": t(C), "rm": t(C) * 0.1,
            "rv": torch.from_numpy(rs.rand(C).astype(np.float32) + 0.5)}
    # weighted losses: a sparse weight, denser in rank 0's rows
    data["out"], data["tgt"] = t(B, 2, H, W), t(B, 2, H, W)
    keep = rs.rand(B, 1, H, W) > np.repeat([0.3, 0.8], B // 2)[:, None,
                                                                 None, None]
    data["wgt"] = t(B, 1, H, W).abs() * torch.from_numpy(keep)
    # deeplab_ce: continuous logits, and logits in {0, 1} whose pixel
    # losses tie at the k-th value
    C2 = 4
    data["logits"] = t(B, C2, H, W)
    data["logits_tied"] = torch.from_numpy(
        rs.randint(0, 2, (B, C2, H, W)).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, C2, (B, H, W)))
    labels[:, 0, :2] = 255
    data["labels"] = labels
    # randrop: the last two images have no confident new class
    C3, old = 5, 3
    data["cam"] = t(B, C3, H, W)
    ref = torch.from_numpy(rs.rand(B, C3, H, W).astype(np.float32))
    ref[-2:, old:] = 0.2
    data["ref"] = ref
    data["neg"] = torch.from_numpy(rs.randint(0, old, (B, H, W)))
    data["label"] = torch.from_numpy(
        (rs.rand(B, C3 - 1) > 0.5).astype(np.float32))
    # metrics: label maps and AP images
    data["seg_true"] = rs.randint(0, 4, (B, H, W))
    data["seg_pred"] = rs.randint(0, 4, (B, H, W))
    imgs = []
    for _ in range(B):
        n_gt, n_pred = rs.randint(1, 4), rs.randint(0, 5)
        imgs.append((rs.randint(0, 3, n_gt), rs.rand(n_gt, 8, 8) > 0.5,
                     rs.randint(0, 3, n_pred), rs.rand(n_pred),
                     rs.rand(n_pred, n_gt)))
    data["ap_images"] = imgs
    return data


def norm_case(d, kind):
    """Train-mode forward, the backward of sum(y * g) and the gradients
    summed over ranks, from the same weights and running stats."""
    m = NORMS[kind](d["x"].shape[1])
    with torch.no_grad():
        m.weight.copy_(d["w"])
        m.bias.copy_(d["b"])
        m.running_mean.copy_(d["rm"])
        m.running_var.copy_(d["rv"])
    m.train()
    x = dist.rows_of(d["x"]).clone().requires_grad_()
    y = m(x)
    (y * dist.rows_of(d["g"])).sum().backward()
    dist.sum_grads(m.parameters())
    return {"y": y.detach(), "dx": x.grad, "dw": m.weight.grad,
            "db": m.bias.grad, "rm": m.running_mean.clone(),
            "rv": m.running_var.clone()}


def _loss_and_grad(fn, x):
    x = dist.rows_of(x).clone().requires_grad_()
    loss = fn(x)
    loss.backward()
    return {"loss": loss.detach(), "dx": x.grad}


def loss_cases(d):
    rows = dist.rows_of
    out = {"weighted_mse": _loss_and_grad(
        lambda o: losses.weighted_mse(o, rows(d["tgt"]), rows(d["wgt"])),
        d["out"])}
    for name, key in (("dce", "logits"), ("dce_tied", "logits_tied")):
        for pct in (0.2, 0.8):       # at 0.8, k is over a rank's pixels
            out[f"{name}_{pct}"] = _loss_and_grad(
                lambda z: losses.deeplab_ce(z, rows(d["labels"]),
                                            top_k_percent=pct), d[key])
    for with_label in (False, True):
        out[f"randrop_{with_label}"] = _loss_and_grad(
            lambda z: wss_losses.randrop_loss(
                z, rows(d["ref"]), rows(d["neg"]), 3,
                label=rows(d["label"]) if with_label else None), d["cam"])
    return out


def metric_cases(d):
    """Each rank accumulates its strided shard of the images, then synchs."""
    r, w = dist.rank(), dist.world()
    seg = StreamSegMetrics(4)
    seg.update(d["seg_true"][r::w], d["seg_pred"][r::w])
    seg.synch()
    ap = InstanceAPAccumulator()
    for img in d["ap_images"][r::w]:
        ap.add_image(*img)
    ap.synch()
    res = ap.results()
    return {"seg": seg.get_results(), "conf": seg.confusion_matrix,
            "ap": res["ap"], "map": res["map"], "map50": res["map50"]}


def all_cases(d):
    out = {kind: norm_case(d, kind) for kind in NORMS}
    out["losses"] = loss_cases(d)
    out["metrics"] = metric_cases(d)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases at world 1 over the whole batch, and each of 2 ranks'."""
    tmp = tmp_path_factory.mktemp("dist")
    data = _inputs()
    torch.save(data, tmp / "in.pt")
    run_ranks(__file__, [tmp / "in.pt", tmp / "out"])
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"data": data, "one": all_cases(data), "ranks": ranks}


def close(got, want, rtol=RTOL, err_msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def rows_cat(ranks, *path):
    """The ranks' per-row results in rank order: the global batch's."""
    def get(r):
        for p in path:
            r = r[p]
        return r
    return torch.cat([get(r) for r in ranks])


@pytest.mark.parametrize("kind", ["abn", "abr", "ain"])
def test_synchronised_norm_matches_one_process(runs, kind):
    """2 ranks x 4 rows against one process at 8: the output and input
    gradient row for row, the summed weight and bias gradients and the
    running stats on every rank, within 1e-5 relative."""
    one, ranks = runs["one"][kind], runs["ranks"]
    for k in ("y", "dx"):
        close(rows_cat(ranks, kind, k), one[k], err_msg=k)
    for r in ranks:
        for k in ("dw", "db", "rm", "rv"):
            close(r[kind][k], one[k], err_msg=f"{kind} {k}")
    if kind == "abn":       # the running stats moved
        assert not torch.allclose(one["rv"], runs["data"]["rv"])


def test_synchronised_abn_matches_jax_on_the_mesh(runs):
    """ABN at 2 ranks x 4 against the JAX module on the 8-device mesh at
    batch 8 (the batch sharded over the mesh): output, input gradient and
    running stats within 1e-5 relative."""
    import jax
    import jax.numpy as jnp

    from cl4wsis_tpu.core import create_mesh, shard_batch
    from cl4wsis_tpu.core.abn import ABN as JaxABN

    d, ranks = runs["data"], runs["ranks"]
    mesh = create_mesh()
    assert mesh.size == 8
    nhwc = lambda t: np.ascontiguousarray(t.numpy().transpose(0, 2, 3, 1))
    sharded = shard_batch({"x": nhwc(d["x"]), "g": nhwc(d["g"])}, mesh)
    x, g = sharded["x"], sharded["g"]
    C = d["x"].shape[1]
    variables = {"params": {"scale": d["w"].numpy(), "bias": d["b"].numpy()},
                 "batch_stats": {"mean": d["rm"].numpy(),
                                 "var": d["rv"].numpy()}}
    m = JaxABN(C)

    @jax.jit
    def run(x, g):
        def f(x):
            y, upd = m.apply(variables, x, train=True,
                             mutable=["batch_stats"])
            return jnp.sum(y * g), (y, upd)
        (_, (y, upd)), dx = jax.value_and_grad(f, has_aux=True)(x)
        return y, dx, upd["batch_stats"]

    y, dx, stats = run(x, g)
    to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    close(rows_cat(ranks, "abn", "y"), to_nchw(y), err_msg="y")
    close(rows_cat(ranks, "abn", "dx"), to_nchw(dx), err_msg="dx")
    for r in ranks:
        close(r["abn"]["rm"], stats["mean"], err_msg="running mean")
        close(r["abn"]["rv"], stats["var"], err_msg="running var")


LOSSES = ["weighted_mse", "dce_0.2", "dce_0.8", "randrop_False",
          "randrop_True"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_shares_sum_to_the_one_process_loss(runs, name):
    """The ranks' shares sum to the one-process loss and the gradients of
    their rows are the one process's rows, within 1e-5 relative."""
    one, ranks = runs["one"]["losses"][name], runs["ranks"]
    close(sum(float(r["losses"][name]["loss"]) for r in ranks),
          float(one["loss"]), err_msg=name)
    assert float(one["loss"]) > 0
    close(rows_cat(ranks, "losses", name, "dx"), one["dx"], err_msg=name)


@pytest.mark.parametrize("pct", [0.2, 0.8])
def test_deeplab_ce_with_ties_at_the_kth_value(runs, pct):
    """Pixel losses tied at the global k-th value: the shares sum to the
    one-process loss within 1e-5, and the gradient is the one process's
    at every pixel whose loss is not the tied value; of the tied pixels as
    many get the gradient as in one process (which of them may differ)."""
    name = f"dce_tied_{pct}"
    d, one, ranks = runs["data"], runs["one"]["losses"][name], runs["ranks"]
    close(sum(float(r["losses"][name]["loss"]) for r in ranks),
          float(one["loss"]), err_msg=name)
    logp = torch.log_softmax(d["logits_tied"], 1)
    valid = d["labels"] != 255
    nll = -torch.gather(logp, 1, torch.where(valid, d["labels"], 0)[:, None]
                        )[:, 0] * valid
    flat = nll.reshape(-1)
    k = max(int(pct * flat.numel()), 1)
    t = torch.topk(flat, k).values[-1]
    tied = (nll == t)[:, None].expand_as(one["dx"])
    assert int((nll == t).sum()) > 1 and int((nll > t).sum()) < k
    got = rows_cat(ranks, "losses", name, "dx")
    close(got[~tied], one["dx"][~tied], err_msg=name)
    picked = lambda g: int((g.abs().sum(1) > 0)[nll == t].sum())
    assert picked(got) == picked(one["dx"]) > 0


def test_metric_synch_equals_the_one_process_merge(runs):
    """StreamSegMetrics and InstanceAPAccumulator, each rank on its strided
    shard, then synch: every rank holds the results of one process over
    all the images (the counterparts of tests/test_multihost.py's)."""
    one, ranks = runs["one"]["metrics"], runs["ranks"]
    for r in ranks:
        m = r["metrics"]
        np.testing.assert_array_equal(m["conf"], one["conf"])
        assert m["seg"]["Total samples"] == one["seg"]["Total samples"] == 8
        assert m["seg"]["Mean IoU"] == one["seg"]["Mean IoU"]
        np.testing.assert_allclose(m["ap"], one["ap"], rtol=1e-12)
        assert m["map"] == pytest.approx(one["map"], rel=1e-12)
        assert m["map50"] == pytest.approx(one["map50"], rel=1e-12)


def test_without_a_group_every_helper_is_the_identity():
    """No group here: world 1, rank 0, and the collectives change nothing."""
    assert (dist.world(), dist.rank(), dist.is_main()) == (1, 0, True)
    x = torch.arange(6.0).reshape(3, 2)
    assert dist.all_sum(x) is x and dist.rows_of(x) is x
    assert dist.global_shape(x.shape) == (3, 2)
    a = np.arange(4)
    assert dist.sum_array(a) is a and dist.gather_objects(1) == [1]
    dist.barrier()
    dist.check_same({"x": x}, "x")


def test_multihost_without_torchrun_or_a_card_raises(monkeypatch):
    """CL4WSIS_MULTIHOST=1 without torchrun's variables raises, and so does
    a LOCAL_RANK at or above the number of cards; neither falls back to
    one process. Without the switch nothing is joined."""
    monkeypatch.delenv("CL4WSIS_MULTIHOST", raising=False)
    assert dist.init_from_env("cpu") is False
    monkeypatch.setenv("CL4WSIS_MULTIHOST", "1")
    for k in dist.TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        dist.init_from_env("cpu")
    for k, v in rank_env(1, 2, free_port()).items():
        if k in dist.TORCHRUN_VARS:
            monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card"):
        dist.init_from_env("cuda")
    assert not torch.distributed.is_initialized()


def _worker(inp, out):
    torch.set_num_threads(1)
    assert dist.init_from_env("cpu")
    try:
        res = all_cases(torch.load(inp, weights_only=False))
        torch.save(res, f"{out}{dist.rank()}.pt")
    finally:
        dist.destroy()


if __name__ == "__main__":
    _worker(*sys.argv[1:])
