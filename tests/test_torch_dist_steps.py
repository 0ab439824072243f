"""One step-0, one phase-1 and one phase-2 step of the port at 2 gloo ranks
against the one-process port step on the same global batch (batch 4 of
the tiny model at 64^2, float32, SGD at 1e-4), on the CPU.

The same set-up runs in this process at world 1 (the reference) and in 2
worker processes that run this file (no JAX there). The steps draw their
dropout masks and random-drop labels from a generator seeded alike on
every rank, at the global batch's shape (``core/dist``), so the ranks
compute the one-process step. Held: the ranks' loss shares sum to the
one-process loss (1e-5 relative), both ranks end bit-equal, and each
parameter tensor's update reads within UPDATE_LIMIT of the one process's
(``update_readings`` of tests/test_torch_step0.py: the distance between
the updates over the norm of the reference's), BN statistics within
STATS_ATOL.
"""

import sys

import numpy as np
import pytest
import torch

from cl4wsis_tpu_torch.core import dist
from cl4wsis_tpu_torch.data.synthetic import synthetic_batches
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.ops.peaks import peak_extract_nchw, smoothing
from cl4wsis_tpu_torch.ops.resize import resize_bilinear
from cl4wsis_tpu_torch.train import phase1, phase2, schedule, step0
from cl4wsis_tpu_torch.train.state import TrainState
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler

SIZE, BS, TINY, LR = 64, 4, (1, 1, 1, 1), 1e-4
OLD, NEW = 3, 2
TOT = OLD + NEW
UPDATE_LIMIT = 1e-4
STATS_ATOL = 1e-5
PHASE2_GROUPS = {"body": 0.0, "seg": 0.0, "instance": 10.0, "pseudo": 0.0}


def _sgd(net, **kw):
    opt = schedule.make_optimizer(net, "sgd", **kw)
    return TrainState(net, opt, schedule.make_schedule("poly", LR, 100))


def _run(net, state, step, batch, **kw):
    """One step on this rank's rows; (metrics, state dict before, after)."""
    before = {k: t.clone() for k, t in net.state_dict().items()}
    mine = {k: dist.rows_of(torch.from_numpy(v)) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(3)
    metrics = step(state, mine, gen, **kw)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "before": before,
            "after": {k: t.clone() for k, t in net.state_dict().items()}}


def step0_case():
    torch.manual_seed(0)
    model = make_model((TOT,), "resnet101", 16, SIZE,
                       backbone_structure=TINY)
    step = step0.make_step0_train_step(model, device="cpu")
    b = next(synthetic_batches(BS, SIZE, TOT - 1, seed=4))
    batch = {k: b[k] for k in ("image", "seg", "inst")}
    return _run(model, _sgd(model), step, batch)


def phase1_case():
    """The use_pseudo program with PAMR, flac and the random drop."""
    torch.manual_seed(0)
    model = make_model((OLD, NEW), "resnet101", 16, SIZE, branch="none",
                       backbone_structure=TINY)
    model_old = make_model((OLD,), "resnet101", 16, SIZE, branch="none",
                           backbone_structure=TINY)
    pl, pg = PseudoLabeler(TOT), PeakGenerator(TOT - 1, OLD - 1)
    net = torch.nn.ModuleDict(dict(model=model, pseudolabeler=pl,
                                   peakgenerator=pg))
    step = phase1.make_phase1_train_step(model, model_old, pl, pg, OLD,
                                         use_pseudo=True, device="cpu")
    state = _sgd(net, group_scale={"body": 1.0, "seg": 10.0, "pseudo": 10.0},
                 group_fn=phase1.phase1_group_fn)
    b = next(synthetic_batches(BS, SIZE, TOT - 1, seed=6))
    batch = {"image": b["image"], "l1h": b["l1h"][:, 1:].copy()}
    return _run(net, state, step, batch)


def phase2_case():
    """The phase-2 step with the surgery of tests/test_torch_train.py made
    on the global batch: a seg bias toward the new class whose top two CAM
    peaks lie furthest apart, and a pseudo threshold between them, so that
    the label factory fires."""
    torch.manual_seed(0)
    model = make_model((OLD, NEW), "resnet101", 16, SIZE,
                       backbone_structure=TINY)
    model_old = make_model((OLD,), "resnet101", 16, SIZE,
                           backbone_structure=TINY)
    pl, pg = PseudoLabeler(TOT), PeakGenerator(TOT - 1, OLD - 1)
    rs = np.random.RandomState(3)
    images = (rs.randn(BS, SIZE, SIZE, 3) * 0.5).astype(np.float32)
    l1h = np.ones((BS, TOT - 1), np.float32)
    l1h[:, 1:OLD - 1] = 0.0
    with torch.no_grad():
        pg.extra_conv4.bias += 0.5
        for m in (model, pl, pg):
            m.eval()
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        _, feats = model.forward_seg(x, interpolate=False)
        _, cam = pg(pl(feats["body"]), label=torch.from_numpy(l1h))
        cam = resize_bilinear(smoothing(cam)[:, OLD - 1:], (SIZE, SIZE))
        conf = peak_extract_nchw(cam, kernel=15, k=2)[0].numpy()
        gaps = conf[:, :, 0] - conf[:, :, 1]
        b, c = np.unravel_index(int(np.argmax(gaps)), gaps.shape)
        thresh = float((conf[b, c, 0] + conf[b, c, 1]) / 2)
        model.cls[1].bias[c] += 10.0
        model.instance_head.classifier.center.cls[1].bias += 0.5
    step = phase2.make_phase2_train_step(model, model_old, pl, pg, OLD,
                                         pseudo_thresh=thresh,
                                         nms_kernel=15, device="cpu")
    return _run(model, _sgd(model, group_scale=PHASE2_GROUPS), step,
                {"image": images, "l1h": l1h})


CASES = {"step 0": step0_case, "phase 1": phase1_case,
         "phase 2": phase2_case}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests.test_torch_dist import WORLD, run_ranks
    tmp = tmp_path_factory.mktemp("steps")
    run_ranks(__file__, [tmp / "out"])
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"one": {k: f() for k, f in CASES.items()}, "ranks": ranks}


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_compute_the_one_process_step(runs, case):
    from tests.test_torch_step0 import update_readings
    one = runs["one"][case]
    ranks = [r[case] for r in runs["ranks"]]
    m = one["metrics"]
    assert m["loss"] > 0
    for k, v in m.items():
        got = sum(r["metrics"][k] for r in ranks)
        assert got == pytest.approx(v, rel=1e-5, abs=1e-6), k
    if case == "phase 2":     # the label factory fired
        assert m["pseudo_weight_px"] > 0
    for k, t in ranks[0]["after"].items():
        assert torch.equal(t, ranks[1]["after"][k]), k
    readings = update_readings(one["before"], ranks[0]["after"],
                               one["after"])
    moved = [k for k in readings
             if not torch.equal(one["after"][k], one["before"][k])]
    print(case, "largest update readings:",
          sorted(readings.items(), key=lambda kv: -kv[1])[:3])
    assert len(moved) > 10
    over = {k: v for k, v in readings.items() if not v <= UPDATE_LIMIT}
    assert not over, over
    for k, t in one["after"].items():
        if "running" in k:
            np.testing.assert_allclose(ranks[0]["after"][k].numpy(),
                                       t.numpy(), rtol=0, atol=STATS_ATOL,
                                       err_msg=k)


def _worker(out):
    torch.set_num_threads(1)
    assert dist.init_from_env("cpu")
    try:
        res = {k: f() for k, f in CASES.items()}
        torch.save(res, f"{out}{dist.rank()}.pt")
    finally:
        dist.destroy()


if __name__ == "__main__":
    _worker(*sys.argv[1:])
