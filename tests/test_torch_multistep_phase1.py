"""One phase-1 step at VOC 15-1's step 2 in the port against the JAX
package on the CPU: one new class (channel and row counts of 1 in the CAM
losses, the random drop, flac and the PeakGenerator), a model of three
classifier groups and an old model of two, with JAX's draws injected, at
tests/test_torch_phase1.py's tiny size and tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from cl4wsis_tpu.train import phase1 as jphase1
from cl4wsis_tpu.train import schedule as jschedule
from cl4wsis_tpu.train.state import TrainState as JaxState
from cl4wsis_tpu.wss import PeakGenerator as JaxPG
from cl4wsis_tpu.wss import PseudoLabeler as JaxPL
from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables
from cl4wsis_tpu_torch.train import phase1, schedule
from cl4wsis_tpu_torch.train.state import TrainState
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler
from tests.test_torch_multistep import port_and_jax, wss_to_jax
from tests.test_torch_phase1 import (GROUPS, LR, RED_BN_ATOL, SIZE,
                                     UPDATE_RTOL, _np, update_readings)
from torch_one_thread import one_torch_thread  # noqa: F401

# the tiny stand-in of 15-1's step 2: 3 + 1 classes before, 1 new
CLASSES = (3, 1, 1)
TOT = sum(CLASSES)
OLD = TOT - CLASSES[-1]
# batch 4: the ASPP head's pooled branch normalises over the batch's
# pooled values, and at batch 2 its red_bn statistics are ill-conditioned
# in float32 (tests/test_torch_phase1.py); one of this draw's 256 variances
# there differs from JAX's by 8e-4
BS = 4
METRICS = ("loss", "l_seg", "l_cam_int", "l_cam_new", "l_loc", "l_cls", "lde",
           "flac")


@pytest.fixture(scope="module")
def one_new_class_run():
    """One use_pseudo phase-1 step of JAX and of the port from the same
    weights (the port's init, carried to JAX), batch and draws (split the
    key in 3, then randint), every image labelled with every class."""
    model, jm, mv = port_and_jax(CLASSES, 0, instance=False)
    model_old, jmo, ov = port_and_jax(CLASSES[:2], 1, instance=False)
    torch.manual_seed(2)
    pl, pg = PseudoLabeler(TOT), PeakGenerator(TOT - 1, OLD - 1)
    plv, pgv = wss_to_jax(pl), wss_to_jax(pg)
    images = np.random.RandomState(9).randn(BS, SIZE, SIZE, 3).astype(
        np.float32)
    l1h = np.ones((BS, TOT - 1), np.float32)

    params = {"model": mv["params"], "pseudolabeler": plv["params"],
              "peakgenerator": pgv["params"]}
    stats = {"model": mv["batch_stats"],
             "pseudolabeler": plv["batch_stats"], "peakgenerator": {}}
    tx = jschedule.make_optimizer(
        params, "sgd", jschedule.make_schedule("poly", LR, 100),
        group_scale=GROUPS, group_fn=jphase1.phase1_group_fn)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=stats, opt_state=tx.init(params))
    step = jphase1.make_phase1_train_step(
        jm, jmo, JaxPL(num_classes=TOT),
        JaxPG(num_classes=TOT - 1, old_classes=OLD - 1), tx,
        old_classes=OLD, use_pseudo=True)
    rng = jax.random.PRNGKey(11)
    new_state, metrics = step(state, {"image": jnp.asarray(images),
                                      "l1h": jnp.asarray(l1h)}, ov, rng)
    _, rng_angle, rng_randrop = jax.random.split(rng, 3)
    fs = SIZE // 16
    draws = {"angle_k": int(jax.random.randint(rng_angle, (), 1, 4)),
             "labels_neg": torch.from_numpy(np.array(jax.random.randint(
                 rng_randrop, (BS, fs, fs), 0, OLD)))}
    want = {}
    for part in ("model", "pseudolabeler", "peakgenerator"):
        sd = convert_jax_variables(
            {"params": _np(new_state.params[part]),
             "batch_stats": _np(new_state.batch_stats.get(part, {}))})
        want.update({f"{part}.{k}": v for k, v in sd.items()})

    net = nn.ModuleDict(dict(model=model, pseudolabeler=pl, peakgenerator=pg))
    before = {k: t.clone() for k, t in net.state_dict().items()}
    opt = schedule.make_optimizer(net, "sgd", group_scale=GROUPS,
                                  group_fn=phase1.phase1_group_fn)
    st = TrainState(net, opt, schedule.make_schedule("poly", LR, 100))
    port_step = phase1.make_phase1_train_step(
        model, model_old, pl, pg, OLD, use_pseudo=True, device="cpu")
    got = port_step(st, {"image": torch.from_numpy(images),
                         "l1h": torch.from_numpy(l1h)}, draws=draws)
    return {"want": {k: np.asarray(m) for k, m in metrics.items()},
            "got": {k: t.numpy() for k, t in got.items()},
            "want_state": want, "before": before, "after": net.state_dict()}


def test_one_new_class_phase1_metrics_match_jax(one_new_class_run):
    """Every loss term within rtol 1e-4 (atol 1e-7 for terms that are 0);
    the CAM, distillation, flac and pseudo-GT seg terms are live."""
    r = one_new_class_run
    for k in METRICS:
        np.testing.assert_allclose(r["got"][k], r["want"][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for k in ("l_cam_new", "l_loc", "lde", "flac", "l_seg"):
        assert r["want"][k] > 0, k


def test_one_new_class_phase1_updates_as_jax(one_new_class_run):
    """After one SGD step, every parameter tensor's update within
    UPDATE_RTOL of JAX's (update_readings), every BN statistic within 1e-5
    (the head's red_bn within RED_BN_ATOL); the newest classifier group
    (one row), the PseudoLabeler and the PeakGenerator's one-class conv
    moved."""
    r = one_new_class_run
    after, before, want = r["after"], r["before"], r["want_state"]
    assert set(want) == set(after)
    readings = update_readings(before, after, want)
    over = {k: v for k, v in readings.items() if not v <= UPDATE_RTOL}
    assert not over, over
    for k, w in want.items():
        if "running" in k:
            atol = RED_BN_ATOL if k.startswith("model.head.red_bn.") \
                else 1e-5
            np.testing.assert_allclose(after[k].numpy(), w.numpy(), rtol=0,
                                       atol=atol, err_msg=k)
    assert after["model.cls.2.weight"].shape[0] == 1
    for k in ("model.cls.2.weight", "pseudolabeler.cls.weight",
              "peakgenerator.extra_conv4.weight"):
        assert not torch.equal(after[k], before[k]), k
