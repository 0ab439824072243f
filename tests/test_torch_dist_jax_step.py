"""The port's phase-2 step at 2 gloo ranks (4 rows each) against the JAX
package's phase-2 step on its 8-device CPU mesh (``mesh=create_mesh()``,
the batch sharded over it and the label factory under ``shard_map``), at
batch 8 of the tiny model, float32, SGD. The JAX run's dropout mask is
handed to the ranks, each applying its rows; the surgery that makes the
label factory fire is tests/test_torch_train.py's.

The ranks are 2 worker processes that run this file (no JAX there); JAX
is imported inside the fixture. Held: the summed metrics against JAX's
within 1e-4 relative (label_truncated exactly), and each parameter
tensor's update within 0.05 of JAX's by ``update_readings``
(tests/test_torch_step0.py), the limit of the one-process phase-1 test.
"""

import sys

import numpy as np
import pytest
import torch

from cl4wsis_tpu_torch.core import dist
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.train import schedule
from cl4wsis_tpu_torch.train.phase2 import make_phase2_train_step
from cl4wsis_tpu_torch.train.state import TrainState
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler
from torch_one_thread import one_torch_thread  # noqa: F401

OLD, NEW = 3, 2
TOT = OLD + NEW
SIZE, BS, TINY = 64, 8, (1, 1, 1, 1)
NMS_KERNEL, SIGMA, BETA, LR = 15, 6, 3.0, 1e-4
GROUPS = {"body": 0.0, "seg": 0.0, "instance": 10.0, "pseudo": 0.0}
UPDATE_LIMIT = 0.05


class _RowsDropout(torch.nn.Module):
    """A given dropout mask of the global batch, of which each rank applies
    its rows, as flax applies it."""

    def __init__(self, keep):
        super().__init__()
        self.keep = keep

    def forward(self, x, generator=None):
        return torch.where(dist.rows_of(self.keep), x / 0.5, 0.0)


def port_step(d):
    """The port's step on this rank's rows of d's batch, from d's weights."""
    model = make_model((OLD, NEW), "resnet101", 16, SIZE,
                       backbone_structure=TINY)
    model.load_state_dict(d["model"])
    model_old = make_model((OLD,), "resnet101", 16, SIZE,
                           backbone_structure=TINY)
    model_old.load_state_dict(d["model_old"])
    pl, pg = PseudoLabeler(TOT), PeakGenerator(TOT - 1, OLD - 1)
    pl.load_state_dict(d["pl"])
    pg.load_state_dict(d["pg"])
    model.decoder.instance_decoder.aspp.project_drop = _RowsDropout(d["keep"])
    opt = schedule.make_optimizer(model, "sgd", group_scale=GROUPS)
    st = TrainState(model, opt, schedule.make_schedule("poly", LR, 100))
    step = make_phase2_train_step(model, model_old, pl, pg, OLD,
                                  device="cpu", **d["kw"])
    got = step(st, {k: dist.rows_of(d[k]) for k in ("image", "l1h")})
    return {"metrics": {k: float(v) for k, v in got.items()},
            "after": model.state_dict()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from cl4wsis_tpu.core import create_mesh, replicate, shard_batch
    from cl4wsis_tpu.ops.peaks import peak_extract
    from cl4wsis_tpu.ops.peaks import smoothing as jax_smoothing
    from cl4wsis_tpu.ops.resize import resize_bilinear as jax_resize
    from cl4wsis_tpu.train import schedule as jschedule
    from cl4wsis_tpu.train.phase2 import make_phase2_train_step as jax_phase2
    from cl4wsis_tpu.train.state import TrainState as JaxState
    from cl4wsis_tpu.wss import PeakGenerator as JaxPG
    from cl4wsis_tpu.wss import PseudoLabeler as JaxPL
    from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables
    from tests.test_torch_dist import WORLD, run_ranks
    from tests.test_torch_train import _jax_tiny, _np, _record_dropout

    jm, mv = _jax_tiny((OLD, NEW), 0)
    jmo, ov = _jax_tiny((OLD,), 0)
    jpl, jpg = JaxPL(num_classes=TOT), JaxPG(num_classes=TOT - 1,
                                             old_classes=OLD - 1)
    fs = SIZE // 16
    plv = _np(jpl.init(jax.random.PRNGKey(1), jnp.zeros((1, fs, fs, 2048))))
    pgv = _np(jpg.init(jax.random.PRNGKey(2), jnp.zeros((1, fs, fs, TOT))))
    pgv["params"]["extra_conv4"]["bias"] = (
        pgv["params"]["extra_conv4"]["bias"] + np.float32(0.5))
    aux = {"pseudolabeler": plv, "peakgenerator": pgv}
    rs = np.random.RandomState(3)
    images = rs.randn(BS, SIZE, SIZE, 3).astype(np.float32) * 0.5
    l1h = np.zeros((BS, TOT - 1), np.float32)
    l1h[:, 0] = 1.0
    l1h[:, OLD - 1:] = 1.0
    rng = jax.random.PRNGKey(11)

    # tests/test_torch_train.py's surgery over the batch of 8
    (_, feats) = jm.apply(mv, jnp.asarray(images), train=False,
                          interpolate=False, method=jm.forward_seg)
    _, cam = jpg.apply(pgv, jpl.apply(plv, feats["body"], train=False),
                       label=jnp.asarray(l1h), train=False)
    cam = jax_resize(jax_smoothing(cam), (SIZE, SIZE), align_corners=False)
    conf2 = np.asarray(peak_extract(cam, kernel=NMS_KERNEL, k=2)[0])
    new_cls = list(range(OLD - 1, TOT - 1))
    gaps = conf2[:, new_cls, 0] - conf2[:, new_cls, 1]
    bstar, ci = np.unravel_index(int(np.argmax(gaps)), gaps.shape)
    cstar = new_cls[int(ci)]
    pseudo_thresh = float((conf2[bstar, cstar, 0] + conf2[bstar, cstar, 1])
                          / 2)
    bias = mv["params"]["cls"]["cls_1"]["bias"].copy()
    bias[cstar - (OLD - 1)] += 10.0
    mv["params"]["cls"]["cls_1"]["bias"] = bias
    center = mv["params"]["instance_head"]["center_cls_1"]
    center["bias"] = center["bias"] + np.float32(0.5)
    _, _, keep = _record_dropout(jm, mv, feats["features"], rng)

    mesh = create_mesh()
    assert mesh.size == 8
    params = {"model": mv["params"]}
    tx = jschedule.make_optimizer(
        params, "sgd", jschedule.make_schedule("poly", LR, 100),
        group_scale=GROUPS,
        group_fn=lambda p: jschedule.default_group_fn(p.split("/", 1)[1]))
    state = replicate(JaxState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats={"model": mv["batch_stats"]},
                               opt_state=tx.init(params)), mesh)
    kw = dict(sigma=SIGMA, pseudo_thresh=pseudo_thresh, refine_thresh=0.3,
              nms_kernel=NMS_KERNEL, beta=BETA)
    step = jax_phase2(jm, jmo, jpl, jpg, tx, old_classes=OLD, cc_iters=64,
                      mesh=mesh, **kw)
    batch = shard_batch({"image": images, "l1h": l1h}, mesh)
    new_state, metrics = step(state, batch, replicate(ov, mesh),
                              replicate(aux, mesh), rng)
    want = {"metrics": {k: np.asarray(m) for k, m in metrics.items()},
            "state": convert_jax_variables(
                {"params": _np(new_state.params["model"]),
                 "batch_stats": _np(new_state.batch_stats["model"])})}

    tmp = tmp_path_factory.mktemp("jax_step")
    d = {"model": convert_jax_variables(mv), "model_old":
         convert_jax_variables(ov), "pl": convert_jax_variables(plv),
         "pg": convert_jax_variables(pgv), "image": torch.from_numpy(images),
         "l1h": torch.from_numpy(l1h), "kw": kw,
         "keep": torch.from_numpy(keep).permute(0, 3, 1, 2)}
    torch.save(d, tmp / "in.pt")
    run_ranks(__file__, [tmp / "in.pt", tmp / "out"])
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"want": want, "before": d["model"], "ranks": ranks}


def test_two_rank_phase2_step_matches_jax_on_the_mesh(runs):
    from tests.test_torch_step0 import update_readings
    want, ranks = runs["want"], runs["ranks"]
    m = want["metrics"]
    assert m["pseudo_weight_px"] > 0 and m["label_truncated"] > 0
    for k in ("loss", "l_center", "l_offset", "pseudo_weight_px"):
        got = sum(r["metrics"][k] for r in ranks)
        np.testing.assert_allclose(got, m[k], rtol=1e-4, err_msg=k)
    assert sum(r["metrics"]["label_truncated"] for r in ranks) == \
        int(m["label_truncated"])
    after = ranks[0]["after"]
    for k, t in after.items():
        assert torch.equal(t, ranks[1]["after"][k]), k
    readings = update_readings(runs["before"], after, want["state"])
    moved = [k for k, w in want["state"].items()
             if "running" not in k and not torch.equal(w, runs["before"][k])]
    print("largest update readings:",
          sorted(readings.items(), key=lambda kv: -kv[1])[:3])
    assert len(moved) > 10
    over = {k: v for k, v in readings.items() if not v <= UPDATE_LIMIT}
    assert not over, over


def _worker(inp, out):
    torch.set_num_threads(1)
    assert dist.init_from_env("cpu")
    try:
        res = port_step(torch.load(inp, weights_only=False))
        torch.save(res, f"{out}{dist.rank()}.pt")
    finally:
        dist.destroy()


if __name__ == "__main__":
    _worker(*sys.argv[1:])
