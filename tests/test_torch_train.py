"""The port's training slice (cl4wsis_tpu_torch: train-mode ABN, the
weak-supervision modules, the model's seg and instance forwards, the
grouped optimizer, the losses, and one whole phase-2 step) against the JAX
package on the CPU, in float32, with weights carried over by
cl4wsis_tpu_torch.cl.ckpt.convert_jax_variables."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl4wsis_tpu.core.abn import ABN as JaxABN
from cl4wsis_tpu.models import CL4WSISModel
from cl4wsis_tpu.ops.peaks import peak_extract, smoothing as jax_smoothing
from cl4wsis_tpu.ops.resize import resize_bilinear as jax_resize
from cl4wsis_tpu.train import losses as jlosses
from cl4wsis_tpu.train import schedule as jschedule
from cl4wsis_tpu.train.phase2 import make_phase2_train_step as jax_phase2
from cl4wsis_tpu.train.state import TrainState as JaxState
from cl4wsis_tpu.wss import PeakGenerator as JaxPG
from cl4wsis_tpu.wss import PseudoLabeler as JaxPL
from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables
from cl4wsis_tpu_torch.core.abn import ABN
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.train import losses, schedule
from cl4wsis_tpu_torch.train.phase2 import make_phase2_train_step
from cl4wsis_tpu_torch.train.state import TrainState
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler

OLD, NEW = 3, 2
TOT = OLD + NEW
SIZE = 64
BS = 2
NMS_KERNEL = 15
TINY = (1, 1, 1, 1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------------- ABN

@pytest.mark.parametrize("activation", ["leaky_relu", "relu", "identity"])
def test_abn_train_matches_jax(activation):
    """Output and the moved running stats within 1e-5."""
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 5, 7, 8) * 2 + 0.5).astype(np.float32)
    v = {"params": {"scale": rs.uniform(-1.5, 1.5, 8).astype(np.float32),
                    "bias": (0.1 * rs.randn(8)).astype(np.float32)},
         "batch_stats": {"mean": (0.1 * rs.randn(8)).astype(np.float32),
                         "var": rs.uniform(0.5, 1.5, 8).astype(np.float32)}}
    want, upd = JaxABN(features=8, activation=activation).apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    m = ABN(8, activation=activation).train()
    m.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                       "bias": torch.from_numpy(v["params"]["bias"]),
                       "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
                       "running_var": torch.from_numpy(v["batch_stats"]["var"])})
    got = m(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)
    for k, tk in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(m, tk).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=0, atol=1e-5)


# ------------------------------------------------- weak supervision CAM

def test_pseudolabeler_peakgenerator_cam_matches_jax():
    """PseudoLabeler output and the PeakGenerator's eval CAM (smoothed)
    within 1e-5; both weights carried over by the converter."""
    rs = np.random.RandomState(1)
    feats = rs.randn(BS, 4, 4, 2048).astype(np.float32)
    l1h = np.ones((BS, TOT - 1), np.float32)
    l1h[0, -1] = 0.0
    jpl, jpg = JaxPL(num_classes=TOT), JaxPG(num_classes=TOT - 1,
                                             old_classes=OLD - 1)
    plv = _np(jpl.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, 4, 2048))))
    pgv = _np(jpg.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, 4, TOT))))
    plv["batch_stats"]["norm1"]["var"] = rs.uniform(
        0.5, 1.5, 256).astype(np.float32)
    pgv["params"]["extra_conv4"]["bias"] = (
        pgv["params"]["extra_conv4"]["bias"] + np.float32(0.5))
    int_masks = jpl.apply(plv, jnp.asarray(feats), train=False)
    _, cam = jpg.apply(pgv, int_masks, label=jnp.asarray(l1h), train=False)
    cam = jax_smoothing(cam)

    pl = PseudoLabeler(TOT).eval()
    pl.load_state_dict(convert_jax_variables(plv))
    pg = PeakGenerator(TOT - 1, OLD - 1).eval()
    pg.load_state_dict(convert_jax_variables(pgv))
    with torch.no_grad():
        got_masks = pl(_nchw(feats))
        _, got_cam = pg(got_masks, label=torch.from_numpy(l1h))
        from cl4wsis_tpu_torch.ops.peaks import smoothing
        got_cam = smoothing(got_cam)
    np.testing.assert_allclose(_nhwc(got_masks), np.asarray(int_masks),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_nhwc(got_cam), np.asarray(cam), rtol=0,
                               atol=1e-5)
    assert np.asarray(cam)[..., OLD - 1:].max() > 0.5


# ----------------------------------------------------- model forwards

def _jax_tiny(classes, seed):
    jm = CL4WSISModel(classes=classes, pooling_size=SIZE // 16,
                      has_instance=True, backbone_structure=TINY)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    return jm, _np(v)


def _port_tiny(classes, variables):
    m = make_model(classes, "resnet101", 16, SIZE, backbone_structure=TINY)
    m.load_state_dict(convert_jax_variables(variables))
    return m


def _record_dropout(jm, variables, feats, rng):
    """The JAX instance forward in train mode, with the output of the ASPP
    projection's dropout recorded: (outputs, new stats, kept mask NHWC)."""
    seen = {}

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.module.name == "project_drop":
            seen["out"] = np.asarray(out)
        return out

    with fnn.intercept_methods(intercept):
        out, upd = jm.apply(variables, feats, train=True,
                            method=jm.forward_instance,
                            mutable=["batch_stats"], rngs={"dropout": rng})
    return out, upd, seen["out"] != 0


class _RecordedDropout(torch.nn.Module):
    """The JAX run's dropout mask, applied as flax applies it."""

    def __init__(self, keep_nhwc):
        super().__init__()
        self.keep = torch.from_numpy(keep_nhwc).permute(0, 3, 1, 2)

    def forward(self, x, generator=None):
        return torch.where(self.keep, x / 0.5, 0.0)


def test_forward_seg_and_instance_match_jax():
    """forward_seg (eval) and forward_instance (train mode, the JAX run's
    dropout mask) within 1e-4; the instance BN stats within 1e-5."""
    jm, v = _jax_tiny((OLD, NEW), 0)
    x = np.random.RandomState(2).randn(BS, SIZE, SIZE, 3).astype(np.float32)
    (pred, feats) = jm.apply(v, jnp.asarray(x), train=False,
                             interpolate=False, method=jm.forward_seg)
    out, upd, keep = _record_dropout(jm, v, feats["features"],
                                     jax.random.PRNGKey(4))
    port = _port_tiny((OLD, NEW), v).eval()
    with torch.no_grad():
        gpred, gfeats = port.forward_seg(_nchw(x), interpolate=False)
    np.testing.assert_allclose(_nhwc(gpred["seg"]), np.asarray(pred["seg"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_nhwc(gfeats["body"]),
                               np.asarray(feats["body"]), rtol=1e-4,
                               atol=1e-4)
    port.decoder.train()
    port.instance_head.train()
    port.decoder.instance_decoder.aspp.project_drop = _RecordedDropout(keep)
    gout = port.forward_instance(gfeats["features"])
    for k in ("center", "offset"):
        np.testing.assert_allclose(_nhwc(gout[k]), np.asarray(out[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    sd = port.state_dict()
    want = convert_jax_variables({"batch_stats": _np(upd["batch_stats"])})
    assert len(want) > 20
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert 0.1 < keep.mean() < 0.55     # about half of the nonzero values


# -------------------------------------------------------- optimizer

GROUPS = {"body": 0.0, "seg": 0.0, "instance": 10.0, "pseudo": 0.0}


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_grouped_optimizer_matches_optax(optim):
    """Three steps of fixed gradients through the port's make_optimizer
    (poly schedule, groups 0/0/10/0) and the optax chain: parameters
    within 1e-7, relative above 1 (one float32 ulp at 1.0, where the BN
    scales sit, is 1.19e-7); frozen groups bit-unchanged."""
    jm, v = _jax_tiny((OLD, NEW), 1)
    params = {"model": v["params"]}
    rs = np.random.RandomState(3)
    grads = [jax.tree_util.tree_map(
        lambda p: rs.randn(*p.shape).astype(np.float32), params)
        for _ in range(3)]
    lr = jschedule.make_schedule("poly", 5e-5, 10)
    tx = jschedule.make_optimizer(
        params, optim, lr, group_scale=GROUPS,
        group_fn=lambda p: jschedule.default_group_fn(p.split("/", 1)[1]))
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats={}, opt_state=tx.init(params))
    for g in grads:
        state = state.apply_gradients(tx, g)

    port = _port_tiny((OLD, NEW), v)
    before = {k: t.clone() for k, t in port.state_dict().items()}
    opt = schedule.make_optimizer(port, optim, group_scale=GROUPS)
    st = TrainState(port, opt, schedule.make_schedule("poly", 5e-5, 10))
    named = dict(port.named_parameters())
    for g in grads:
        for k, t in convert_jax_variables({"params": g["model"]}).items():
            if named[k].requires_grad:
                named[k].grad = t
        st.apply_gradients()
    assert st.step == 3 and [g["name"] for g in opt.param_groups] == \
        ["instance"]
    want = convert_jax_variables({"params": _np(state.params["model"])})
    moved = 0
    for k, t in port.state_dict().items():
        if k not in want:
            continue
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-7,
                                   atol=1e-7, err_msg=k)
        if schedule.default_group_fn(k) != "instance":
            assert torch.equal(t, before[k]), k
        else:
            moved += int(not torch.equal(t, before[k]))
    assert moved > 10


def test_weighted_losses_match_jax():
    rs = np.random.RandomState(5)
    out = rs.randn(2, 6, 6, 3).astype(np.float32)
    tgt = rs.randn(2, 6, 6, 3).astype(np.float32)
    w = (rs.rand(2, 6, 6, 1) * (rs.rand(2, 6, 6, 1) > 0.5)).astype(np.float32)
    for jfn, fn in ((jlosses.weighted_mse, losses.weighted_mse),
                    (jlosses.weighted_l1, losses.weighted_l1)):
        args = [_nchw(a) for a in (out, tgt, w)]
        np.testing.assert_allclose(float(fn(*args)),
                                   float(jfn(out, tgt, w)), rtol=1e-6)
        assert float(fn(args[0], args[1], torch.zeros_like(args[2]))) == 0.0


# ------------------------------------------------------ whole step

SIGMA, BETA, LR = 6, 3.0, 1e-4


@pytest.fixture(scope="module", params=[True, False],
                ids=["refine", "no_refine"])
def phase2_runs(request):
    """One phase-2 step of the JAX package (compiled once per `run_refine`
    for this file) and of the port from the same weights, batch and dropout
    mask, with the parameter surgery of tests/test_whole_step_parity.py
    that makes the label factory fire; with and without the refinement
    mix (`run_refine`). SGD, whose update is linear in the gradient."""
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

    # a pseudo_thresh between the top two CAM peaks of the best-separated
    # new class, and a seg bias toward that class, so that one image-sized
    # component holds exactly one live peak
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
    pseudo_thresh = float((conf2[bstar, cstar, 0] + conf2[bstar, cstar, 1]) / 2)
    bias = mv["params"]["cls"]["cls_1"]["bias"].copy()
    bias[cstar - (OLD - 1)] += 10.0
    mv["params"]["cls"]["cls_1"]["bias"] = bias
    # the new-class center biases lifted, so that the refinement pass finds
    # more centers than its slots hold: its truncation count then tells the
    # two branches apart
    center = mv["params"]["instance_head"]["center_cls_1"]
    center["bias"] = center["bias"] + np.float32(0.5)

    _, _, keep = _record_dropout(jm, mv, feats["features"], rng)

    params = {"model": mv["params"]}
    stats = {"model": mv["batch_stats"]}
    tx = jschedule.make_optimizer(
        params, "sgd", jschedule.make_schedule("poly", LR, 100),
        group_scale=GROUPS,
        group_fn=lambda p: jschedule.default_group_fn(p.split("/", 1)[1]))
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=stats, opt_state=tx.init(params))
    kw = dict(sigma=SIGMA, pseudo_thresh=pseudo_thresh, refine_thresh=0.3,
              nms_kernel=NMS_KERNEL, beta=BETA, run_refine=request.param)
    step = jax_phase2(jm, jmo, jpl, jpg, tx, old_classes=OLD, cc_iters=64,
                      **kw)
    batch = {"image": jnp.asarray(images), "l1h": jnp.asarray(l1h)}
    new_state, metrics = step(state, batch, ov, aux, rng)
    want = {"metrics": {k: np.asarray(m) for k, m in metrics.items()},
            "state": convert_jax_variables(
                {"params": _np(new_state.params["model"]),
                 "batch_stats": _np(new_state.batch_stats["model"])})}

    model = _port_tiny((OLD, NEW), mv)
    model_old = _port_tiny((OLD,), ov)
    pl = PseudoLabeler(TOT)
    pl.load_state_dict(convert_jax_variables(plv))
    pg = PeakGenerator(TOT - 1, OLD - 1)
    pg.load_state_dict(convert_jax_variables(pgv))
    model.decoder.instance_decoder.aspp.project_drop = _RecordedDropout(keep)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    opt = schedule.make_optimizer(model, "sgd", group_scale=GROUPS)
    st = TrainState(model, opt, schedule.make_schedule("poly", LR, 100))
    port_step = make_phase2_train_step(model, model_old, pl, pg, OLD,
                                       device="cpu", **kw)
    got = port_step(st, {"image": torch.from_numpy(images),
                         "l1h": torch.from_numpy(l1h)})
    return {"want": want, "got": {k: v.numpy() for k, v in got.items()},
            "before": before, "after": model.state_dict(), "steps": st.step,
            "run_refine": request.param}


def test_phase2_step_metrics_match_jax(phase2_runs):
    """The factory fired (pseudo weight > 0); loss, l_center, l_offset
    within rtol 1e-4; label_truncated exact, and counting the refinement
    pass's truncated centers only with `run_refine`."""
    got, want = phase2_runs["got"], phase2_runs["want"]["metrics"]
    assert want["pseudo_weight_px"] > 0 and got["pseudo_weight_px"] > 0
    assert (want["label_truncated"] > 0) == phase2_runs["run_refine"]
    for k in ("loss", "l_center", "l_offset", "pseudo_weight_px"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["label_truncated"],
                                  want["label_truncated"])
    assert phase2_runs["steps"] == 1


def test_phase2_step_updates_instance_branch_as_jax(phase2_runs):
    """Instance parameters after one SGD step and the instance BN stats
    within 1e-5 (so the gradients match), and they did move."""
    after, before = phase2_runs["after"], phase2_runs["before"]
    want = phase2_runs["want"]["state"]
    moved = 0
    for k, w in want.items():
        if schedule.default_group_fn(k) != "instance":
            continue
        np.testing.assert_allclose(after[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
        moved += int((after[k] - before[k]).abs().max() > 1e-4)
    assert moved > 10


def test_phase2_step_leaves_body_and_seg_unchanged(phase2_runs):
    """Body and seg parameters and BN stats are bit for bit as they were,
    in the port and in JAX."""
    after, before = phase2_runs["after"], phase2_runs["before"]
    want = phase2_runs["want"]["state"]
    frozen = [k for k in before if schedule.default_group_fn(k) != "instance"]
    assert len(frozen) > 50
    for k in frozen:
        assert torch.equal(after[k], before[k]), k
        assert torch.equal(want[k], before[k]), k
