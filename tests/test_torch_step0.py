"""The port's step-0 slice (cl4wsis_tpu_torch: the target generation of
ops/labelgen, the training losses, the train-mode ASPP pooling and one
whole step-0 step) against the JAX package on the CPU, in float32, with
weights carried over by cl4wsis_tpu_torch.cl.ckpt.convert_jax_variables."""

from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl4wsis_tpu.models import CL4WSISModel
from cl4wsis_tpu.ops import labelgen as jlabelgen
from cl4wsis_tpu.train import losses as jlosses
from cl4wsis_tpu.train import schedule as jschedule
from cl4wsis_tpu.train.state import TrainState as JaxState
from cl4wsis_tpu.train.step0 import make_step0_train_step as jax_step0
from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables
from cl4wsis_tpu_torch.data.synthetic import synthetic_batches
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.ops import labelgen
from cl4wsis_tpu_torch.train import losses, schedule
from cl4wsis_tpu_torch.train.step0 import init_state, make_step0_train_step
from torch_one_thread import one_torch_thread  # noqa: F401

SIZE, BS, TINY = 64, 2, (1, 1, 1, 1)
CLASSES = (3,)             # background + 2 thing classes
# Every BN layer trains on batch statistics (E[x^2] - mean^2 in float32
# in JAX, the fused norm in the port), and the ASPP head's pooled branch
# normalises over the batch's 2 pooled values: the step is
# ill-conditioned in float32.
# So the step's update is held per parameter tensor, relative to JAX's
# (update_readings), at phase 2's learning rate: at it the JAX and port
# updates differ by at most 0.054 of JAX's (head.global_pooling_conv),
# while a detached l_center reads 1.0. The
# head's red_bn statistics, fed by that pooled branch, are held at 5e-4
# (float32 against float64 alone: 2.9e-4 there).
SIGMA, LR = 6, 1e-4
UPDATE_RTOL = 0.1
RED_BN_ATOL = 5e-4
GROUPS = {"body": 1.0, "seg": 1.0, "instance": 1.0, "pseudo": 0.0}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def update_readings(before, after, want):
    """For each parameter tensor (BN statistics left out): the distance
    between the port's update and JAX's, less the tensor's own float32
    rounding (the norm of its spacing), over the norm of JAX's update. A
    tensor JAX leaves unchanged reads 0 if the port's moves no further
    than that rounding, else inf."""
    out = {}
    for k, w in want.items():
        if "running" in k:
            continue
        d_jax = w.double() - before[k].double()
        err = float((after[k].double() - before[k].double() - d_jax).norm())
        floor = float(np.linalg.norm(
            np.spacing(np.abs(w.numpy())).astype(np.float64)))
        ref = float(d_jax.norm())
        out[k] = (max(err - floor, 0.0) / ref if ref > 0 else
                  0.0 if err <= floor else float("inf"))
    return out


# ------------------------------------------------------------- labelgen

def _masks(rs, B, H, W, n_inst, max_id):
    """Dense-id masks of random boxes (later boxes over earlier ones), ids
    1..max_id, some pixels 255 (ignore), classes 1..3 per instance."""
    inst = np.zeros((B, H, W), np.int32)
    seg = np.zeros((B, H, W), np.int32)
    for b in range(B):
        for k in range(1, n_inst + 1):
            y, x = rs.randint(0, H - 4), rs.randint(0, W - 4)
            h, w = rs.randint(3, H // 2), rs.randint(3, W // 2)
            kid = rs.randint(1, max_id + 1)
            inst[b, y:y + h, x:x + w] = kid
            seg[b, y:y + h, x:x + w] = 1 + kid % 3
    inst[:, :2, :3] = 255
    seg[:, :2, :3] = 255
    return inst, seg


@pytest.mark.parametrize("shape,max_inst,max_id", [
    ((3, 64, 72), 50, 12),          # ids within max_inst
    ((2, 48, 40), 5, 9),            # ids above max_inst
    ((1, 512, 512), 50, 3),         # coordinate sums past 2^24
])
def test_batched_instance_stats_equal_jax(shape, max_inst, max_id):
    """count, cy, cx and cls bit-equal to JAX's int32-exact batched
    stats, also where float32(sum) rounds (512 x 512)."""
    rs = np.random.RandomState(max_id)
    inst, seg = _masks(rs, *shape, n_inst=8, max_id=max_id)
    if shape[1] == 512:
        inst[0, 20:, 31:] = 2                # one instance of ~240k pixels
    want = jlabelgen.batched_instance_stats(jnp.asarray(inst),
                                            jnp.asarray(seg), max_inst)
    got = labelgen.batched_instance_stats(torch.from_numpy(inst),
                                          torch.from_numpy(seg), max_inst)
    for name, g, w in zip(("count", "cy", "cx", "cls"), got, want):
        assert g.shape == (shape[0], max_inst), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if shape[1] == 512:
        sy = int((np.nonzero(inst[0] == 2)[0]).sum())
        assert sy > 2 ** 24 and float(np.float32(sy)) != sy


@pytest.mark.parametrize("max_inst,max_id", [(50, 12), (6, 9)])
def test_batched_label_generation_matches_jax(max_inst, max_id):
    """Offsets and weights equal exactly (ids above max_inst read centroid
    0); centers within 1e-6 (JAX's exp against torch's)."""
    rs = np.random.RandomState(7 + max_inst)
    inst, seg = _masks(rs, 2, 64, 72, n_inst=9, max_id=max_id)
    C = 3
    jc, jo, jw = jax.jit(partial(jlabelgen.batched_label_generation,
                                 num_classes=C, sigma=SIGMA,
                                 max_inst=max_inst))(jnp.asarray(seg),
                                                     jnp.asarray(inst))
    c, o, w = labelgen.batched_label_generation(
        torch.from_numpy(seg), torch.from_numpy(inst), C, SIGMA, max_inst)
    assert c.shape == (2, C, 64, 72) and o.shape == (2, 2, 64, 72) and \
        w.shape == (2, 1, 64, 72)
    np.testing.assert_array_equal(_nhwc(o), np.asarray(jo))
    np.testing.assert_array_equal(_nhwc(w), np.asarray(jw))
    np.testing.assert_allclose(_nhwc(c), np.asarray(jc), rtol=0, atol=1e-6)
    assert float(c.max()) == pytest.approx(1.0, abs=1e-6)
    if max_id > max_inst:
        above = (inst > max_inst) & (inst != 255)
        assert above.any()
        ys = np.broadcast_to(np.arange(64)[:, None], inst.shape[1:])
        np.testing.assert_array_equal(o[:, 0].numpy()[above],
                                      -np.broadcast_to(ys, inst.shape)[above])


@pytest.mark.parametrize("max_inst,max_id", [(50, 12), (6, 9)])
def test_label_generation_per_sample_matches_jax(max_inst, max_id):
    """The per-image targets against the JAX per-image function: offsets
    and weights exact (an id above max_inst reads the last slot's
    centroid there), centers within 1e-6; stats exact where count > 0."""
    rs = np.random.RandomState(3 + max_id)
    inst, seg = _masks(rs, 1, 64, 72, n_inst=9, max_id=max_id)
    inst, seg = inst[0], seg[0]
    jc, jo, jw = jlabelgen.label_generation(
        jnp.asarray(seg), jnp.asarray(inst), num_classes=3, sigma=SIGMA,
        max_inst=max_inst)
    c, o, w = labelgen.label_generation(torch.from_numpy(seg),
                                        torch.from_numpy(inst), 3, SIGMA,
                                        max_inst)
    np.testing.assert_array_equal(o.permute(1, 2, 0).numpy(), np.asarray(jo))
    np.testing.assert_array_equal(w.permute(1, 2, 0).numpy(), np.asarray(jw))
    np.testing.assert_allclose(c.permute(1, 2, 0).numpy(), np.asarray(jc),
                               rtol=0, atol=1e-6)
    want = [np.asarray(a) for a in jlabelgen.instance_stats(
        jnp.asarray(inst), jnp.asarray(seg), max_inst)]
    got = [t.numpy() for t in labelgen.instance_stats(
        torch.from_numpy(inst), torch.from_numpy(seg), max_inst)]
    live = want[0] > 0
    assert live.sum() >= 3
    for name, g, wv in zip(("count", "cy", "cx", "cls"), got, want):
        np.testing.assert_array_equal(g[live], wv[live], err_msg=name)
    np.testing.assert_array_equal(got[0], want[0])


# ---------------------------------------------------------------- losses

def _logits_labels(seed, C=5, shape=(2, 6, 7)):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape, C) * 3).astype(np.float32)
    lab = rs.randint(0, C, shape).astype(np.int32)
    lab[rs.rand(*shape) < 0.2] = 255
    return rs, x, lab


def test_bce_with_logits_ignore_matches_jax():
    """(B, H, W) per-pixel loss within 1e-6; 0 at ignored pixels."""
    _, x, lab = _logits_labels(0)
    want = np.asarray(jlosses.bce_with_logits_ignore(x, lab))
    got = losses.bce_with_logits_ignore(_nchw(x), torch.from_numpy(lab))
    assert got.shape == lab.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got.numpy()[lab == 255] == 0).all()


@pytest.mark.parametrize("top_k_percent", [0.2, 1.0])
def test_deeplab_ce_matches_jax(top_k_percent):
    _, x, lab = _logits_labels(1, shape=(2, 16, 12))
    want = float(jlosses.deeplab_ce(x, lab, top_k_percent=top_k_percent))
    got = float(losses.deeplab_ce(_nchw(x), torch.from_numpy(lab),
                                  top_k_percent=top_k_percent))
    assert got == pytest.approx(want, rel=1e-6)


def _soft_pairs(seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(2, 6, 7, 5) * 3).astype(np.float32)
    t = rs.rand(2, 6, 7, 5).astype(np.float32)
    return rs, x, t


@pytest.mark.parametrize("name", ["bce_with_logits", "feature_distillation"])
def test_pairwise_losses_match_jax(name):
    _, x, t = _soft_pairs(2)
    want = float(getattr(jlosses, name)(x, t))
    got = float(getattr(losses, name)(_nchw(x), _nchw(t)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("old_cl", [1, 3])
def test_unbiased_ce_matches_jax(old_cl):
    _, x, lab = _logits_labels(3)
    want = float(jlosses.unbiased_ce(x, lab, old_cl))
    got = float(losses.unbiased_ce(_nchw(x), torch.from_numpy(lab), old_cl))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("fn", ["kd_loss", "unbiased_kd_loss"])
@pytest.mark.parametrize("masked", [False, True])
def test_kd_losses_match_jax(fn, masked):
    rs, x, _ = _soft_pairs(4)
    old = (rs.randn(2, 6, 7, 3) * 2).astype(np.float32)
    mask = (rs.rand(2, 6, 7) > 0.4).astype(np.float32) if masked else None
    want = float(getattr(jlosses, fn)(x, old, alpha=0.7, mask=mask))
    got = float(getattr(losses, fn)(
        _nchw(x), _nchw(old), alpha=0.7,
        mask=None if mask is None else torch.from_numpy(mask)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("bkg", [1.0, 0.3, -1.0])
def test_icarl_loss_matches_jax(bkg):
    rs, x, lab = _logits_labels(5)
    old = rs.rand(2, 6, 7, 3).astype(np.float32)
    want = float(jlosses.icarl_loss(x, lab, old, bkg=bkg))
    got = float(losses.icarl_loss(_nchw(x), torch.from_numpy(lab),
                                  _nchw(old), bkg=bkg))
    assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------- train-mode ASPP pool

def test_train_mode_forward_seg_matches_jax_off_crop():
    """A crop-64 model fed a 96 x 96 image in train mode: the ASPP pooled
    branch takes the global mean, as JAX does (the eval window of 4 would
    not span the 6 x 6 map). Seg logits and body features within 2e-3
    (batch statistics over 72 pixels of a random net magnify float32
    rounding; the eval window gives 1.16), the moved BN stats within
    1e-5 (head.red_bn's within RED_BN_ATOL)."""
    jm = CL4WSISModel(classes=(3, 2), pooling_size=64 // 16,
                      has_instance=False, backbone_structure=TINY)
    v = _np(jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    x = np.random.RandomState(1).randn(2, 96, 96, 3).astype(np.float32)
    (pred, feats), upd = jax.jit(partial(
        jm.apply, train=True, interpolate=False, method=jm.forward_seg,
        mutable=["batch_stats"]))(v, jnp.asarray(x))
    port = make_model((3, 2), "resnet101", 16, 64, branch="none",
                      backbone_structure=TINY)
    port.load_state_dict(convert_jax_variables(v))
    port.train()
    gpred, gfeats = port.forward_seg(_nchw(x), interpolate=False)
    assert set(gfeats) == set(feats) and gfeats["body"].shape[2:] == (6, 6)
    np.testing.assert_allclose(_nhwc(gpred["seg"]), np.asarray(pred["seg"]),
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(_nhwc(gfeats["body"]),
                               np.asarray(feats["body"]), rtol=0, atol=2e-3)
    sd = port.state_dict()
    for k, w in convert_jax_variables(
            {"batch_stats": _np(upd["batch_stats"])}).items():
        atol = RED_BN_ATOL if k.startswith("head.red_bn.") else 1e-5
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=k)


# ------------------------------------------------------------ whole step

def _train_dropout_keep(jm, variables, x, rng):
    """The kept mask of the ASPP projection's dropout in the JAX model's
    train-mode forward (the one the step runs), NHWC."""
    def fwd(v, x, rng):
        seen = {}

        def intercept(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.module.name == "project_drop":
                seen["out"] = out
            return out
        with fnn.intercept_methods(intercept):
            jm.apply(v, x, train=True, interpolate=False,
                     mutable=["batch_stats"], rngs={"dropout": rng})
        return seen["out"]
    return np.asarray(jax.jit(fwd)(variables, x, rng)) != 0


class _RecordedDropout(torch.nn.Module):
    """The JAX run's dropout mask, applied as flax applies it."""

    def __init__(self, keep_nhwc):
        super().__init__()
        self.keep = torch.from_numpy(keep_nhwc).permute(0, 3, 1, 2)

    def forward(self, x, generator=None):
        return torch.where(self.keep, x / 0.5, 0.0)


def _group(name):
    return jschedule.default_group_fn(name.split("/", 1)[1])


def _port_step(inputs, seg_loss):
    """One step-0 step of the port from the JAX weights, batch and
    dropout mask in `inputs`."""
    v, b, keep = inputs
    model = make_model(CLASSES, "resnet101", 16, SIZE,
                       backbone_structure=TINY)
    model.load_state_dict(convert_jax_variables(v))
    model.decoder.instance_decoder.aspp.project_drop = _RecordedDropout(keep)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    st = init_state(model, "sgd", schedule.make_schedule("poly", LR, 100),
                    group_scale=GROUPS)
    port_step = make_step0_train_step(model, seg_loss=seg_loss, sigma=SIGMA,
                                      device="cpu")
    got = port_step(st, {k: torch.from_numpy(b[k])
                         for k in ("image", "seg", "inst")})
    return {"steps": st.step, "got": {k: t.numpy() for k, t in got.items()},
            "before": before, "after": model.state_dict()}


@pytest.fixture(scope="module")
def step0_runs():
    """One step-0 step of the JAX package and of the port, from the same
    weights, batch and dropout mask, for each seg loss. SGD, whose update
    is linear in the gradient."""
    jm = CL4WSISModel(classes=CLASSES, pooling_size=SIZE // 16,
                      has_instance=True, backbone_structure=TINY)
    v = _np(jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    b = next(synthetic_batches(BS, SIZE, n_classes=CLASSES[0] - 1, seed=4))
    b["seg"][:, :3, :] = 255                      # an ignored band
    rng = jax.random.PRNGKey(5)
    keep = _train_dropout_keep(jm, v, jnp.asarray(b["image"]), rng)
    runs = {"inputs": (v, b, keep)}
    for seg_loss in ("bce", "dce"):
        params = {"model": v["params"]}
        tx = jschedule.make_optimizer(
            params, "sgd", jschedule.make_schedule("poly", LR, 100),
            group_scale=GROUPS, group_fn=_group)
        state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats={"model": v["batch_stats"]},
                         opt_state=tx.init(params))
        step = jax_step0(jm, tx, seg_loss=seg_loss, sigma=SIGMA, max_inst=50)
        new_state, metrics = step(
            state, {k: jnp.asarray(b[k]) for k in ("image", "seg", "inst")},
            rng)
        want = {"metrics": {k: np.asarray(m) for k, m in metrics.items()},
                "state": convert_jax_variables(
                    {"params": _np(new_state.params["model"]),
                     "batch_stats": _np(new_state.batch_stats["model"])})}
        runs[seg_loss] = {"want": want, **_port_step(runs["inputs"], seg_loss)}
    return runs


@pytest.mark.parametrize("seg_loss", ["bce", "dce"])
def test_step0_metrics_match_jax(step0_runs, seg_loss):
    """loss, l_seg, l_center and l_offset within rtol 1e-4; the center
    and offset terms are live."""
    run = step0_runs[seg_loss]
    got, want = run["got"], run["want"]["metrics"]
    for k in ("loss", "l_seg", "l_center", "l_offset"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["l_center"] > 0 and got["l_offset"] > 0
    assert run["steps"] == 1


def _check_updates(run):
    after, before, want = run["after"], run["before"], run["want"]["state"]
    assert set(want) == set(after)
    readings = update_readings(before, after, want)
    over = {k: r for k, r in readings.items() if not r <= UPDATE_RTOL}
    assert not over, over
    print(f"largest update reading {max(readings.values()):.4g}")
    moved = {"body": 0, "seg": 0, "instance": 0}
    for k, w in want.items():
        if "running" in k:
            atol = RED_BN_ATOL if k.startswith("head.red_bn.") else 1e-5
            np.testing.assert_allclose(after[k].numpy(), w.numpy(), rtol=0,
                                       atol=atol, err_msg=k)
        moved[schedule.default_group_fn(k)] += int(
            not torch.equal(after[k], before[k]))
    assert min(moved.values()) > 5, moved


def test_step0_updates_parameters_and_stats_as_jax(step0_runs):
    """After one bce step, every parameter tensor's update within
    UPDATE_RTOL of JAX's (update_readings), every BN statistic within 1e-5
    of JAX's (head.red_bn's within RED_BN_ATOL), and body, seg and
    instance tensors all moved."""
    _check_updates(step0_runs["bce"])


def test_step0_dce_updates_as_jax(step0_runs):
    """The same after one step of the hard-pixel CE."""
    _check_updates(step0_runs["dce"])


def test_step0_update_check_sees_a_detached_center(step0_runs, monkeypatch):
    """The update check has teeth: a port step whose l_center passes no
    gradient (its loss value unchanged) reads far above UPDATE_RTOL."""
    weighted_mse = losses.weighted_mse
    monkeypatch.setattr(losses, "weighted_mse",
                        lambda out, *a: weighted_mse(out.detach(), *a))
    run = _port_step(step0_runs["inputs"], "bce")
    want = step0_runs["bce"]["want"]
    np.testing.assert_allclose(run["got"]["l_center"],
                               want["metrics"]["l_center"], rtol=1e-4)
    readings = update_readings(run["before"], run["after"], want["state"])
    print(f"largest update reading {max(readings.values()):.4g}")
    assert max(readings.values()) > 5 * UPDATE_RTOL


def test_step0_semantic_only_and_no_card():
    """A model without the instance branch: the instance terms are 0 and
    the loss is l_seg. Asking for the card without one raises."""
    model = make_model(CLASSES, "resnet101", 16, SIZE, branch="none",
                       backbone_structure=TINY)
    st = init_state(model, "adam", schedule.make_schedule("poly", LR, 10))
    b = next(synthetic_batches(BS, SIZE, n_classes=2, seed=1))
    got = make_step0_train_step(model, device="cpu")(
        st, {k: torch.from_numpy(b[k]) for k in ("image", "seg", "inst")})
    assert float(got["l_center"]) == 0.0 and float(got["l_offset"]) == 0.0
    assert float(got["loss"]) == float(got["l_seg"]) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_step0_train_step(model)
