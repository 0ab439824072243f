"""The multi-step protocols in the port against the JAX package on the CPU:
the classifier expansion chained over two incremental steps (VOC 10-5 and
15-1, with and without init_balanced) and one phase-2 step at VOC 10-5's
step 2, whose model has three classifier groups and whose old model has
two, at tests/test_torch_train.py's tiny size and tolerances."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from cl4wsis_tpu.cl import ckpt as jckpt
from cl4wsis_tpu.cl.ckpt import convert_torch_cl4wsis
from cl4wsis_tpu.models import CL4WSISModel
from cl4wsis_tpu.train import schedule as jschedule
from cl4wsis_tpu.train.phase2 import make_phase2_train_step as jax_phase2
from cl4wsis_tpu.train.state import TrainState as JaxState
from cl4wsis_tpu.wss import PeakGenerator as JaxPG
from cl4wsis_tpu.wss import PseudoLabeler as JaxPL
from cl4wsis_tpu_torch.cl import tasks
from cl4wsis_tpu_torch.cl.ckpt import (convert_jax_variables,
                                       expand_for_new_step)
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.ops.peaks import peak_extract_nchw, smoothing
from cl4wsis_tpu_torch.ops.resize import resize_bilinear
from cl4wsis_tpu_torch.train import schedule
from cl4wsis_tpu_torch.train.phase2 import make_phase2_train_step
from cl4wsis_tpu_torch.train.state import TrainState
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler
from tests.test_torch_train import (BETA, GROUPS, LR, NMS_KERNEL, SIGMA, SIZE,
                                    TINY, _nchw, _nhwc, _np, _RecordedDropout)
from torch_one_thread import one_torch_thread  # noqa: F401

# ------------------------------------------------- expansion, two steps


def port_and_jax(classes, seed, instance=True):
    """The tiny model of `classes` drawn by the port's init from `seed`,
    and the JAX model with the same weights (convert_torch_cl4wsis): no
    JAX init is compiled."""
    torch.manual_seed(seed)
    m = make_model(classes, "resnet101", 16, SIZE, backbone_structure=TINY,
                   branch="ins" if instance else "none")
    jm = CL4WSISModel(classes=tuple(classes), pooling_size=SIZE // 16,
                      has_instance=instance, backbone_structure=TINY)
    v = convert_torch_cl4wsis({k: t.numpy() for k, t in
                               m.state_dict().items()}, abs_bn_weight=False)
    return m, jm, _np(v)


@pytest.fixture(scope="module", params=["10-5", "15-1"])
def step_trees(request):
    """Fresh weights of the step-0, step-1 and step-2 models of a task (the
    tiny ResNet with the instance branch, the port's init from seeds 0, 1
    and 2): the JAX trees of numpy arrays and the port's state dicts."""
    classes = tasks.get_per_task_classes("voc", request.param, 2)
    models = [port_and_jax(classes[:s + 1], s) for s in range(3)]
    return (request.param, [v for _, _, v in models],
            [m.state_dict() for m, _, _ in models])


@pytest.mark.parametrize("init_balanced", [False, True])
def test_expand_for_new_step_twice_matches_jax(step_trees, init_balanced):
    """Step 0 -> step 1 -> step 2 through expand_for_new_step: the port's
    state dict equals JAX's converted tree within 1e-6, it has the three
    classifier groups and the three center groups, the body and the
    offset classifier come from step 0, each new group from its step's
    fresh weights, or with init_balanced from its group 0's background
    row."""
    task, trees, sd = step_trees
    want, got = trees[0], sd[0]
    for step in (1, 2):
        classes = tasks.get_per_task_classes("voc", task, step)
        want = jckpt.expand_for_new_step(trees[step], want, classes,
                                         init_balanced=init_balanced)
        got = expand_for_new_step(sd[step], got, classes,
                                  init_balanced=init_balanced)
    want = convert_jax_variables(_np(want))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert float((got[k] - w).abs().max()) <= 1e-6, k
    n_new = tasks.get_per_task_classes("voc", task, 2)[-1]
    center = "instance_head.classifier.center.cls."
    for prefix in ("cls.", center):
        assert got[f"{prefix}2.weight"].shape[0] == n_new
    for k in ("body.mod1.conv1.weight",
              "instance_head.classifier.offset.cls.0.weight"):
        assert torch.equal(got[k], sd[0][k]), k
    if not init_balanced:
        for g in (1, 2):
            for prefix in ("cls.", center):
                k = f"{prefix}{g}.weight"
                assert torch.equal(got[k], sd[g][k]), k
    else:
        for prefix in ("cls.", center):
            w0 = got[f"{prefix}0.weight"][:1]
            assert torch.equal(got[f"{prefix}2.weight"],
                               w0.expand_as(got[f"{prefix}2.weight"]))
            assert torch.equal(got[f"{prefix}2.bias"][:1],
                               got[f"{prefix}0.bias"][:1])


# ------------------------------------------ phase 2 at VOC 10-5, step 2

# the tiny stand-in of 10-5's step 2: 3 + 2 classes before, 2 new
CLASSES = (3, 2, 2)
TOT = sum(CLASSES)
OLD = TOT - CLASSES[-1]
BS = 2


def wss_to_jax(module):
    """The JAX variables of a port PseudoLabeler or PeakGenerator (its
    layers keep their flax names)."""
    params, stats = {}, {}
    for k, t in module.state_dict().items():
        layer, field = k.split(".")
        a = t.numpy().copy()
        if field == "weight" and a.ndim == 4:
            params.setdefault(layer, {})["kernel"] = a.transpose(2, 3, 1, 0)
        elif field in ("weight", "bias"):
            params.setdefault(layer, {})[
                "scale" if field == "weight" else "bias"] = a
        else:
            stats.setdefault(layer, {})[
                {"running_mean": "mean", "running_var": "var"}[field]] = a
    return {"params": params, "batch_stats": stats}


def dropout_keep(jm, variables, feats, rng):
    """The kept mask (NHWC) of JAX's ASPP projection dropout in the train
    mode instance forward on `feats` (NHWC) under `rng`, from one jitted
    forward that returns the dropout's output."""
    @jax.jit
    def run(v, f):
        seen = {}

        def intercept(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.module.name == "project_drop":
                seen["out"] = out
            return out

        with fnn.intercept_methods(intercept):
            jm.apply(v, f, train=True, method=jm.forward_instance,
                     mutable=["batch_stats"], rngs={"dropout": rng})
        return seen["out"] != 0
    return np.asarray(run(variables, feats))


@pytest.fixture(scope="module")
def step2_run():
    """One phase-2 step of JAX and of the port from the same weights,
    batch and dropout mask, with tests/test_torch_train.py's surgery:
    pseudo_thresh between the top two CAM peaks of the best-separated new
    class, that class's seg bias raised in the newest group, the newest
    group's center biases lifted. SGD, with the refinement mix."""
    model, jm, mv = port_and_jax(CLASSES, 0)
    model_old, jmo, ov = port_and_jax(CLASSES[:2], 1)
    jpl, jpg = JaxPL(num_classes=TOT), JaxPG(num_classes=TOT - 1,
                                             old_classes=OLD - 1)
    rs = np.random.RandomState(3)
    images = rs.randn(BS, SIZE, SIZE, 3).astype(np.float32) * 0.5
    l1h = np.zeros((BS, TOT - 1), np.float32)
    l1h[:, 0] = 1.0
    l1h[:, OLD - 1:] = 1.0
    rng = jax.random.PRNGKey(11)

    # the surgery's CAM peaks through the port (held to JAX's elsewhere):
    # the first draw of the weak-supervision modules whose CAM does not
    # saturate, so that a new class has two distinct top peaks
    model.eval()
    with torch.no_grad():
        _, feats = model.forward_seg(_nchw(images), interpolate=False)
    new_cls = list(range(OLD - 1, TOT - 1))
    for seed in range(8):
        torch.manual_seed(seed)
        pl, pg = PseudoLabeler(TOT).eval(), PeakGenerator(TOT - 1,
                                                          OLD - 1).eval()
        with torch.no_grad():
            pg.extra_conv4.bias += 0.5
            _, cam = pg(pl(feats["body"]), label=torch.from_numpy(l1h))
            cam = resize_bilinear(smoothing(cam), (SIZE, SIZE))
            conf2 = peak_extract_nchw(cam, kernel=NMS_KERNEL, k=2)[0].numpy()
        gaps = conf2[:, new_cls, 0] - conf2[:, new_cls, 1]
        if gaps.max() > 0.1:
            break
    aux = {"pseudolabeler": wss_to_jax(pl), "peakgenerator": wss_to_jax(pg)}
    bstar, ci = np.unravel_index(int(np.argmax(gaps)), gaps.shape)
    cstar = new_cls[int(ci)]
    pseudo_thresh = float(conf2[bstar, cstar, :2].mean())
    center = model.instance_head.classifier.center.cls[2]
    with torch.no_grad():
        model.cls[2].bias[cstar - (OLD - 1)] += 10.0
        center.bias += 0.5
    mv["params"]["cls"]["cls_2"]["bias"] = model.cls[2].bias.detach().numpy(
    ).copy()
    mv["params"]["instance_head"]["center_cls_2"]["bias"] = (
        center.bias.detach().numpy().copy())

    keep = dropout_keep(jm, mv, {k: _nhwc(v) for k, v in
                                 feats["features"].items()}, rng)

    params = {"model": mv["params"]}
    stats = {"model": mv["batch_stats"]}
    tx = jschedule.make_optimizer(
        params, "sgd", jschedule.make_schedule("poly", LR, 100),
        group_scale=GROUPS,
        group_fn=lambda p: jschedule.default_group_fn(p.split("/", 1)[1]))
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=stats, opt_state=tx.init(params))
    kw = dict(sigma=SIGMA, pseudo_thresh=pseudo_thresh, refine_thresh=0.3,
              nms_kernel=NMS_KERNEL, beta=BETA, run_refine=True)
    step = jax_phase2(jm, jmo, jpl, jpg, tx, old_classes=OLD, cc_iters=64,
                      **kw)
    batch = {"image": jnp.asarray(images), "l1h": jnp.asarray(l1h)}
    new_state, metrics = step(state, batch, ov, aux, rng)
    want = {"metrics": {k: np.asarray(m) for k, m in metrics.items()},
            "state": convert_jax_variables(
                {"params": _np(new_state.params["model"]),
                 "batch_stats": _np(new_state.batch_stats["model"])})}

    model.decoder.instance_decoder.aspp.project_drop = _RecordedDropout(keep)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    opt = schedule.make_optimizer(model, "sgd", group_scale=GROUPS)
    st = TrainState(model, opt, schedule.make_schedule("poly", LR, 100))
    port_step = make_phase2_train_step(model, model_old, pl, pg, OLD,
                                       device="cpu", **kw)
    got = port_step(st, {"image": torch.from_numpy(images),
                         "l1h": torch.from_numpy(l1h)})
    return {"want": want, "got": {k: v.numpy() for k, v in got.items()},
            "before": before, "after": model.state_dict()}


def test_step2_phase2_metrics_match_jax(step2_run):
    """The factory fired on the newest group's class; loss, l_center,
    l_offset and the pseudo weight within rtol 1e-4, label_truncated
    exact."""
    got, want = step2_run["got"], step2_run["want"]["metrics"]
    assert want["pseudo_weight_px"] > 0 and got["pseudo_weight_px"] > 0
    for k in ("loss", "l_center", "l_offset", "pseudo_weight_px"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["label_truncated"],
                                  want["label_truncated"])


def test_step2_phase2_updates_as_jax(step2_run):
    """Instance parameters after one SGD step and the instance BN
    statistics within 1e-5 of JAX's, the newest group's center classifier
    among those that moved; body and seg bit for bit as they were."""
    after, before = step2_run["after"], step2_run["before"]
    want = step2_run["want"]["state"]
    assert {"cls.2.weight", "instance_head.classifier.center.cls.2.weight"} \
        <= set(want)
    moved = 0
    for k, w in want.items():
        if schedule.default_group_fn(k) != "instance":
            assert torch.equal(after[k], before[k]), k
            assert torch.equal(w, before[k]), k
            continue
        np.testing.assert_allclose(after[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
        moved += int((after[k] - before[k]).abs().max() > 1e-4)
    assert moved > 10
    k = "instance_head.classifier.center.cls.2.weight"
    assert not torch.equal(after[k], before[k]), k
