"""Step-0 runs of the painted-fixture protocol in the JAX package and in
the port, on the CPU (not a test: the runs take minutes).

    python tests/fixture_curves.py steps [--steps 120] [--depth full] \
        [--init torch]
    python tests/fixture_curves.py cli [--epochs 60] [--seed 42]
    python tests/fixture_curves.py carry [--depth full] \
        [--ckpt <the JAX runner's RB_0 checkpoint>] [--steps 24]
    python tests/fixture_curves.py layers [--depth full]
    python tests/fixture_curves.py cross --jax_root <dir> --port_root <dir>

``steps``: the ResNet-101 of ``--depth`` (``tiny``: one block a stage;
``full``: (3, 4, 23, 3)) from the same weights (``--init jax``: JAX's
flax init carried to the port; ``torch``: the port's torch init families
from ``--seed`` carried to JAX), the fixture's batches through the port's
loader, dropout off in both, the two step-0 train steps with the
protocol's optimizer and schedule; prints each step's losses and each
epoch's means. ``cli``: the protocol's step 0 through each package's CLI
(the JAX runner's flags, ``--tiny``, JAX with ``--torch_init``), each from
its own init; prints each package's per-epoch losses and final metrics
as JSON lines. ``carry``: a JAX train state part way through the protocol
(the runner's checkpoint at ``--ckpt``, else ``--steps`` JAX steps from
init) carried into the port with its Adam moments, count and step; one
step in each package on the next batch, dropout off; prints the update
readings of ``tests/test_torch_step0.update_readings`` and the moments'
relative errors, then the decoder dropout's keep rate and scale in each
package. ``layers``: the first step's forward from JAX's init, block by
block through the body and at the heads, JAX and the port in float32
against the port in float64, and the port with two-pass BN statistics.
``cross``: the final step-0 checkpoints of the JAX runner
(``scripts/run_rebuild_fixture.py --root``) and of the port's
(``--root``, one seed) at full depth, each carried into the other
package's checkpoint (weights, BN statistics, Adam's state, step), each
validated by both packages' CLIs (``--test``) on the JAX root's fixture.
Each run writes under a temporary directory.
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cl4wsis_tpu.cl.ckpt import convert_torch_cl4wsis  # noqa: E402
from cl4wsis_tpu.models import CL4WSISModel  # noqa: E402
from cl4wsis_tpu.train import schedule as jschedule  # noqa: E402
from cl4wsis_tpu.train.state import TrainState as JaxState  # noqa: E402
from cl4wsis_tpu.train.step0 import make_step0_train_step  # noqa: E402
from cl4wsis_tpu_torch.cl import tasks  # noqa: E402
from cl4wsis_tpu_torch.cl.ckpt import (convert_jax_adam,  # noqa: E402
                                       convert_jax_variables,
                                       load_adam_state)
from cl4wsis_tpu_torch.core import abn  # noqa: E402
from cl4wsis_tpu_torch.data.fixture import write_fake_voc  # noqa: E402
from cl4wsis_tpu_torch.data.loader import Loader  # noqa: E402
from cl4wsis_tpu_torch.data.voc import make_voc_datasets  # noqa: E402
from cl4wsis_tpu_torch.models import make_model  # noqa: E402
from cl4wsis_tpu_torch.models.panoptic import Dropout  # noqa: E402
from cl4wsis_tpu_torch.train import schedule  # noqa: E402
from cl4wsis_tpu_torch.train import step0 as port_step0  # noqa: E402

TINY = (1, 1, 1, 1)
DEPTHS = {"tiny": TINY, "full": (3, 4, 23, 3)}
BATCHES_PER_EPOCH, EPOCHS = 12, 250           # 48 images at batch 4
GROUPS = {"body": 1.0, "seg": 1.0, "instance": 1.0, "pseudo": 0.0}
KEYS = ("loss", "l_seg", "l_center", "l_offset")


def write_fixture(root):
    write_fake_voc(root, n_images=48, size=64, rich=True, wrap=True,
                   paint=True)


def fixture_batches(root, n_steps, first=0):
    """Step-0 batches `first` .. `first + n_steps - 1` of the protocol
    (seed 42)."""
    train, _ = make_voc_datasets(root, tasks.get_task_dict("voc", "15-5", 0),
                                 0, 64, 64, overlap=True, seed=42)
    loader = Loader(train, 4, seed=42, num_workers=0)
    out, epoch = [], first // BATCHES_PER_EPOCH
    skip = first - epoch * BATCHES_PER_EPOCH
    while len(out) < skip + n_steps:
        out += [{k: b[k].numpy() for k in ("image", "seg", "inst")}
                for b in loader.epoch(epoch)]
        epoch += 1
    return out[skip:skip + n_steps]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model(depth=TINY):
    return CL4WSISModel(classes=(16,), pooling_size=4, has_instance=True,
                        backbone_structure=depth)


def port_model(variables, depth=TINY):
    """The port's model from JAX `variables`, the decoder's dropout off."""
    model = make_model((16,), "resnet101", 16, 64, backbone_structure=depth)
    model.load_state_dict(convert_jax_variables(variables))
    model.decoder.instance_decoder.aspp.project_drop = NoDropout()
    return model


def init_variables(jm, init="jax", seed=42):
    """The weights both packages start from: JAX's flax init (``jax``) or
    the port's torch init families under `seed` (``torch``), as numpy
    trees of JAX's layout."""
    if init == "jax":
        return _np(jax.jit(jm.init, static_argnames="train")(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = make_model((16,), "resnet101", 16, 64,
                           backbone_structure=jm.backbone_structure)
    return _np(convert_torch_cl4wsis(
        {k: t.numpy() for k, t in model.state_dict().items()},
        abs_bn_weight=False))


def lr_schedule(port=False):
    mod = schedule if port else jschedule
    return mod.make_schedule("poly", 3e-4, EPOCHS * BATCHES_PER_EPOCH)


def jax_tx(params):
    return jschedule.make_optimizer(
        params, "adam", lr_schedule(), group_scale=GROUPS,
        group_fn=lambda p: jschedule.default_group_fn(p.split("/", 1)[1]))


def jax_fresh_state(variables):
    params = {"model": variables["params"]}
    tx = jax_tx(params)
    return tx, JaxState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats={"model": variables["batch_stats"]},
                        opt_state=tx.init(params))


def jax_checkpoint_state(path, depth):
    """The train state in the JAX runner's step-0 checkpoint at `path`
    (orbax), its optimizer state put back into the protocol's chain."""
    from cl4wsis_tpu.cl.ckpt import load_checkpoint
    s = load_checkpoint(path)["state"]
    jm = jax_model(depth)
    variables = {"params": s["params"]["model"],
                 "batch_stats": s["batch_stats"]["model"]}
    tx, fresh = jax_fresh_state(_np(variables))
    opt_state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(fresh.opt_state),
        jax.tree_util.tree_leaves(s["opt_state"]))
    return jm, tx, fresh.replace(step=jnp.asarray(s["step"]),
                                 opt_state=opt_state)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def jax_step(jm, tx):
    """JAX's jitted step-0 step of the protocol for model `jm` and
    optimizer `tx` (it compiles at its first call)."""
    return make_step0_train_step(jm, tx, seg_loss="bce", sigma=6,
                                 max_inst=50)


def jax_steps(step, state, batches, first=0):
    """JAX's step-0 `step` over `batches` from `state`, dropout off; the
    step of batch i draws from PRNGKey(first + i). Returns the losses and
    the last state."""
    out = []
    with fnn.intercept_methods(_no_dropout):
        for i, b in enumerate(batches):
            state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()},
                            jax.random.PRNGKey(first + i))
            out.append({k: float(m[k]) for k in KEYS})
    return out, state


def jax_losses(batches, depth=TINY, init="jax", seed=42):
    """JAX's step-0 losses from the init `init`; returns them and the
    init."""
    jm = jax_model(depth)
    v = init_variables(jm, init, seed)
    tx, state = jax_fresh_state(v)
    return jax_steps(jax_step(jm, tx), state, batches)[0], v


class NoDropout(torch.nn.Module):
    def forward(self, x, generator=None):
        return x


def port_losses(batches, variables, depth=TINY):
    """The port's step-0 losses from JAX's init `variables`."""
    model = port_model(variables, depth)
    st = port_step0.init_state(model, "adam", lr_schedule(port=True),
                               group_scale=GROUPS)
    step = port_step0.make_step0_train_step(model, "bce", sigma=6,
                                            max_inst=50, device="cpu")
    return [{k: float(v) for k, v in step(
        st, {k: torch.from_numpy(x) for k, x in b.items()}).items()
        if k in KEYS} for b in batches]


def carry_state(jax_state, depth=TINY):
    """A JAX step-0 train state -> the port's model and TrainState: the
    weights and BN statistics, Adam's moments and count, and the step."""
    model = port_model({"params": _np(jax_state.params["model"]),
                        "batch_stats": _np(jax_state.batch_stats["model"])},
                       depth)
    st = port_step0.init_state(model, "adam", lr_schedule(port=True),
                               group_scale=GROUPS)
    adam = jax_state.opt_state[0]
    load_adam_state(model, st.optimizer, convert_jax_adam(
        _np(adam.mu["model"]), _np(adam.nu["model"]), adam.count))
    st.step = int(jax_state.step)
    return model, st


def moments(optimizer, model):
    """The port's Adam state by state-dict key: (exp_avg, exp_avg_sq,
    step)."""
    out = {}
    for n, p in model.named_parameters():
        s = optimizer.state.get(p)
        if s:
            out[n] = (s["exp_avg"], s["exp_avg_sq"], float(s["step"]))
    return out


def carried_step(step, jax_state, batch, index, depth=TINY):
    """One step of each package from `jax_state` on `batch` (JAX's jitted
    `step` drawing from PRNGKey(index)), dropout off. Returns the two
    packages' losses, the per-tensor update readings, each moment's
    relative error per tensor and both step counts after the step."""
    from test_torch_step0 import update_readings
    model, st = carry_state(jax_state, depth)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    port_step = port_step0.make_step0_train_step(model, "bce", sigma=6,
                                                 max_inst=50, device="cpu")
    got = port_step(st, {k: torch.from_numpy(x) for k, x in batch.items()})
    want, new = jax_steps(step, jax_state, [batch], first=index)
    want_sd = convert_jax_variables(
        {"params": _np(new.params["model"]),
         "batch_stats": _np(new.batch_stats["model"])})
    readings = update_readings(before, model.state_dict(), want_sd)
    adam = new.opt_state[0]
    mu = convert_jax_variables({"params": _np(adam.mu["model"])})
    nu = convert_jax_variables({"params": _np(adam.nu["model"])})
    errs = {"exp_avg": {}, "exp_avg_sq": {}}
    steps = set()
    for k, (m, v, s) in moments(st.optimizer, model).items():
        for name, g, w in (("exp_avg", m, mu[k]), ("exp_avg_sq", v, nu[k])):
            ref = float(w.double().norm())
            errs[name][k] = (float((g.double() - w.double()).norm()) / ref
                             if ref > 0 else float(g.abs().max()))
        steps.add(s)
    return {"loss": (want[0]["loss"], float(got["loss"])),
            "readings": readings, "moments": errs,
            "steps": {"jax": int(new.step), "jax_adam_count":
                      int(adam.count), "port": st.step,
                      "port_adam": sorted(steps)}}


def dropout_stats(n=1 << 20, seed=0):
    """Keep rate and the kept values' scale of the decoder's dropout (p
    0.5) on `n` ones, in flax and in the port."""
    x = np.ones((1, 8, 8, n // 64), np.float32)
    y = np.asarray(fnn.Dropout(0.5).apply(
        {}, jnp.asarray(x), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(seed)}))
    d = Dropout(0.5).train()
    t = d(torch.ones(1, n // 64, 8, 8),
          torch.Generator().manual_seed(seed)).numpy()
    return {name: {"keep": float((a != 0).mean()),
                   "kept": sorted({float(v) for v in a[a != 0].ravel()})}
            for name, a in (("jax", y), ("port", t))}


def steps(a):
    depth = DEPTHS[a.depth]
    with tempfile.TemporaryDirectory() as root:
        write_fixture(root)
        batches = fixture_batches(root, a.steps)
    want, v = jax_losses(batches, depth, a.init, a.seed)
    got = port_losses(batches, v, depth)
    for i, (w, g) in enumerate(zip(want, got)):
        print(i, " ".join(f"{k} {w[k]:.5f}/{g[k]:.5f}" for k in KEYS))
    for e in range(a.steps // BATCHES_PER_EPOCH):
        sl = slice(e * BATCHES_PER_EPOCH, (e + 1) * BATCHES_PER_EPOCH)
        mw, mg = (np.mean([m["loss"] for m in ms[sl]]) for ms in (want, got))
        print(json.dumps({"epoch": e, "jax": round(float(mw), 4),
                          "port": round(float(mg), 4),
                          "port_over_jax": round(float(mg / mw), 4)}))


def carry(a):
    depth = DEPTHS[a.depth]
    if a.ckpt:
        jm, tx, state = jax_checkpoint_state(a.ckpt, depth)
    else:
        jm = jax_model(depth)
        tx, state = jax_fresh_state(init_variables(jm, a.init, a.seed))
    at = int(state.step)
    with tempfile.TemporaryDirectory() as root:
        write_fixture(root)
        batches = fixture_batches(root, a.steps + 1, first=at)
    step = jax_step(jm, tx)
    if not a.ckpt:
        _, state = jax_steps(step, state, batches[:-1], first=at)
        at += a.steps
    t = time.time()
    r = carried_step(step, state, batches[-1], at, depth)
    worst = sorted(r["readings"].items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "depth": a.depth, "from_step": at, "loss_jax_port": r["loss"],
        "max_update_reading": worst[0][1], "worst": worst,
        "n_tensors": len(r["readings"]),
        "max_moment_err": {k: max(v.values())
                           for k, v in r["moments"].items()},
        "steps_after": r["steps"], "wall_s": round(time.time() - t, 1)}))
    print(json.dumps({"dropout": dropout_stats()}))


def _port_blocks(model, seen):
    """Forward hooks recording each body block's and the body stem's
    output, by the flax module name."""
    hooks = [model.body.mod1.register_forward_hook(
        lambda m, i, o: seen.__setitem__("mod1", o))]
    for i in range(2, 6):
        for j, block in enumerate(getattr(model.body, f"mod{i}")):
            name = f"mod{i}_block{j + 1}"
            hooks.append(block.register_forward_hook(
                lambda m, inp, o, name=name: seen.__setitem__(name, o)))
    return hooks


def _two_pass_stats(xf):
    """Per-channel mean and biased variance by two passes (one rank)."""
    mean = xf.mean((0, 2, 3))
    var = torch.square(xf - mean[:, None, None]).mean((0, 2, 3))
    return mean, var, xf.new_tensor(float(xf.numel() // xf.shape[1]))


def layers(a):
    depth = DEPTHS[a.depth]
    with tempfile.TemporaryDirectory() as root:
        write_fixture(root)
        batch = fixture_batches(root, 1)[0]
    jm = jax_model(depth)
    v = init_variables(jm, a.init, a.seed)
    x = batch["image"]
    seen_jax = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        name = context.module.name
        if name and (name.startswith("mod") and "_block" in name or
                     name == "mod1_bn1") and \
                context.method_name == "__call__":
            seen_jax["mod1" if name == "mod1_bn1" else name] = out
        return out
    with fnn.intercept_methods(_no_dropout), \
            fnn.intercept_methods(record):
        (jpred, _), _ = jm.apply(v, jnp.asarray(x), train=True,
                                 interpolate=False, mutable=["batch_stats"])
    jax_out = {k: np.asarray(o).transpose(0, 3, 1, 2)
               for k, o in {**seen_jax, **jpred}.items()}
    runs = {}
    for name, dtype, stats in (("port32", torch.float32, None),
                               ("port64", torch.float64, None),
                               ("port32_two_pass", torch.float32,
                                _two_pass_stats)):
        model = port_model(v, depth).to(dtype).train()
        seen = {}
        hooks = _port_blocks(model, seen)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
        with torch.no_grad(), mock.patch.object(
                abn, "batch_stats", stats or abn.batch_stats):
            pred = model(xt, interpolate=False)
        for h in hooks:
            h.remove()
        runs[name] = {k: t.double().numpy()
                      for k, t in {**seen, **pred}.items()}
    ref = runs["port64"]
    for k in (k for k in ref if k in jax_out):
        r = float(np.linalg.norm(ref[k]))

        def rel(o):
            return float(np.linalg.norm(np.asarray(o, np.float64) -
                                        ref[k])) / r
        print(json.dumps({"at": k, "jax32_vs_64": rel(jax_out[k]),
                          "port32_vs_64": rel(runs["port32"][k]),
                          "two_pass32_vs_64": rel(runs["port32_two_pass"][k]),
                          "jax32_vs_port32": float(np.linalg.norm(
                              jax_out[k] - runs["port32"][k])) / r}))


def jax_ckpt_to_port(jax_path, port_path, depth=DEPTHS["full"]):
    """The JAX runner's step-0 checkpoint -> a checkpoint of the port's
    Trainer (weights, BN statistics, Adam's state, step and epoch)."""
    from cl4wsis_tpu.cl.ckpt import load_checkpoint
    from cl4wsis_tpu_torch.cl.ckpt import save_checkpoint
    _, _, state = jax_checkpoint_state(jax_path, depth)
    model, st = carry_state(state, depth)
    save_checkpoint(port_path, {
        "model": model.state_dict(), "optimizer": st.optimizer.state_dict(),
        "step": st.step, "epoch": int(load_checkpoint(jax_path)["epoch"])})


def port_ckpt_to_jax(port_path, jax_path, depth=DEPTHS["full"]):
    """A step-0 checkpoint of the port's Trainer -> one of the JAX
    Trainer's (orbax): weights, BN statistics, Adam's state and step."""
    from cl4wsis_tpu.cl.ckpt import save_checkpoint
    from cl4wsis_tpu_torch.cl.ckpt import load_checkpoint
    blob = load_checkpoint(port_path)
    model = make_model((16,), "resnet101", 16, 64, backbone_structure=depth)
    model.load_state_dict(blob["model"])
    st = port_step0.init_state(model, "adam", lr_schedule(port=True),
                               group_scale=GROUPS)
    st.optimizer.load_state_dict(blob["optimizer"])
    mom = moments(st.optimizer, model)

    def tree(i):
        return _np(convert_torch_cl4wsis(
            {k: m[i].numpy() for k, m in mom.items()},
            abs_bn_weight=False)["params"])
    variables = _np(convert_torch_cl4wsis(
        {k: t.numpy() for k, t in blob["model"].items()},
        abs_bn_weight=False))
    _, fresh = jax_fresh_state(variables)
    adam, empty, sched = fresh.opt_state
    count = jnp.asarray(int(blob["step"]), jnp.int32)
    state = fresh.replace(step=count, opt_state=(
        adam._replace(count=count, mu={"model": tree(0)},
                      nu={"model": tree(1)}),
        empty, sched._replace(count=count)))
    save_checkpoint(jax_path, {"state": jax.device_get(state),
                               "aux_vars": {}, "epoch": int(blob["epoch"])})


def cross(a):
    """Each package validates each package's final step-0 weights on the
    fixture's validation split, through its CLI's --test."""
    jax_runner = _load(os.path.join(REPO, "scripts/run_rebuild_fixture.py"),
                       "jax_fixture_runner")
    port_runner = _load(os.path.join(
        REPO, "scripts/run_rebuild_fixture_torch.py"), "port_fixture_runner")
    from cl4wsis_tpu.cli.main import main as jax_main
    from cl4wsis_tpu_torch.cli.main import main as port_main
    ckpt = os.path.join("rebuild_ckpt", "step", "voc-15-5-ov", "RB_0")
    ns = argparse.Namespace(batch=4, size=64, seed=a.seed, epochs=a.epochs,
                            cl_epochs=None, torch_init=True, lr0="3e-4",
                            device="cpu", tiny=False)
    with tempfile.TemporaryDirectory() as tmp:
        weights = {"jax": {"jax": os.path.join(a.jax_root, ckpt),
                           "port": os.path.join(tmp, "jax_as_port")},
                   "port": {"port": os.path.join(a.port_root, ckpt),
                            "jax": os.path.join(tmp, "port_as_jax")}}
        jax_ckpt_to_port(weights["jax"]["jax"], weights["jax"]["port"])
        port_ckpt_to_jax(weights["port"]["port"], weights["port"]["jax"])
        for trained in ("jax", "port"):
            for name, runner, main in (("jax", jax_runner, jax_main),
                                       ("port", port_runner, port_main)):
                root = os.path.join(tmp, f"{trained}_by_{name}")
                os.makedirs(root)
                os.symlink(os.path.join(os.path.abspath(a.jax_root), "data"),
                           os.path.join(root, "data"))
                argv = runner._stage_args("step0", ns, root) + [
                    "--test", "true", "--ckpt", weights[trained][name]]
                rc = main(argv)
                out = jax_runner._collect(os.path.join(root, "rebuild_logs"),
                                          "voc-15-5-ov", "RB")
                print(json.dumps({"weights": trained, "validated_by": name,
                                  "rc": rc, **out["final"]}), flush=True)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cli(a):
    jax_runner = _load(os.path.join(REPO, "scripts/run_rebuild_fixture.py"),
                       "jax_fixture_runner")
    port_runner = _load(os.path.join(
        REPO, "scripts/run_rebuild_fixture_torch.py"), "port_fixture_runner")
    ns = argparse.Namespace(batch=4, size=64, seed=a.seed, epochs=a.epochs,
                            cl_epochs=None, torch_init=True, lr0="3e-4",
                            device="cpu", tiny=False)
    from cl4wsis_tpu.cli.main import main as jax_main
    from cl4wsis_tpu_torch.cli.main import main as port_main
    for name, runner, main, extra in (
            ("port", port_runner, port_main, ["--tiny", "true",
                                              "--num_workers", "0"]),
            ("jax", jax_runner, jax_main, ["--tiny", "true"])):
        with tempfile.TemporaryDirectory() as root:
            write_fixture(os.path.join(root, "data"))
            t = time.time()
            rc = main(runner._stage_args("step0", ns, root) + extra)
            out = jax_runner._collect(os.path.join(root, "rebuild_logs"),
                                      "voc-15-5-ov", "RB")
        print(json.dumps({"package": name, "rc": rc, "seed": a.seed,
                          "wall_s": round(time.time() - t, 1), **out}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["steps", "cli", "carry", "layers",
                                     "cross"])
    ap.add_argument("--steps", type=int, default=120,
                    help="steps: steps to run; carry: JAX steps before "
                         "the carried one (without --ckpt)")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--depth", choices=list(DEPTHS), default="tiny")
    ap.add_argument("--init", choices=["jax", "torch"], default="jax")
    ap.add_argument("--ckpt", default=None,
                    help="carry: the JAX runner's step-0 checkpoint")
    ap.add_argument("--jax_root", default=None,
                    help="cross: the JAX runner's --root after step 0")
    ap.add_argument("--port_root", default=None,
                    help="cross: the port runner's --root after step 0")
    args = ap.parse_args()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    {"steps": steps, "cli": cli, "carry": carry, "layers": layers,
     "cross": cross}[args.what](args)
