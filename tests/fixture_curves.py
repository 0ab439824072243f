"""Step-0 loss curves of the painted-fixture protocol in the JAX package
and in the port, on the CPU (not a test: the curves take minutes).

    python tests/fixture_curves.py steps [--steps 120]
    python tests/fixture_curves.py cli [--epochs 60] [--seed 42]

``steps``: the tiny ResNet-101 (one block a stage) from the same weights
(JAX's init, carried to the port), the fixture's batches through the
port's loader, dropout off in both, the two step-0 train steps with the
protocol's optimizer and schedule; prints each step's losses and each
epoch's means. ``cli``: the protocol's step 0 through each package's CLI
(the JAX runner's flags, ``--tiny``, JAX with ``--torch_init``), each from
its own init; prints each package's per-epoch losses and final metrics
as JSON lines. Each run writes under a temporary directory.
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cl4wsis_tpu.models import CL4WSISModel  # noqa: E402
from cl4wsis_tpu.train import schedule as jschedule  # noqa: E402
from cl4wsis_tpu.train.state import TrainState as JaxState  # noqa: E402
from cl4wsis_tpu.train.step0 import make_step0_train_step  # noqa: E402
from cl4wsis_tpu_torch.cl import tasks  # noqa: E402
from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables  # noqa: E402
from cl4wsis_tpu_torch.data.fixture import write_fake_voc  # noqa: E402
from cl4wsis_tpu_torch.data.loader import Loader  # noqa: E402
from cl4wsis_tpu_torch.data.voc import make_voc_datasets  # noqa: E402
from cl4wsis_tpu_torch.models import make_model  # noqa: E402
from cl4wsis_tpu_torch.train import schedule  # noqa: E402
from cl4wsis_tpu_torch.train import step0 as port_step0  # noqa: E402

TINY = (1, 1, 1, 1)
BATCHES_PER_EPOCH, EPOCHS = 12, 250           # 48 images at batch 4
GROUPS = {"body": 1.0, "seg": 1.0, "instance": 1.0, "pseudo": 0.0}
KEYS = ("loss", "l_seg", "l_center", "l_offset")


def write_fixture(root):
    write_fake_voc(root, n_images=48, size=64, rich=True, wrap=True,
                   paint=True)


def fixture_batches(root, n_steps):
    """The first `n_steps` step-0 batches of the protocol (seed 42)."""
    train, _ = make_voc_datasets(root, tasks.get_task_dict("voc", "15-5", 0),
                                 0, 64, 64, overlap=True, seed=42)
    loader = Loader(train, 4, seed=42, num_workers=0)
    out, epoch = [], 0
    while len(out) < n_steps:
        out += [{k: b[k].numpy() for k in ("image", "seg", "inst")}
                for b in loader.epoch(epoch)]
        epoch += 1
    return out[:n_steps]


def jax_losses(batches):
    """JAX's step-0 losses from its own init; returns them and the init."""
    jm = CL4WSISModel(classes=(16,), pooling_size=4, has_instance=True,
                      backbone_structure=TINY)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    params = {"model": v["params"]}
    tx = jschedule.make_optimizer(
        params, "adam", jschedule.make_schedule(
            "poly", 3e-4, EPOCHS * BATCHES_PER_EPOCH), group_scale=GROUPS,
        group_fn=lambda p: jschedule.default_group_fn(p.split("/", 1)[1]))
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats={"model": v["batch_stats"]},
                     opt_state=tx.init(params))
    step = make_step0_train_step(jm, tx, seg_loss="bce", sigma=6,
                                 max_inst=50)

    def no_dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            return args[0]
        return next_fun(*args, **kwargs)
    out = []
    with fnn.intercept_methods(no_dropout):
        for i, b in enumerate(batches):
            state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()},
                            jax.random.PRNGKey(i))
            out.append({k: float(m[k]) for k in KEYS})
    return out, v


class NoDropout(torch.nn.Module):
    def forward(self, x, generator=None):
        return x


def port_losses(batches, variables):
    """The port's step-0 losses from JAX's init `variables`."""
    model = make_model((16,), "resnet101", 16, 64, backbone_structure=TINY)
    model.load_state_dict(convert_jax_variables(variables))
    model.decoder.instance_decoder.aspp.project_drop = NoDropout()
    st = port_step0.init_state(model, "adam", schedule.make_schedule(
        "poly", 3e-4, EPOCHS * BATCHES_PER_EPOCH), group_scale=GROUPS)
    step = port_step0.make_step0_train_step(model, "bce", sigma=6,
                                            max_inst=50, device="cpu")
    return [{k: float(v) for k, v in step(
        st, {k: torch.from_numpy(x) for k, x in b.items()}).items()
        if k in KEYS} for b in batches]


def steps(a):
    with tempfile.TemporaryDirectory() as root:
        write_fixture(root)
        batches = fixture_batches(root, a.steps)
    want, v = jax_losses(batches)
    got = port_losses(batches, v)
    for i, (w, g) in enumerate(zip(want, got)):
        print(i, " ".join(f"{k} {w[k]:.5f}/{g[k]:.5f}" for k in KEYS))
    for e in range(a.steps // BATCHES_PER_EPOCH):
        sl = slice(e * BATCHES_PER_EPOCH, (e + 1) * BATCHES_PER_EPOCH)
        mw, mg = (np.mean([m["loss"] for m in ms[sl]]) for ms in (want, got))
        print(json.dumps({"epoch": e, "jax": round(float(mw), 4),
                          "port": round(float(mg), 4),
                          "port_over_jax": round(float(mg / mw), 4)}))


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
    ap.add_argument("what", choices=["steps", "cli"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    (steps if args.what == "steps" else cli)(args)
