"""Run the painted-fixture protocol through the PyTorch port's CLI
(``cl4wsis_tpu_torch.cli.main``): step 0 (supervised BCE, Adam) ->
phase 1 (CAM, SGD) -> phase 2 (instance, Adam) on a mini-VOC of painted
objects, and print one JSON line per stage with the per-epoch loss
trajectory, the metrics of every validation and the final ones. It is the
counterpart of ``scripts/run_rebuild_fixture.py`` (the JAX package's
runner): the same fixture, the same stage flags, the same JSON keys.

    python scripts/run_rebuild_fixture_torch.py --paint --wrap --images 48 \
        --epochs 250 --cl_epochs 100 --lr0 3e-4 --seeds 42 43  # the card
    python scripts/run_rebuild_fixture_torch.py --tiny --device cpu \
        --paint --wrap --images 8 --epochs 1            # a CPU rehearsal

``--epochs`` is step 0's; phase 1 and phase 2 run ``--cl_epochs`` epochs
(default: the same). ``--seeds`` runs the protocol once for each seed
under ``<root>/s<seed>``. ``--torch_init`` starts the fresh layers in
torch's init families, as the protocol does, and without it they start in
flax's, as in the JAX runner. ``--tiny`` cuts the model
to a ResNet-18 of one block a stage and loads in this process.
``--no_tf32`` turns TensorFloat-32 off in cuDNN's convolutions (PyTorch
allows it there by default) and in matmuls; each record says which. The
Logger's JSONL is the record: wandb, where installed, is kept out of the
runs.
"""

import argparse
import contextlib
import glob
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NAMES = {"step0": "RB", "phase1": "RB1", "phase2": "RB2"}
TASK_DIR = "voc-15-5-ov"
TINY = ["--tiny", "true", "--backbone", "resnet18", "--num_workers", "0"]


def _stage_args(stage, a, root):
    """The JAX runner's flags for `stage`, flag for flag, then the port's
    ``--device`` (and the ``--tiny`` cut)."""
    epochs = a.epochs if stage == "step0" else (a.cl_epochs or a.epochs)
    common = [
        "--dataset", "voc", "--task", "15-5", "--overlap", "true",
        "--batch_size", str(a.batch), "--crop_size", str(a.size),
        "--crop_size_val", str(a.size), "--val_interval", "100",
        "--random_seed", str(a.seed), "--no_pretrained", "true",
        "--data_root", os.path.join(root, "data"),
        "--checkpoint", os.path.join(root, "rebuild_ckpt"),
        "--logdir", os.path.join(root, "rebuild_logs"),
        "--dtype", "float32", "--sample_num", "0",
        "--epochs", str(epochs),
        "--ckpt_interval", str(max(1, epochs // 3)),
    ]
    if a.torch_init:
        common += ["--torch_init", "true"]
    port = ["--device", a.device] + (TINY if a.tiny else [])
    if stage == "step0":
        return common + ["--step", "0", "--name", "RB", "--bce", "true",
                         "--optim", "adam", "--lr", a.lr0,
                         "--weight_decay", "0"] + port
    ckpt0 = os.path.join(root, "rebuild_ckpt", "step", TASK_DIR, "RB_0")
    stage1 = ["--step", "1", "--weakly", "true", "--alpha", "0.5",
              "--step_ckpt", ckpt0, "--loss_de", "1",
              "--lr_policy", "warmup", "--affinity", "true",
              "--pseudo_ep", "1"]
    if stage == "phase1":
        return common + stage1 + ["--name", "RB1", "--phase", "1",
                                  "--optim", "sgd", "--lr", "1e-3"] + port
    ckpt1 = os.path.join(root, "rebuild_ckpt", "step", TASK_DIR, "RB1_1")
    return common + stage1 + ["--name", "RB2", "--phase", "2",
                              "--optim", "adam", "--lr", "5e-5",
                              "--weight_decay", "0",
                              "--seg_ckpt", ckpt1] + port


def _collect(logdir, task_name, name):
    """Per-epoch losses and final metrics from the Logger JSONL (the JAX
    runner's keys), plus the metrics of each validation in order ("vals")
    and the median over the epochs after the first of an epoch's host
    seconds per batch, in ms ("step_ms")."""
    out = {"loss": [], "final": {}, "vals": [], "step_ms": None}
    per_batch = []
    for p in sorted(glob.glob(os.path.join(logdir, task_name, name,
                                           "*.jsonl"))):
        with open(p) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("type") == "epoch" and "Loss/loss" in rec:
                    out["loss"].append(round(float(rec["Loss/loss"]), 4))
                    per_batch.append(rec["epoch_time_s"] / rec["n_batches"])
                got = {}
                for k in ("map", "map50", "Mean IoU", "Mean Acc"):
                    if k in rec:
                        got[k] = (round(float(rec[k]), 4)
                                  if not isinstance(rec[k], list)
                                  else rec[k])
                out["final"].update(got)
                if got:
                    out["vals"].append(got)
    if per_batch:
        times = sorted(per_batch[1:] or per_batch)
        mid = len(times) // 2
        out["step_ms"] = 1e3 * (times[mid] if len(times) % 2 else
                                (times[mid - 1] + times[mid]) / 2)
    return out


@contextlib.contextmanager
def without_wandb():
    """While open, ``import wandb`` fails, so the CLI's Logger writes only
    its JSONL and starts no offline wandb run (a service process a
    stage)."""
    missing = object()
    saved = sys.modules.get("wandb", missing)
    sys.modules["wandb"] = None
    try:
        yield
    finally:
        if saved is missing:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved


def write_fixture(a, root):
    """The painted mini-VOC under ``root/data``, unless it is there."""
    from cl4wsis_tpu_torch.data.fixture import write_fake_voc
    fixture = os.path.join(root, "data")
    if not os.path.exists(os.path.join(fixture, "voc",
                                       "pascal_sbd_train.json")):
        write_fake_voc(fixture, n_images=a.images, size=a.size, rich=True,
                       wrap=a.wrap, paint=a.paint)
        print(f"fixture: wrote mini-VOC ({a.images} imgs @ {a.size}^2, "
              f"paint={a.paint}) to {fixture}", flush=True)


def run_seed(a, root, on_trainer=None, extra=None):
    """The stages of `a` for seed ``a.seed`` under `root`: one record a
    stage, printed as a JSON line as it ends; stops at the first stage
    whose rc is not 0. `extra` (stage -> flags) is appended to a stage's
    flags and `on_trainer` goes to ``cli.main``."""
    import torch
    from cl4wsis_tpu_torch.cli.main import main as cli_main
    write_fixture(a, root)
    tf32 = {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}
    stages = [a.stage] if a.stage != "all" else ["step0", "phase1", "phase2"]
    records = []
    for stage in stages:
        argv = _stage_args(stage, a, root) + (extra or {}).get(stage, [])
        print(f"=== port {stage}, seed {a.seed}: starting ===", flush=True)
        t0 = time.time()
        with without_wandb():
            rc = cli_main(argv, on_trainer=on_trainer)
        rec = {"stage": stage, "seed": a.seed, "rc": rc,
               "wall_s": round(time.time() - t0, 1), "tf32": tf32}
        rec.update(_collect(os.path.join(root, "rebuild_logs"), TASK_DIR,
                            NAMES[stage]))
        print(json.dumps(rec), flush=True)
        records.append(rec)
        if rc != 0:
            break
    return records


def get_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="tmp/fixture_run")
    ap.add_argument("--stage", default="all",
                    choices=["step0", "phase1", "phase2", "all"])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--cl_epochs", type=int, default=None,
                    help="epochs of phase 1 and phase 2 (default --epochs)")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="run the protocol for each seed, under root/s<seed>")
    ap.add_argument("--torch_init", action="store_true",
                    help="fresh layers in torch's init families, not flax's")
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--wrap", action="store_true")
    ap.add_argument("--paint", action="store_true",
                    help="learnable fixture: class-colored painted objects")
    ap.add_argument("--lr0", default="5e-5", help="step-0 lr")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu")
    ap.add_argument("--no_tf32", action="store_true",
                    help="float32 convolutions and matmuls without TF32")
    ap.add_argument("--tiny", action="store_true",
                    help="a ResNet-18 of one block a stage, loading in "
                         "this process (CPU rehearsals)")
    return ap


def main(argv=None):
    a = get_parser().parse_args(argv)
    if a.no_tf32:
        import torch
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if not a.seeds:
        return 0 if all(r["rc"] == 0 for r in run_seed(a, a.root)) else 1
    rc = 0
    for seed in a.seeds:
        a.seed = seed
        recs = run_seed(a, os.path.join(a.root, f"s{seed}"))
        rc = rc or next((r["rc"] for r in recs if r["rc"] != 0), 0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
