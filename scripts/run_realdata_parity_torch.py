"""The real-data accuracy-parity kit of the PyTorch port: the counterpart of
``scripts/run_realdata_parity.py`` through ``cl4wsis_tpu_torch.cli.main``.

GIVEN real data and the iABN ImageNet checkpoints, it runs the three stages
of the paper's recipe (``scripts/run.sh``, ``scripts/coco.sh``) through the
port's CLI on the card, reads each stage's mask mAP from the CLI's output
and from the Logger's JSONL, and, with ``--against``, tabulates mask AP50
against a JSON that either kit wrote, with BASELINE.md's 0.5-pt gate.

The default action is ``--run check``: the readiness check. It lists every
input the recipe reads with OK / MISSING, opens the ImageNet checkpoint
through the port's own loader (``cl/ckpt.load_torch_pretrained``) and holds
it to the body the step-0 trainer builds (ResNet-101 for VOC, WideResNet-38
A2 for ``coco-voc``, on the ``meta`` device): the file is ready only if it
gives every ``body.*`` key with its shape, since the trainer starts from
scratch without a word when the file is missing or its keys do not match.
It then prints the port's stage commands and upstream's native ones.

    python scripts/run_realdata_parity_torch.py --data_root /data --task 15-5
    python scripts/run_realdata_parity_torch.py --data_root /data \
        --task 15-5 --run port --workdir /scratch/parity \
        --out logs/realdata_15-5_torch.json \
        --against logs/realdata_15-5.json --against_side rebuild

Run it from the repository's root. ``--nproc_per_node N`` runs each stage
over N cards under ``torch.distributed.run`` at ``--batch_size 16/N`` a
process (the JAX CLI's one process spans every local device);
``--epochs_scale 0.01`` is the smoke mode (one epoch a stage). The port
imports nothing of the JAX package; neither does this script.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shlex
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cl4wsis_tpu_torch.cl import tasks  # noqa: E402
from cl4wsis_tpu_torch.cl.ckpt import load_torch_pretrained  # noqa: E402
from cl4wsis_tpu_torch.cli.config import parse_config  # noqa: E402
from cl4wsis_tpu_torch.models import make_model  # noqa: E402
from cl4wsis_tpu_torch.train.trainer import (model_kwargs,  # noqa: E402
                                             pretrained_name)

PORT_MODULE = "cl4wsis_tpu_torch.cli.main"
TASKS = ("15-5", "10-10", "10-5", "coco-voc")
GLOBAL_BATCH = 16
# flags that set where the stages write and read each other's checkpoints:
# --stage_args may not move them
PATH_FLAGS = ("--checkpoint", "--logdir", "--name", "--step_ckpt",
              "--seg_ckpt", "--data_root", "--pretrained_path", "--step",
              "--phase", "--dataset", "--task", "--overlap")
LISTED = 20                                 # names listed of each kind

# ------------------------------------------------------------- requirements


def requirements(task: str, data_root: str, pretrained_dir: str,
                 backbone: str = None):
    """(label, path, needed_by) rows of what the recipe reads: the JAX
    kit's rows, "both" for what the port and upstream's reference read,
    "reference" for what the reference alone reads. The ImageNet file is
    the one the step-0 trainer looks for, `pretrained_name(backbone)`
    (the recipe's backbone by default)."""
    v = os.path.join(data_root, "voc")
    c = os.path.join(data_root, "coco")
    rows = []
    if task in ("15-5", "10-10", "10-5"):
        rows += [
            ("VOC/SBD images", os.path.join(v, "JPEGImages"), "both"),
            ("SBD-coco train json", os.path.join(v, "pascal_sbd_train.json"), "both"),
            ("SBD-coco val json", os.path.join(v, "pascal_sbd_val.json"), "both"),
            ("split list (train)", os.path.join(v, "splits", "train_aug.txt"), "reference"),
            ("split list (val)", os.path.join(v, "splits", "val.txt"), "reference"),
            ("image-level 1-hot (train)", os.path.join(v, "voc_1h_labels_train.npy"), "reference"),
            ("image-level 1-hot (val)", os.path.join(v, "voc_1h_labels_val.npy"), "reference"),
            ("iABN ResNet-101 ImageNet ckpt",
             os.path.join(pretrained_dir,
                          pretrained_name(backbone or "resnet101")), "both"),
        ]
    else:  # coco-voc
        rows += [
            ("COCO images (train)", os.path.join(c, "images", "train2017"), "both"),
            ("COCO images (val)", os.path.join(c, "images", "val2017"), "both"),
            ("COCO annotations", os.path.join(c, "annotations"), "both"),
            ("VOC/SBD images (step 1)", os.path.join(v, "JPEGImages"), "both"),
            ("SBD-coco train json", os.path.join(v, "pascal_sbd_train.json"), "both"),
            ("SBD-coco val json", os.path.join(v, "pascal_sbd_val.json"), "both"),
            ("as-coco split (train)", os.path.join(v, "splits", "train_aug_ascoco.txt"), "reference"),
            ("as-coco split (val)", os.path.join(v, "splits", "val_ascoco.txt"), "reference"),
            ("cocovoc 1-hot (train)", os.path.join(v, "cocovoc_1h_labels_train.npy"), "reference"),
            ("step index files", os.path.join(data_root, "coco-voc", "voc"), "both"),
            ("iABN WRN-38 ImageNet ckpt",
             os.path.join(pretrained_dir, pretrained_name(
                 backbone or "wider_resnet38_a2")), "both"),
        ]
    return rows


def step0_config(a):
    """The finalized config of the port's step-0 stage."""
    argv = port_cmds(a)[0]
    return parse_config(argv[argv.index(PORT_MODULE) + 1:]).finalize()


def body_shapes(cfg):
    """Every ``body.*`` key of the model the step-0 trainer builds for
    `cfg`, with its shape; built on the meta device, so nothing is
    allocated."""
    classes = tasks.get_per_task_classes(cfg.dataset, cfg.task, 0)
    with torch.device("meta"):
        model = make_model(classes, **model_kwargs(cfg))
    return {k: tuple(t.shape) for k, t in model.state_dict().items()
            if k.startswith("body.")}


def coverage(path, shapes):
    """What the port's loader gives from the ImageNet file `path` against
    the body's keys and `shapes`: the counts, and up to LISTED names of
    the keys missing, of the wrong shape ([key, file's, body's]) and
    ignored (in the file, not in the body: the trainer's merge drops
    them). `ready`: every body key given with its shape."""
    try:
        pre = load_torch_pretrained(path)
    except Exception as e:  # a file the loader cannot read is not ready
        return {"ready": False, "error": f"{type(e).__name__}: {e}"}
    missing = [k for k in shapes if k not in pre]
    wrong = [[k, list(pre[k].shape), list(want)] for k, want in shapes.items()
             if k in pre and tuple(pre[k].shape) != want]
    ignored = [k for k in pre if k not in shapes]
    return {"ready": not missing and not wrong,
            "covered": len(shapes) - len(missing) - len(wrong),
            "body": len(shapes), "n_missing": len(missing),
            "n_wrong_shape": len(wrong), "n_ignored": len(ignored),
            "missing": missing[:LISTED], "wrong_shape": wrong[:LISTED],
            "ignored": ignored[:LISTED]}


def check(a):
    """The readiness check of `a`'s task, data root, ImageNet directory
    and stage flags: each row OK, MISSING or, for the ImageNet file,
    MISMATCH when it does not cover the step-0 body. Rows the reference
    alone reads do not block, since this kit runs no reference. Returns
    {"ready", "rows"}."""
    cfg = step0_config(a)
    rows = requirements(a.task, a.data_root, a.pretrained_dir, cfg.backbone)
    image_net = rows[-1][1]
    ready, out = True, []
    print(f"readiness check — task {a.task}, data_root {a.data_root}")
    for label, path, who in rows:
        present = os.path.exists(path)
        row = {"label": label, "path": path, "who": who,
               "status": "OK" if present else "MISSING"}
        if present and path == image_net:
            row["coverage"] = coverage(path, body_shapes(cfg))
            if not row["coverage"]["ready"]:
                row["status"] = "MISMATCH"
        ready &= row["status"] == "OK" or who == "reference"
        out.append(row)
        print(f"  [{row['status']}] {label:34s} {path} ({who})")
        if "coverage" in row:
            print(f"      coverage of the {cfg.backbone} body: "
                  f"{json.dumps(row['coverage'])}")
    return {"ready": bool(ready), "rows": out}


# ---------------------------------------------------------------- commands

def _recipe(task: str):
    """Per-stage (epochs, extra-args) from the reference recipe scripts."""
    if task == "coco-voc":
        return {"dataset": "coco-voc", "task": "voc", "alpha": "0.9",
                "epochs": (200, 30, 50), "val_interval": 50, "overlap": False}
    return {"dataset": "voc", "task": task, "alpha": "0.5",
            "epochs": (100, 40, 50), "val_interval": 10, "overlap": True}


def _stage_args(a):
    extra = shlex.split(a.stage_args or "")
    moved = [f for f in extra if f.split("=")[0] in PATH_FLAGS]
    if moved:
        raise ValueError(f"--stage_args may not set {moved}: they carry the "
                         "stages' checkpoint hand-off")
    return extra


def port_cmds(a):
    """The argv of each stage: the JAX kit's ``rebuild_cmds`` with the
    port's CLI (``--device`` left at its default, the card). Over
    ``a.nproc_per_node`` > 1 cards each stage runs under
    ``torch.distributed.run`` with ``CL4WSIS_MULTIHOST=1`` at the same
    global batch. ``a.stage_args`` is appended to every stage (a CPU
    rehearsal's ``--tiny --device cpu ...``)."""
    r = _recipe(a.task)
    n = a.nproc_per_node
    if n < 1 or GLOBAL_BATCH % n:
        raise ValueError(f"--nproc_per_node {n} does not divide the batch "
                         f"of {GLOBAL_BATCH}")
    # always pass the flag explicitly: Config.overlap defaults to True, so
    # omitting it for coco-voc (overlap=False) would both train on the
    # wrong (overlapped) split and save checkpoints under the -ov path,
    # breaking the --step_ckpt/--seg_ckpt handoff below.
    ov = ["--overlap", "true" if r["overlap"] else "false"]
    run = [sys.executable, "-m", PORT_MODULE]
    if n > 1:
        run = ["env", "CL4WSIS_MULTIHOST=1", sys.executable, "-m",
               "torch.distributed.run", "--nproc_per_node", str(n), "-m",
               PORT_MODULE]
    base = run + [
        "--dataset", r["dataset"], "--task", r["task"],
        "--batch_size", str(GLOBAL_BATCH // n),
        "--val_interval", str(r["val_interval"]),
        "--data_root", a.data_root, "--pretrained_path", a.pretrained_dir,
        "--checkpoint", os.path.join(a.workdir, "rb_ckpt"),
        "--logdir", os.path.join(a.workdir, "rb_logs"),
        "--num_workers", str(a.num_workers), "--seed", str(a.seed)] + ov
    e0, e1, e2 = [max(1, int(e * a.epochs_scale)) for e in r["epochs"]]
    ovs = "-ov" if r["overlap"] else ""
    path = os.path.join(a.workdir, "rb_ckpt", "step",
                        f"{r['dataset']}-{r['task']}{ovs}")
    extra = _stage_args(a)
    return [
        base + ["--name", "RB", "--step", "0", "--bce", "true",
                "--lr", "0.00005", "--epochs", str(e0), "--optim", "adam",
                "--weight_decay", "0"] + extra,
        base + ["--name", "RB", "--step", "1", "--weakly", "true",
                "--phase", "1", "--alpha", r["alpha"], "--lr", "0.001",
                "--loss_de", "1", "--lr_policy", "warmup",
                "--affinity", "true", "--epochs", str(e1), "--optim", "sgd",
                "--step_ckpt", os.path.join(path, "RB_0")] + extra,
        base + ["--name", "RB", "--step", "1", "--weakly", "true",
                "--phase", "2", "--alpha", r["alpha"], "--lr", "0.00005",
                "--loss_de", "1", "--lr_policy", "warmup",
                "--affinity", "true", "--epochs", str(e2), "--optim", "adam",
                "--weight_decay", "0",
                "--step_ckpt", os.path.join(path, "RB_0"),
                "--seg_ckpt", os.path.join(path, "RB_1")] + extra,
    ]


def reference_cmds(a):
    """Upstream's stage commands in the native CUDA form its recipe
    documents (``torch.distributed.launch``), for a machine that has
    upstream and ``inplace_abn``."""
    r = _recipe(a.task)
    ov = "--overlap" if r["overlap"] else ""
    e0, e1, e2 = [max(1, int(e * a.epochs_scale)) for e in r["epochs"]]
    pars = (f"--dataset {r['dataset']} --task {r['task']} --batch_size 16 "
            f"{ov} --val_interval {r['val_interval']} --data_root "
            f"{a.data_root} --random_seed {a.seed}")
    ovs = "-ov" if r["overlap"] else ""
    path = f"checkpoints/step/{r['dataset']}-{r['task']}{ovs}"
    stages = [
        f"--name REF --step 0 --bce --lr 0.00005 {pars} --epochs {e0} "
        f"--optim adam --weight_decay 0",
        f"--name REF --step 1 --weakly {pars} --alpha {r['alpha']} "
        f"--lr 0.001 --step_ckpt {path}/REF_0.pth --loss_de 1 "
        f"--lr_policy warmup --affinity --epochs {e1} --optim sgd --phase 1",
        f"--name REF --step 1 --weakly {pars} --alpha {r['alpha']} "
        f"--lr 0.00005 --step_ckpt {path}/REF_0.pth --loss_de 1 "
        f"--lr_policy warmup --affinity --epochs {e2} --optim adam "
        f"--weight_decay 0 --seg_ckpt {path}/REF_1.pth --phase 2",
    ]
    n = 8 if a.task == "coco-voc" else 1
    return [f"python -m torch.distributed.launch --nproc_per_node={n} "
            f"run.py --num_workers 4 --sample_num 8 {s}" for s in stages]


# -------------------------------------------------------------- execution

# Both stacks' stdout formats. Reference: python-dict repr of the VOC
# evaluator results ('map': .., 'ap@0.5': ..). Port: cli/main.py's
# logger.info line (mAP@[.5:.95]=.. mAP@.5=..) plus the JSONL echo
# ("map": .., "map50": ..) when the log file is inspected directly.
_MAP_RES = [re.compile(r"'map': (?:np\.float64\()?([0-9.eE+-]+)\)?"),
            re.compile(r"mAP@\[\.5:\.95\]=([0-9.eE+-]+)"),
            re.compile(r'"map": ([0-9.eE+-]+)')]
_MAP50_RES = [re.compile(r"'ap@0?\.5'?: (?:np\.float64\()?([0-9.eE+-]+)\)?"),
              re.compile(r"mAP@\.5=([0-9.eE+-]+)"),
              re.compile(r'"map50": ([0-9.eE+-]+)')]


def _last_match(patterns, log):
    """Value of the LAST occurrence (by position) across all formats."""
    hits = [(m.start(), float(m.group(1)))
            for p in patterns for m in p.finditer(log)]
    return max(hits)[1] if hits else None


def run_stages(cmds, log_prefix, timeout):
    """Each stage in turn, its output written to
    ``{log_prefix}_stage{i}.log`` as it runs, in a session of its own (a
    stage's loader workers or torchrun's ranks go with it when it times
    out); a timed-out stage is recorded with rc -1, and the first stage
    that fails ends the run."""
    # the stages import the port from this checkout, wherever they start
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        REPO, os.environ.get("PYTHONPATH")])))
    results = []
    for i, cmd in enumerate(cmds):
        t0 = time.time()
        path = f"{log_prefix}_stage{i}.log"
        with open(path, "w") as f:
            p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                 env=env, start_new_session=True)
            try:
                rc = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
                rc = -1
                f.write(f"\n[run_realdata_parity_torch] stage timed out "
                        f"after {timeout}s\n")
        with open(path, errors="replace") as f:
            log = f.read()
        results.append({"stage": i, "rc": rc,
                        "wall_s": round(time.time() - t0, 1),
                        "map": _last_match(_MAP_RES, log),
                        "map50": _last_match(_MAP50_RES, log)})
        if rc:
            results[-1]["tail"] = log[-1500:]
            break
    return results


def port_metrics(a):
    """Each run's final results from the port Logger's JSONL under
    ``<workdir>/rb_logs/<dataset>-<task>[-ov]/RB``. The three stages share
    the name RB, so they append to one file: a run starts at its config
    record, and its last results record is its final (the CLI's "test")."""
    r = _recipe(a.task)
    ovs = "-ov" if r["overlap"] else ""
    logdir = os.path.join(a.workdir, "rb_logs",
                          f"{r['dataset']}-{r['task']}{ovs}", "RB")
    out = []
    if os.path.isdir(logdir):
        for fn in sorted(os.listdir(logdir)):
            if not fn.endswith(".jsonl"):
                continue
            with open(os.path.join(logdir, fn)) as f:
                for rec in map(json.loads, f):
                    if rec.get("type") == "config":
                        out.append({"file": fn, "step": rec.get("step"),
                                    "phase": rec.get("phase"),
                                    "final": None})
                    elif rec.get("type") == "results" and out:
                        out[-1]["final"] = rec
    return out


def parity_table(port, other, side):
    """Per stage: the port's mask AP50, the other side's, the difference
    in points and whether it is within BASELINE.md's 0.5 pt."""
    pb = {r["stage"]: r for r in port}
    ob = {r["stage"]: r for r in other}
    table = []
    for s in sorted(set(pb) | set(ob)):
        row = {"stage": s, "port_map50": pb.get(s, {}).get("map50"),
               f"{side}_map50": ob.get(s, {}).get("map50")}
        if row["port_map50"] is not None and \
                row[f"{side}_map50"] is not None:
            d = row["port_map50"] - row[f"{side}_map50"]
            row["delta_pts"] = round(100 * d, 2)
            row["within_0.5pt"] = abs(d) <= 0.005
        table.append(row)
    return table


def get_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_root", default="data")
    ap.add_argument("--pretrained_dir", default="pretrained")
    ap.add_argument("--task", default="15-5", choices=TASKS)
    ap.add_argument("--run", default="check", choices=["check", "port"])
    ap.add_argument("--workdir", default=os.path.join("tmp",
                                                      "realdata_parity"))
    ap.add_argument("--out", default="logs/realdata_parity_torch.json")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--epochs_scale", type=float, default=1.0,
                    help="scale every stage's epoch budget (smoke: 0.01)")
    ap.add_argument("--timeout", type=int, default=14 * 24 * 3600,
                    help="seconds a stage may take")
    ap.add_argument("--nproc_per_node", type=int, default=1,
                    help="cards a stage runs on, under torch.distributed.run")
    ap.add_argument("--against", default=None,
                    help="a JSON that either kit wrote: the other column")
    ap.add_argument("--against_side", default="rebuild",
                    choices=["rebuild", "reference"],
                    help="its entry: the JAX package's runs (rebuild) or "
                         "upstream's (reference)")
    ap.add_argument("--stage_args", default="",
                    help="flags appended to every stage, for a rehearsal "
                         "on the CPU (e.g. '--tiny true --device cpu'); "
                         "not the checkpoint paths")
    return ap


def main(argv=None):
    a = get_parser().parse_args(argv)
    ready = check(a)
    print()
    print("port stage commands:")
    for c in port_cmds(a):
        print("  " + shlex.join(c))
    print("reference stage commands (native CUDA form, for a machine with "
          "upstream and inplace_abn):")
    for c in reference_cmds(a):
        print("  " + c)
    if a.run == "check":
        print(f"\nready: {ready['ready']} (run with --run port to execute)")
        return 0 if ready["ready"] else 1
    if not ready["ready"]:
        print("\nABORT: required inputs missing or mismatched (see the "
              "MISSING / MISMATCH rows above)")
        return 1

    os.makedirs(a.workdir, exist_ok=True)
    results = {"config": vars(a), "readiness": ready}
    print("=== port ===", flush=True)
    results["port"] = run_stages(port_cmds(a),
                                 os.path.join(a.workdir, "rb"), a.timeout)
    results["port_logged"] = port_metrics(a)
    if a.against:
        with open(a.against) as f:
            other = json.load(f).get(a.against_side, [])
        results["parity_table"] = parity_table(results["port"], other,
                                               a.against_side)
        print(json.dumps(results["parity_table"], indent=2))

    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", a.out)
    return 0 if all(r["rc"] == 0 for r in results["port"]) else 1


if __name__ == "__main__":
    sys.exit(main())
