#!/usr/bin/env python3
"""Data-parallel steps and the CLI over several cards with NCCL, one
process a card.

    python3 scripts/dist_nccl.py --ranks 4      # on a machine with 4 cards

1. One process on cuda:0 runs the reference: 3 phase-2 and 3 step-0 steps
   of chip_smoke.py's dist-phase set-ups (VOC 15-5, ResNet-101, batch 16
   at 512^2, bf16, SGD).
2. The same steps under torch.distributed.run --nproc_per_node RANKS with
   CL4WSIS_MULTIHOST=1: NCCL, one card and 16 / RANKS rows a rank. Printed:
   every rank's step times, all-reduces a step and kernel launches; the
   summed first-step loss against the reference's (held within
   chip_smoke.DIST_BF16_TOL) and rank 0's first updates against the
   reference's (update_reading, recorded); the ranks' weights must be
   equal after the last step (core/dist.check_same).
3. The CLI's step 0 under torch.distributed.run at RANKS (synthetic, 16 /
   RANKS images a rank, one epoch of 4 batches): cli.main makes the NCCL
   group, rank 0 writes the checkpoint behind the barrier.

The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from cl4wsis_tpu_torch.core import dist  # noqa: E402


def worker(spec_path, out_prefix):
    """One rank under torchrun: the steps on its rows of the global batch."""
    if not dist.init_from_env("cuda"):
        raise AssertionError("no process group was made")
    try:
        spec = torch.load(spec_path, weights_only=False)
        dev = dist.local_device("cuda")
        cs.kernels.lib()
        res = {"device": str(dev), "backend":
               torch.distributed.get_backend(), "world": dist.world()}
        res["phase 2"], _ = cs.dist_phase2(dev, spec["surgery"])
        res["step 0"] = cs.dist_step0(dev)
        for key in ("phase 2", "step 0"):
            after = res[key].pop("after")
            dist.check_same(after, f"{key}: the ranks' weights")
            if not dist.is_main():
                del res[key]["before"], res[key]["first"]
        torch.save(res, f"{out_prefix}{dist.rank()}.pt")
    finally:
        dist.destroy()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    if torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"{args.ranks} ranks need as many cards; this "
                         f"machine has {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.log(smi.stdout.strip())
    cs.kernels.lib()
    dev = torch.device("cuda", 0)
    one_p2, surgery = cs.dist_phase2(dev)
    one_s0 = cs.dist_step0(dev)
    torch.cuda.empty_cache()
    env = dict(os.environ, CL4WSIS_MULTIHOST="1", PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--nproc_per_node", str(args.ranks), "--master_addr",
                "127.0.0.1"]
    out = {"ranks": args.ranks}
    with tempfile.TemporaryDirectory() as root:
        spec = os.path.join(root, "spec.pt")
        torch.save({"surgery": surgery}, spec)
        t = time.perf_counter()
        p = subprocess.run(torchrun + [
            "--master_port", str(cs.free_port()), os.path.abspath(__file__),
            "--worker", spec, os.path.join(root, "rank")], env=env,
            capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            raise AssertionError(f"the ranks failed:\n{p.stdout[-4000:]}\n"
                                 f"{p.stderr[-6000:]}")
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                            weights_only=False) for r in range(args.ranks)]
        cs.log(f"{args.ranks} ranks under NCCL ({[r['device'] for r in ranks]}"
               f", {ranks[0]['backend']}): {time.perf_counter() - t:.1f} s")
        for key, one in (("phase 2", one_p2), ("step 0", one_s0)):
            rr = [r[key] for r in ranks]
            got = sum(r["metrics"][0]["loss"] for r in rr)
            loss_err = abs(got - one["metrics"][0]["loss"]) / abs(
                one["metrics"][0]["loss"])
            rd = cs.first_update_readings(one, rr[0])
            meds = [float(np.median(r["times_ms"][1:])) for r in rr]
            out[key] = {
                "loss_one": one["metrics"][0]["loss"], "loss_ranks": got,
                "loss_rel_err": loss_err,
                "update_reading_median": float(np.median(list(rd.values()))),
                "update_reading_max": max(rd.values()),
                "rank_step_ms_median": meds,
                "one_step_ms_median": float(np.median(one["times_ms"][1:])),
                "all_reduces_a_step": rr[0]["collectives"][-1],
                "launches": [r["launches"] for r in rr]}
            cs.log(f"{key}: {json.dumps(out[key])}")
            if not loss_err <= cs.DIST_BF16_TOL["loss (relative)"]:
                raise AssertionError(f"{key}: the ranks' loss differs from "
                                     f"one process's")
        argv = cs.CHAIN_COMMON + cs.CHAIN_RUNS["step 0"] + [
            "--batch_size", str(cs.B // args.ranks), "--checkpoint",
            os.path.join(root, "ck"), "--visualize", "false"]
        t = time.perf_counter()
        p = subprocess.run(torchrun + [
            "--master_port", str(cs.free_port()), "-m",
            "cl4wsis_tpu_torch.cli.main"] + argv, env=env,
            capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t
        ck = os.path.join(root, "ck", "step", "voc-15-5-ov", "exp_0")
        if p.returncode != 0 or not os.path.exists(ck) or \
                p.stdout.count("[done]") != args.ranks:
            raise AssertionError(f"the CLI at {args.ranks} ranks failed:\n"
                                 f"{p.stdout[-4000:]}\n{p.stderr[-6000:]}")
        epoch = [ln for ln in p.stdout.splitlines() if "[epoch 0]" in ln]
        out["cli_step0"] = {"wall_s": wall, "log": epoch,
                            "ckpt_gib": os.path.getsize(ck) / 2 ** 30}
        cs.log(f"CLI step 0 at {args.ranks} ranks: {wall:.1f} s, {epoch}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(*sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
