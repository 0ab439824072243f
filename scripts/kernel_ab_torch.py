#!/usr/bin/env python3
"""Time the port's top-k and CC kernels of one checkout on one NVIDIA card,
so that two checkouts can be compared in turns within one machine.

    python3 scripts/kernel_ab_torch.py                    # this checkout
    python3 scripts/kernel_ab_torch.py --repo OTHER --label parent

`--repo` names the checkout whose `cl4wsis_tpu_torch` package (and CUDA
sources) are built and timed; the inputs and the timers are those of this
checkout's `chip_smoke.py`, so both checkouts see the same rows and maps.
Every kernel result is first held bit-equal to the plain version. Prints
one JSON line: the card, the label and, per case, device ms (torch.profiler),
ms (CUDA events) and device ms by kernel, with `torch.topk` beside the
top-k cases.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def split_ms(smoke, fn, iters=10):
    """Device ms per call of `fn`, by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / iters / 1e3
            for e in smoke.kernel_rows(prof)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.repo).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cl4wsis_tpu_torch.ops import cc, kernels, topk
    kernels.lib()
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    S = 512 * 512
    rows = {
        "topk cam (80, 262144) k 25": (rs.rand(80, S).astype(np.float32) ** 8,
                                       25),
        "topk peaks (80, 262144) k 25": (smoke.peak_rows(80, S, rs), 25),
        "topk nms (80, 262144) k 16": (smoke.nms_rows(80, S, rs), 16),
        "topk serving nms (20, 262144) k 32": (smoke.nms_rows(20, S, rs), 32),
    }
    batch = np.stack([smoke.blobby(512, 512, 20, rs, cell=c)
                      for c in (8, 16, 32, 64)] * 4).astype(np.int32)
    out = {}
    for name, (x, k) in rows.items():
        t = torch.from_numpy(x).to(dev)
        gv, gi = topk.topk_cuda(t, k)
        pv, pi = topk.topk_plain(t, k)
        if not (torch.equal(gi, pi) and torch.equal(gv.view(torch.int32),
                                                    pv.view(torch.int32))):
            raise AssertionError(f"{name}: kernel differs from plain")
        out[name] = dict(
            device_ms=smoke.device_ms(lambda: topk.topk_cuda(t, k)),
            ms=smoke.time_ms(lambda: topk.topk_cuda(t, k)),
            kernels=split_ms(smoke, lambda: topk.topk_cuda(t, k)),
            torch_topk_device_ms=smoke.device_ms(lambda: torch.topk(t, k)))
    b = torch.from_numpy(batch).to(dev)
    cases = {"cc (16, 512, 512) blobby conn 8": (b, 8),
             "cc (16, 512, 512) blobby conn 4": (b, 4),
             "cc (512, 512) blobby conn 8": (b[1].contiguous(), 8)}
    for name, (m, conn) in cases.items():
        if not torch.equal(cc.cc_multilabel_cuda(m, conn),
                           cc.cc_multilabel_plain(m, conn)):
            raise AssertionError(f"{name}: kernel differs from plain")
        out[name] = dict(
            device_ms=smoke.device_ms(lambda: cc.cc_multilabel_cuda(m, conn)),
            ms=smoke.time_ms(lambda: cc.cc_multilabel_cuda(m, conn)),
            kernels=split_ms(smoke, lambda: cc.cc_multilabel_cuda(m, conn)))
    mask = b[1] > 0
    if not torch.equal(cc.cc_binary_cuda(mask, 8), cc.cc_binary_plain(mask, 8)):
        raise AssertionError("cc_binary differs from plain")
    out["cc_binary (512, 512) blobby conn 8"] = dict(
        device_ms=smoke.device_ms(lambda: cc.cc_binary_cuda(mask, 8)),
        ms=smoke.time_ms(lambda: cc.cc_binary_cuda(mask, 8)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
