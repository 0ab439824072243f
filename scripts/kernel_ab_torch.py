#!/usr/bin/env python3
"""Time the port's kernels of one checkout on one NVIDIA card, so that two
checkouts can be compared in turns within one machine.

    python3 scripts/kernel_ab_torch.py                    # this checkout
    python3 scripts/kernel_ab_torch.py --repo OTHER --label parent
    python3 scripts/kernel_ab_torch.py --only stamp,serve

`--repo` names the checkout whose `cl4wsis_tpu_torch` package (and CUDA
sources) are built and timed; the inputs and the timers are those of this
checkout's `chip_smoke.py`, so both checkouts see the same rows, maps and
slots. `--only` keeps the named kernels' cases.
Every kernel result is first held bit-equal to the plain version. Prints
one JSON line: the card, the label and, per case, device ms (torch.profiler),
ms (CUDA events) and device ms by kernel, with `torch.topk` beside the
top-k cases and `out.zero_()` beside the stamp. The `serve` group times
whole requests instead: `chip_smoke.py`'s 4 serving sizes, 3 rounds,
through the checkout's `Predictor` at full width (host clock to a
synchronize), after one warm-up request.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
GROUPS = ("topk", "cc", "run_totals", "stamp", "serve")


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


def timed(smoke, fn, **more):
    return dict(device_ms=smoke.device_ms(fn), ms=smoke.time_ms(fn),
                kernels=split_ms(smoke, fn), **more)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--label", default="change")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"comma-separated subset of {GROUPS}")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"--only takes {GROUPS}")
    if not torch.cuda.is_available():
        print("kernel_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.repo).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cl4wsis_tpu_torch.ops import cc, kernels, labelgen, segsort, topk
    kernels.lib()
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    S = 512 * 512
    out = {}

    rows = {} if "topk" not in only else {
        "topk cam (80, 262144) k 25": (rs.rand(80, S).astype(np.float32) ** 8,
                                       25),
        "topk peaks (80, 262144) k 25": (smoke.peak_rows(80, S, rs), 25),
        "topk nms (80, 262144) k 16": (smoke.nms_rows(80, S, rs), 16),
        "topk serving nms (20, 262144) k 32": (smoke.nms_rows(20, S, rs), 32),
    }
    for name, (x, k) in rows.items():
        t = torch.from_numpy(x).to(dev)
        gv, gi = topk.topk_cuda(t, k)
        pv, pi = topk.topk_plain(t, k)
        if not (torch.equal(gi, pi) and torch.equal(gv.view(torch.int32),
                                                    pv.view(torch.int32))):
            raise AssertionError(f"{name}: kernel differs from plain")
        out[name] = timed(
            smoke, lambda: topk.topk_cuda(t, k),
            torch_topk_device_ms=smoke.device_ms(lambda: torch.topk(t, k)))
    if "cc" in only:
        batch = np.stack([smoke.blobby(512, 512, 20, rs, cell=c)
                          for c in (8, 16, 32, 64)] * 4).astype(np.int32)
        b = torch.from_numpy(batch).to(dev)
        cases = {"cc (16, 512, 512) blobby conn 8": (b, 8),
                 "cc (16, 512, 512) blobby conn 4": (b, 4),
                 "cc (512, 512) blobby conn 8": (b[1].contiguous(), 8)}
        for name, (m, conn) in cases.items():
            if not torch.equal(cc.cc_multilabel_cuda(m, conn),
                               cc.cc_multilabel_plain(m, conn)):
                raise AssertionError(f"{name}: kernel differs from plain")
            out[name] = timed(smoke, lambda: cc.cc_multilabel_cuda(m, conn))
        mask = b[1] > 0
        if not torch.equal(cc.cc_binary_cuda(mask, 8),
                           cc.cc_binary_plain(mask, 8)):
            raise AssertionError("cc_binary differs from plain")
        out["cc_binary (512, 512) blobby conn 8"] = dict(
            device_ms=smoke.device_ms(lambda: cc.cc_binary_cuda(mask, 8)),
            ms=smoke.time_ms(lambda: cc.cc_binary_cuda(mask, 8)))

    if "run_totals" in only:
        step_keys = smoke.step_like_rows(16, S, rs)
        yx = np.broadcast_to(np.arange(S), step_keys.shape)
        key_rows = {
            "run_totals (16, 262144) uniform keys": (
                np.sort(rs.randint(0, 40000, (16, S)), axis=1), None),
            "run_totals (16, 262144) step-like rows": (
                step_keys, [yx // 512, yx % 512, np.zeros_like(step_keys)]),
            "run_totals (16, 262144) single run": (np.zeros((16, S)), None),
            "run_totals serving (1, 262144) keys<3000": (
                np.sort(rs.randint(0, 3000, (1, S)), axis=1), None),
        }
        for name, (keys, pay) in key_rows.items():
            if pay is None:
                pay = [rs.randint(0, 512, keys.shape) for _ in range(3)]
            a = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
                 for x in [keys] + pay]
            for g, w in zip(segsort.run_totals_cuda(*a),
                            segsort.run_totals_plain(*a)):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name}: kernel differs from plain")
            out[name] = timed(smoke, lambda: segsort.run_totals_cuda(*a))

    if "stamp" in only:
        C, hw = 20, (512, 512)
        slot_sets = {
            "stamp (16, 120) random slots sigma 6": (
                smoke.border_slots(rs, 16, 120, 512, 512, C), 6),
            "stamp (16, 64) pseudo slots (1-3 valid) sigma 6": (
                smoke.step_slots("pseudo", rs, 16, 64, 512, 512, C), 6),
            "stamp (16, 120) refined slots (none valid) sigma 6": (
                smoke.step_slots("refined", rs, 16, 120, 512, 512, C), 6),
            "stamp (16, 120) random slots sigma 30": (
                smoke.border_slots(rs, 16, 120, 512, 512, C), 30),
        }
        for name, (slots, sigma) in slot_sets.items():
            a = [torch.from_numpy(x).to(dev) for x in slots]
            if not torch.equal(labelgen.stamp_centers_cuda(*a, C, sigma, hw),
                               labelgen.stamp_centers(*a, C, sigma, hw)):
                raise AssertionError(f"{name}: kernel differs from plain")
            out[name] = timed(
                smoke, lambda: labelgen.stamp_centers_cuda(*a, C, sigma, hw))
        planes = torch.empty((16, C, 512, 512), device=dev)
        out["zero_ (16, 20, 512, 512) float32 (a fill, beside the stamp)"] = \
            dict(device_ms=smoke.device_ms(planes.zero_),
                 ms=smoke.time_ms(planes.zero_))

    if "serve" in only:
        from cl4wsis_tpu_torch.models import make_model
        from cl4wsis_tpu_torch.serve import Predictor
        torch.manual_seed(0)
        pred = Predictor(make_model((16, 5), "resnet101", 16, 512))
        images = [smoke.request_image(h, w, rs) for h, w in smoke.SERVE_SIZES]
        pred(images[0])
        lat = []
        for img in images * 3:
            torch.cuda.synchronize()
            t = time.perf_counter()
            pred(img)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        out["serve 4 sizes x 3, ResNet-101, bfloat16"] = dict(
            median_ms=float(np.median(lat)), latency_ms=lat)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
