#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which must pass (the script exits non-zero otherwise):
  1. print the card's name and power limit; build the CUDA kernels of
     cl4wsis_tpu_torch/csrc from the checkout;
  2. hold every kernel against its plain PyTorch version on the card at
     the serving shapes (bit-equal), and time kernel, plain version and,
     where one exists, the single PyTorch call computing the same function;
  3. serve 4 requests of VOC-native sizes through Predictor on the
     full-width ResNet-101 model (classes (16, 5), random weights from a
     seed, bfloat16), counting the kernel launches of each request; then run
     get_ins_map on a painted 512x512 scene of known instances through the
     kernels and through the plain versions, which must agree exactly and
     find every instance;
  4. print the kernels line (JSON) and, last, the ok line (JSON).
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.ops import cc, kernels, segsort, topk
from cl4wsis_tpu_torch.ops.instance_postproc import get_ins_map
from cl4wsis_tpu_torch.serve import Predictor

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
SERVE_SIZES = ((375, 500), (500, 375), (500, 333), (512, 512))  # (H, W)
PER_REQUEST = {"cc_multilabel": 2, "topk": 1, "run_totals": 1}
KERNEL_INFO = {
    "topk": ("cl4wsis_tpu_torch/csrc/topk.cu",
             "cl4wsis_tpu/ops/pallas_topk.py:94"),
    "cc_multilabel": ("cl4wsis_tpu_torch/csrc/cc.cu",
                      "cl4wsis_tpu/ops/pallas_cc.py:297"),
    "run_totals": ("cl4wsis_tpu_torch/csrc/run_totals.cu",
                   "cl4wsis_tpu/ops/pallas_seg.py:124"),
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of `fn` over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_rows(prof):
    """The profile's rows of device kernels and copies. The operator rows
    (aten::*) repeat the device time of the kernels they launch, so a sum
    over all rows would count that time twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, iters=10):
    """Mean device time per call of `fn`: the CUDA kernels' own time as
    torch.profiler records it, without the host's gaps between launches.
    None where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in kernel_rows(prof))
    return us / iters / 1e3 if us > 0 else None


def max_abs_err(a, b):
    if torch.equal(a, b):
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(torch.where(torch.isnan(d), torch.inf, d).max())


def bound_ms(n_bytes):
    return n_bytes / HBM_BYTES_PER_S * 1e3


# ----------------------------------------------------------------- inputs

def blobby(H, W, C, rs, cell=16):
    lo = rs.randint(1, C + 1, (H // cell + 1, W // cell + 1))
    lo[rs.rand(*lo.shape) < 0.4] = 0
    return np.kron(lo, np.ones((cell, cell), np.int64))[:H, :W]


def speckle(H, W, C, rs):
    m = rs.randint(1, C + 1, (H, W))
    m[rs.rand(H, W) < 0.5] = 0
    return m


def spiral(n):
    """One-pixel corridor wound inward with one-pixel gaps."""
    m = np.zeros((n, n), np.int32)
    y = x = d = turns = 0
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    m[0, 0] = 1
    while turns < 2:
        dy, dx = dirs[d]
        ny, nx, ay, ax = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        ahead = 0 <= ay < n and 0 <= ax < n and m[ay, ax]
        if 0 <= ny < n and 0 <= nx < n and not m[ny, nx] and not ahead:
            y, x, turns = ny, nx, 0
            m[y, x] = 1
        else:
            d, turns = (d + 1) % 4, turns + 1
    return m


def nms_rows(B, N, rs):
    """Rows like refine's NMS plane: -1 fill with few survivors, ties, a
    row of fewer than k survivors and -inf entries."""
    x = np.full((B, N), -1.0, np.float32)
    for b in range(B):
        pos = rs.choice(N, rs.randint(0, 120), replace=False)
        x[b, pos] = rs.choice([0.15, 0.5, 0.5, 0.9, 0.9, 1.0], len(pos))
    x[1, :] = -1.0
    x[1, [7, 70000, 200000]] = 0.7
    x[2, rs.rand(N) < 0.3] = -np.inf
    x[3] = rs.rand(N)
    x[3, 1000:1100] = 2.0
    return x


def painted_scene(H, W, C, rs, n_inst=40, cell=64):
    """A seg/center/offset scene with instances in distinct grid cells, so
    each must come out as exactly one valid slot; every fifth instance has
    a center too weak for NMS and is found by its offset cluster."""
    seg = rs.uniform(0.0, 0.1, (H, W, C + 1)).astype(np.float32)
    seg[..., 0] += 1.0
    center = np.zeros((H, W, C), np.float32)
    offset = rs.uniform(-20, 20, (H, W, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cells = rs.choice((H // cell) * (W // cell), n_inst, replace=False)
    insts = []
    for i, c_id in enumerate(cells):
        gy, gx = divmod(int(c_id), W // cell)
        cy = gy * cell + cell // 2 + rs.randint(-4, 5)
        cx = gx * cell + cell // 2 + rs.randint(-4, 5)
        ry, rx = rs.randint(8, 25, 2)
        c = rs.randint(C)
        box = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
        seg[box] = rs.uniform(0.0, 0.1, (box.sum(), C + 1))
        seg[box, c + 1] = rs.uniform(0.6, 1.0)
        peak = 0.08 if i % 5 == 4 else rs.uniform(0.5, 1.0)
        center[..., c] = np.maximum(
            center[..., c], peak * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                          / 18.0))
        offset[..., 0][box] = (cy - yy)[box]
        offset[..., 1][box] = (cx - xx)[box]
        insts.append((c, box))
    seg /= seg.sum(-1, keepdims=True)
    return seg, center, offset, insts


def request_image(H, W, rs):
    lo = rs.randint(0, 256, (H // 32 + 2, W // 32 + 2, 3)).astype(np.float32)
    img = np.kron(lo, np.ones((32, 32, 1), np.float32))[:H, :W]
    img += rs.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@contextlib.contextmanager
def plain_versions():
    """Route the serving path's three kernel calls to their plain PyTorch
    versions, for the same-card comparison of the whole post-processing."""
    saved = (cc.connected_components_multilabel, topk.topk_hier,
             segsort.run_totals1)
    cc.connected_components_multilabel = cc.cc_multilabel_plain
    topk.topk_hier = topk.topk_plain
    segsort.run_totals1 = lambda *a: tuple(
        o[0] for o in segsort.run_totals_plain(*(t[None] for t in a)))
    try:
        yield
    finally:
        (cc.connected_components_multilabel, topk.topk_hier,
         segsort.run_totals1) = saved


# ----------------------------------------------------------------- phases

def check_kernels(dev, rs):
    """Phase 2: every kernel against its plain version; returns per-kernel
    results for the kernels line."""
    res = {}

    # multilabel CC: 512^2 blobby (20 classes), speckle, spiral, batched
    maps = {"blobby": blobby(512, 512, 20, rs), "speckle": speckle(512, 512, 3, rs),
            "spiral": spiral(512)}
    err = 0.0
    for name, m in maps.items():
        t = torch.from_numpy(m.astype(np.int32)).to(dev)
        for conn in (4, 8):
            e = max_abs_err(cc.cc_multilabel_cuda(t, conn),
                            cc.cc_multilabel_plain(t, conn))
            log(f"cc {name} 512x512 conn={conn}: max_abs_err {e}")
            err = max(err, e)
    batch = torch.from_numpy(np.stack(
        [blobby(512, 512, 20, rs, cell=c) for c in (8, 16, 32, 64)]
    ).astype(np.int32)).to(dev)
    e = max_abs_err(cc.cc_multilabel_cuda(batch, 8),
                    cc.cc_multilabel_plain(batch, 8))
    log(f"cc batched (4, 512, 512) conn=8: max_abs_err {e}")
    err = max(err, e)
    t = torch.from_numpy(maps["blobby"].astype(np.int32)).to(dev)
    res["cc_multilabel"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: cc.cc_multilabel_cuda(t, 8)),
        device_ms=device_ms(lambda: cc.cc_multilabel_cuda(t, 8)),
        plain_ms=time_ms(lambda: cc.cc_multilabel_plain(t, 8), iters=5),
        library_ms=None, bound_ms=bound_ms(2 * t.numel() * 4),
        shape="(512, 512) int32, connectivity 8, blobby 20-class map")

    # top-k: (20, 262144), k = 32
    x = torch.from_numpy(nms_rows(20, 512 * 512, rs)).to(dev)
    k = 32
    gv, gi = topk.topk_cuda(x, k)
    pv, pi = topk.topk_plain(x, k)
    err = max(max_abs_err(gv, pv), max_abs_err(gi, pi))
    log(f"topk (20, 262144) k=32: max_abs_err {err}")
    xr = torch.from_numpy(rs.rand(20, 512 * 512).astype(np.float32)).to(dev)
    e = max(max_abs_err(topk.topk_cuda(xr, k)[1], topk.topk_plain(xr, k)[1]),
            max_abs_err(topk.topk_cuda(xr[:, :5000].contiguous(), 7)[1],
                        topk.topk_plain(xr[:, :5000], 7)[1]))
    log(f"topk uniform rows and a ragged (20, 5000) k=7: max_abs_err {e}")
    res["topk"] = dict(
        max_abs_err=max(err, e),
        ms=time_ms(lambda: topk.topk_cuda(x, k)),
        device_ms=device_ms(lambda: topk.topk_cuda(x, k)),
        plain_ms=time_ms(lambda: topk.topk_plain(x, k)),
        library_ms=time_ms(lambda: torch.topk(x, k)),
        bound_ms=bound_ms(x.numel() * 4 + x.shape[0] * k * 8),
        shape="(20, 262144) float32, k 32, NMS-like rows")

    # run totals: (1, 262144) and (16, 262144) sorted keys
    err = 0.0
    for B, n_keys in ((1, 3000), (16, 40000), (1, 1)):
        keys = np.sort(rs.randint(0, n_keys, (B, 512 * 512)), axis=1)
        args = [torch.from_numpy(keys.astype(np.int32)).to(dev)] + [
            torch.from_numpy(rs.randint(0, 512, (B, 512 * 512))
                             .astype(np.int32)).to(dev) for _ in range(3)]
        got = segsort.run_totals_cuda(*args)
        want = segsort.run_totals_plain(*args)
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        log(f"run_totals ({B}, 262144) keys<{n_keys}: max_abs_err {e}")
        err = max(err, e)
        if B == 1 and n_keys > 1:
            serve_args = args
    res["run_totals"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: segsort.run_totals_cuda(*serve_args)),
        device_ms=device_ms(lambda: segsort.run_totals_cuda(*serve_args)),
        plain_ms=time_ms(lambda: segsort.run_totals_plain(*serve_args)),
        library_ms=None, bound_ms=bound_ms(8 * serve_args[0].numel() * 4),
        shape="(1, 262144) int32 x 4 in, x 4 out")
    for name, r in res.items():
        if r["max_abs_err"] != 0.0:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version: {r['max_abs_err']}")
    return res


def serve(dev, rs):
    """Phase 3a: 4 requests through Predictor at full width."""
    torch.manual_seed(0)
    model = make_model((16, 5), "resnet101", 16, 512)
    pred = Predictor(model, device="cuda", dtype="bfloat16")
    n_slots = 20 * (32 + 8)
    images = [request_image(h, w, rs) for h, w in SERVE_SIZES]
    pred(images[0])                        # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    latencies = []
    for img in images:
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        r = pred(img)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if delta != PER_REQUEST:
            raise AssertionError(f"request {img.shape}: launches {delta}, "
                                 f"expected {PER_REQUEST}")
        h, w = img.shape[:2]
        ok = (r.ins_map.shape == (h, w) and r.ins_map.dtype == np.int32
              and r.ins_map.min() >= -1 and r.ins_map.max() < n_slots
              and r.labels.shape == (n_slots,) and r.valid.dtype == bool
              and np.isfinite(r.scores).all() and r.seg.shape == (h, w)
              and r.labels.min() >= 0 and r.labels.max() < 20)
        if not ok:
            raise AssertionError(f"request {img.shape}: malformed output")
        log(f"request {h}x{w}: {latencies[-1]:.3f} ms, launches {delta}, "
            f"valid slots {int(r.valid.sum())}, instances "
            f"{len(r.instances())}")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    median = float(np.median(latencies))
    log(f"serving: latency ms {[round(v, 3) for v in latencies]}, "
        f"median {median:.3f} ms, peak memory "
        f"{peak:.1f} MiB, launches over {len(images)} requests {launches}")
    breakdown(pred, images[-1], median)
    return launches


def breakdown(pred, img, median_ms):
    """Where a request's time goes: the model forward alone, and one
    request under torch.profiler (device busy time, the idle share of the
    unprofiled median request, and the kernels with the most device
    time)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros((1, 3, 512, 512), device="cuda").contiguous(
        memory_format=torch.channels_last)

    def model():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            pred.model(x, interpolate=False)
    log(f"model forward alone (1, 3, 512, 512) bf16: "
        f"{time_ms(model, iters=10):.3f} ms (CUDA events)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred(img)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)
    log(f"profiled request: wall {wall_ms:.3f} ms (profiler on), device "
        f"busy {busy_ms:.3f} ms in {sum(e.count for e in rows)} kernels and "
        f"copies, idle share {1 - busy_ms / median_ms:.3f} of the unprofiled "
        f"median request")
    for e in top[:20]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")


def painted(dev, rs):
    """Phase 3b: kernel path vs plain path on a painted scene."""
    seg, center, offset, insts = painted_scene(512, 512, 20, rs)
    args = [torch.from_numpy(a).to(dev) for a in (seg, center, offset)]
    kw = dict(num_classes=20, max_ctr=32, max_cluster=8)
    before = dict(kernels.LAUNCHES)
    got = get_ins_map(*args, **kw)
    used = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    with plain_versions():
        before = dict(kernels.LAUNCHES)
        want = get_ins_map(*args, **kw)
        if kernels.LAUNCHES != before:
            raise AssertionError("the plain path launched a kernel")
    if used != PER_REQUEST:
        raise AssertionError(f"painted scene launches {used}")
    for k in ("ins_map", "label", "valid", "truncated"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"painted scene: {k} differs between the "
                                 f"kernel and the plain path")
    score_err = max_abs_err(got["score"], want["score"])
    if score_err > 1e-6:
        raise AssertionError(f"painted scene: score differs by {score_err}")
    ins = got["ins_map"].cpu().numpy()
    labels = got["label"].cpu().numpy()
    valid = got["valid"].cpu().numpy()
    for c, box in insts:
        ids, counts = np.unique(ins[box], return_counts=True)
        s = ids[np.argmax(counts)]
        iou = (box & (ins == s)).sum() / (box | (ins == s)).sum()
        if s < 0 or not valid[s] or labels[s] != c or iou < 0.99:
            raise AssertionError(f"painted instance of class {c} not found "
                                 f"(slot {s}, iou {iou:.3f})")
    if int(valid.sum()) != len(insts):
        raise AssertionError(f"{int(valid.sum())} valid slots for "
                             f"{len(insts)} painted instances")
    log(f"painted 512x512 scene: {len(insts)} instances found, kernel and "
        f"plain paths equal (score max_abs_err {score_err})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
        f"{kernels.library_path().name}")

    rs = np.random.RandomState(0)
    res = check_kernels(dev, rs)
    launches = serve(dev, rs)
    painted(dev, rs)

    line = []
    for name, r in res.items():
        src, rep = KERNEL_INFO[name]
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched by serving")
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "kernel_ms": r["ms"], "device_ms": r["device_ms"],
                     "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": "bytes",
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
