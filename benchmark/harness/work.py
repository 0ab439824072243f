"""The yardstick's work counts: model FLOPs from the reference's own
modules on the ``meta`` device (``torch.utils.flop_counter``), the least
bytes of each hand-written kernel family's calls, and the table of peaks.

FLOPs count what the step needs: frozen forwards once, trained parts
forward and backward, nothing recomputed. A kernel's bytes are those of
the algorithm's inputs and outputs at the call's shapes, each read once
and each written once, counted from what the step does (its parameters
and shapes), never from the implementation's launches."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import build

# NVIDIA H100 SXM data sheet: dense bfloat16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12

# the port's kernel families by the names of their CUDA kernels
KERNEL_FAMILIES = {
    "topk": r"topk_select_kernel",
    "cc_multilabel": r"\bcc_(local|border|compress)\b",
    "run_totals": r"\brt_(tile_pass|fix_up)\b",
    "stamp": r"\bstamp_tiles\b",
}
FAMILIES_RX = "|".join(f"(?:{p})" for p in KERNEL_FAMILIES.values())

SLOT_BYTES = 13          # valid (1) + y (4) + x (4) + class (4)


def cc_bytes(n_planes: int, h: int, w: int) -> int:
    """int32 class map in, int32 roots out."""
    return 2 * n_planes * h * w * 4


def topk_bytes(rows: int, n: int, k: int) -> int:
    """float32 rows in, k float32 values and int32 indices out a row."""
    return rows * n * 4 + rows * k * 8


def run_totals_bytes(rows: int, n: int) -> int:
    """Four int32 rows in (keys, three payloads), four out."""
    return 8 * rows * n * 4


def stamp_bytes(b: int, k: int, c: int, h: int, w: int) -> int:
    """(B, K) slots in, (B, C, H, W) float32 heatmaps out."""
    return b * k * SLOT_BYTES + b * c * h * w * 4


def phase2_kernel_bytes(cfg: Dict) -> int:
    """One phase-2 step's least kernel bytes: CAM peaks and NMS top-k,
    8- and 4-connected CC, the refinement's run totals, two stamps."""
    b, s = cfg["batch_size"], cfg["crop_size"]
    n_things = sum(cfg["classes"]) - 1
    nc = cfg["classes"][-1]                 # the new classes' rows
    p = cfg["phase2"]
    hw = s * s
    return (topk_bytes(b * nc, hw, p["max_peaks"]) +
            topk_bytes(b * nc, hw, p["max_ctr"]) +
            2 * cc_bytes(b, s, s) + run_totals_bytes(b, hw) +
            stamp_bytes(b, p["max_comp"], n_things, s, s) +
            stamp_bytes(b, nc * (p["max_ctr"] + p["max_cluster"]), n_things,
                        s, s))


def step0_kernel_bytes(cfg: Dict) -> int:
    """One rank's step-0 step: one stamp of `max_inst` slots an image into
    the base step's thing classes."""
    b, s = cfg["batch_size"], cfg["crop_size"]
    return stamp_bytes(b, cfg["step0"]["max_inst"], cfg["classes"][0] - 1,
                       s, s)


def eval_kernel_bytes(cfg: Dict, h: int, w: int) -> int:
    """One validated image's least kernel bytes at its target size:
    8- and 4-connected CC, NMS top-k over every thing class, run totals."""
    n_things = sum(cfg["classes"]) - 1
    return (2 * cc_bytes(1, h, w) +
            topk_bytes(n_things, h * w, cfg["eval"]["max_ctr"]) +
            run_totals_bytes(1, h * w))


def count_flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def phase2_flops(cfg: Dict) -> int:
    """Model FLOPs of one phase-2 step at the configuration's batch: the old
    model's forward, the seg forward on the image and its flip, the
    PseudoLabeler and PeakGenerator, and the instance branch forward and
    backward."""
    with torch.device("meta"):
        mods = build.phase2_modules(cfg)
        x = torch.empty(cfg["batch_size"], 3, cfg["crop_size"],
                        cfg["crop_size"])
        l1h = torch.ones(cfg["batch_size"], sum(cfg["classes"]) - 1)
    for m in mods.values():
        m.eval()
    net = mods["model"]

    def step():
        with torch.no_grad():
            mods["old"](x, interpolate=False)
            _, feats = net.forward_seg(x, interpolate=False)
            net.forward_seg(torch.flip(x, dims=[3]), interpolate=False)
            mods["pg"](mods["pl"](feats["body"]), label=l1h)
        net.decoder.train()
        net.instance_head.train()
        out = net.forward_instance(feats["features"])
        (out["center"].sum() + out["offset"].sum()).backward()
    return count_flops(step)


def step0_flops(cfg: Dict) -> int:
    """Model FLOPs of one rank's step-0 step: the base step's whole model
    forward and backward in train mode at the configuration's batch."""
    with torch.device("meta"):
        net = build.model(cfg, cfg["classes"][:1]).train()
        x = torch.empty(cfg["batch_size"], 3, cfg["crop_size"],
                        cfg["crop_size"])

    def step():
        out = net(x, interpolate=False)
        sum(v.float().sum() for v in out.values()).backward()
    return count_flops(step)


def eval_flops(cfg: Dict, sizes) -> Dict[Tuple[int, int], int]:
    """Model FLOPs of one eval forward at each network input size (H, W)."""
    with torch.device("meta"):
        net = build.model(cfg, cfg["classes"]).eval()
    out = {}
    for h, w in sizes:
        x = torch.empty(1, 3, h, w, device="meta")
        with torch.no_grad():
            out[(h, w)] = count_flops(lambda: net(x, interpolate=False))
    return out
