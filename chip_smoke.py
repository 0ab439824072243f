#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path, its step-0, phase-1 and
phase-2 train steps, the CLI chain of the three on synthetic and on VOC
data, the COCO-to-VOC recipe (WideResNet-38), the multi-step protocols
(VOC 10-5 and 15-1 through step 2), training to accuracy on the painted
fixture, validation, its sample images and test-time augmentation,
serving from a checkpoint, the device-time reader of the profiler's
traces, and data-parallel training over several processes on one NVIDIA
card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which must pass (the script exits non-zero otherwise):
  1. print the card's name and power limit; build the CUDA kernels of
     cl4wsis_tpu_torch/csrc from the checkout;
  2. hold every kernel against its plain PyTorch version on the card at
     the serving and the training shapes (bit-equal; top-k on CAM-like,
     peak-like and NMS rows, CC at connectivity 4 and 8, run totals on
     uniform and step-like rows and where runs meet the tiles' edges, the
     stamp on random slots, on the phase-2 step's own slot sets and on the
     step-0 slots of a synthetic batch; then top-k, CC, run totals and the
     stamp at the COCO-to-VOC chain's shapes: 448^2 with 80 thing classes,
     20 new, and validation's 704^2 bucket), and time kernel, plain
     version and, where one exists, the single PyTorch call computing the
     same function (CUDA events and device time);
  3. serve 4 requests of VOC-native sizes through Predictor on the
     full-width ResNet-101 model (classes (16, 5), random weights from a
     seed, bfloat16), counting the kernel launches of each request; then run
     get_ins_map on a painted 512x512 scene of known instances through the
     kernels and through the plain versions, which must agree exactly and
     find every instance;
  4. run the phase-2 label factory on a painted (16, 512, 512) batch of
     known components, one CAM peak each, through the kernels and through
     the plain versions: equal slots and maps, every component found;
  5. train: 2 warm-up and 5 timed phase-2 steps of the VOC 15-5 step-1
     model (ResNet-101, batch 16 at 512^2, bfloat16 autocast) with the old
     model, PseudoLabeler and PeakGenerator, counting each step's kernel
     launches and the run structure of the key rows the step hands to run
     totals; then one profiled step;
  6. step 0: 2 warm-up and 5 timed steps of the VOC 15-5 base model
     (classes (16,), ResNet-101 with the instance branch, batch 16 at 512^2,
     bfloat16, Adam 5e-5), the stamp launched once a step and bit-equal to
     its plain version on the step's own slots; then one profiled step;
  7. phase 1: 2 warm-up and 5 timed steps of the use_pseudo program (the
     step-1 model and the old model without the instance branch,
     PseudoLabeler, PeakGenerator, PAMR, batch 16 at 512^2, bfloat16, SGD),
     one step of the warm-up program, no kernel launched; then one profiled
     step;
  8. chain: the CLI (cl4wsis_tpu_torch.cli.main.main) three times in this
     process, step 0 -> step 1 phase 1 -> step 1 phase 2, VOC 15-5,
     ResNet-101, batch 16 at 512^2, bfloat16, 4 synthetic batches an
     epoch, from the CLI's default start (flax's init families: the step-0
     trainer's first body conv, a decoder conv and cls.0 at std within 10 %
     of sqrt(1 / fan_in) and inside the truncation bound, their classifier
     biases exactly 0, logged with the step-0 loss and the card),
     checkpoints in a temporary directory removed afterwards; each
     checkpoint written, phase 2's body and seg equal to the phase-1
     checkpoint's and its old model to step 0's, bit for bit; the kernel
     launches of each run held to its steps;
  9. validate: with the phase-2 trainer's model, validate_instances over 8
     painted samples at VOC-native sizes, flip off and on, through the
     kernels and through the plain versions (equal results), and
     validate_semseg in the DeeplabV3 and the phase-1 CAM modes;
 10. real-data chain: a painted mini-VOC written to a temporary directory
     (48 train and 16 validation JPEGs at VOC-native sizes, polygon
     annotations; the mask library built and its RLE held to numpy's on
     its masks), then the CLI three times as in phase 8 on it with
     --dataset voc, 4 loader worker processes and validation after each
     run (instance mAP through the kernels at step 0 and phase 2, the CAM
     mIoU in phase 1): the launches of each run held to its steps and its
     validation, the host wait for each batch, phase 2's body and seg
     equal to phase 1's; the phase-2 model's validation through the
     kernels and the plain versions (equal); Predictor.from_checkpoint on
     the phase-2 checkpoint (and on a copy with raised center biases),
     flip off and on, flip off bit-equal to a Predictor over the
     trainer's model, every to_coco RLE decoding to its mask; the loader
     alone at 0 and 4 workers, a 24-batch window feeding a phase-2 epoch;
 11. COCO-to-VOC chain: a painted mini-COCO (48 train and 16 validation
     JPEGs at 640x480, 480x640 and 640x427, the 60 step-0 classes) and
     mini-VOC written as in phase 10, then the CLI three times with
     --dataset coco-voc --task voc and the recipe's own WideResNet-38 at
     output stride 8, crop 448, validation 512 (batch 16, bf16, 4 loader
     workers, validation after each run), each run's launches, peak
     memory and one more step under torch.profiler; two validation
     forwards profiled; from_checkpoint on the phase-2 checkpoint (center
     biases +0.3) bit-equal to the trainer's model; the phase-2 model's
     validation with those biases through the kernels and the plain
     versions (equal);
 12. the recipe's step-0 train step without and with --remat: peak
     memory and step times, the stamp bit-equal on the step's own slots;
 13. card against CPU: one step 0 and one phase-1 step of a tiny model
     (backbone (1, 1, 1, 1), 64^2, float32, TF32 off; batch 2 for step 0,
     4 for phase 1) on the card and on the CPU from the same weights,
     batch and draws; step 0 also with --norm_act abr and ain and on a
     full-depth ResNet-18;
 14. multi-step: the recipe of scripts/run_10-5.sh (step 0, then phase 1
     -> phase 2 for steps 1 and 2, one --name) through the CLI at full
     width: VOC 10-5 on the painted mini-VOC of phase 10 (4 loader
     workers, validation after each run, --sample_num 2 at step 2's phase
     2, its two PNGs held to the forward's instance maps), the step-2
     model validated through the kernels and the plain versions, TTA of
     its seg logits (scales 0.75, 1, 1.25, flip) on the card against the
     CPU, its traces read by utils/device_time; VOC 15-1 on --synthetic
     (one new class a step), its step-2 phase 2 with phase 5's surgery
     (every image labelled with the new class, a pseudo threshold between
     that class's top two CAM peaks, the seg bias toward it) so that its
     factory stamps valid slots on every step, each step's kernel inputs
     held bit-equal through the plain versions; in each chain step 2's
     phase-2 step's own top-k, CC, run-totals and stamp inputs held
     bit-equal through the plain versions, the old model equal to step
     1's phase-2 checkpoint, phase 2's body and seg to its phase 1's; the
     kernels timed at the one-new-class step's inputs; the launches of
     every run; and in phase 5 the profiled step's Chrome trace through
     utils/device_time (union busy time within 2 % under the summed
     kernel times);
 15. fixture accuracy, in a process of its own that starts after phase 2
     and runs beside phases 3-16 (its steps are bound by the host): the
     painted-fixture protocol of docs/verification.md through
     scripts/run_rebuild_fixture_torch.py's stages and the CLI (48
     painted images at 64^2, batch 4, float32, ResNet-101 at OS16 from
     torch's init (--torch_init), seed 42, 4 loader workers): step 0
     for 250 epochs (Adam 3e-4, validation at e99, e199, e249), phase 1
     and phase 2 for 10 epochs each from its checkpoints; every run rc 0,
     finite losses, its launches held to its steps and validations, step
     0's loss down tenfold and its final mAP@.5 above 0; every phase-2
     step's kernel inputs (the trained models') through the four kernels
     bit-equal to the plain versions, the valid slots its factory
     stamped counted; a traced step a run through utils/device_time. In
     this process, after phase 14, examples/train_synthetic_torch.py for
     300 steps. The `fixture` JSON line: loss trajectories, each
     validation's metrics, step medians, traced device ms, wall seconds,
     the TF32 state, the example's mAP;
 16. dist: (a) the CLI under torch.distributed.run at world 1 with
     CL4WSIS_MULTIHOST=1 and NCCL, one process whose cli.main makes and
     destroys the group in each run: step 0, phase 1, phase 2, phase 2
     resumed with --continue_ckpt, and --test of the phase-2 checkpoint
     with its center biases raised on 8 painted images; the step-0,
     phase-1 and phase-2 epoch losses held to phase 8's. (b) 2 gloo ranks
     sharing the card (NCCL takes one rank a card; this script spawns
     them and makes the group, LOCAL_RANK 0 for both): 3 phase-2 and 3
     step-0 steps at batch 8 each (global 16) at full width in bf16, and
     the tiny model's step 0 and phase 2 at batch 2 each in float32 with
     TF32 off, held against one process at the global batch on the card
     (summed losses, per-tensor updates under SGD), each rank's kernel
     launches counted; the CLI chain at 2 ranks with --tiny, and --test
     of the same lifted checkpoint, whose merged validation must equal
     world 1's;
 17. realdata_kit, in the fixture's process after its protocol: the
     port's real-data parity kit (scripts/run_realdata_parity_torch.py)
     on the painted mini-VOC of phase 10 in the real-data layout, with a
     seeded random-weight ResNet-101 iABN ImageNet file in upstream's
     layout ('module.' keys, classifier.fc, negative BN weights, a numpy
     float64 best_prec1 and the epoch beside state_dict): --run check
     exits 0 with every row the port reads OK and the body covered, and
     1 for a copy without one body key and for the file under a wrong
     name; --run port --epochs_scale 0.01 runs its three CLI stages (1
     epoch each at the recipe's full width: ResNet-101, OS16, batch 16,
     512^2, 4 loader workers, the pretrained body, phase 2's factory
     through the kernels) as processes of its own, each rc 0, each
     stage's mAP read from its output equal to its JSONL record to 4
     decimals, RB_0 and RB_1 where the next stage reads them. Then, in
     this process, the step-0 Trainer of the kit's own step-0 argv on
     the card: every body tensor equal to the file's converted tensors,
     bit for bit, before any step. The `realdata_kit` JSON line;
 18. print the kernels line (JSON) and, last, the ok line (JSON).
Without a CUDA device it exits non-zero before printing any result. The
dist and fixture phases run this file again as their worker processes,
with arguments.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import inspect
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from cl4wsis_tpu_torch.cl import tasks
from cl4wsis_tpu_torch.cl.ckpt import load_checkpoint, load_torch_pretrained
from cl4wsis_tpu_torch.cli import main as cli
from cl4wsis_tpu_torch.core import abn
from cl4wsis_tpu_torch.data.fixture import write_fake_iabn
from cl4wsis_tpu_torch.data.synthetic import synthetic_batches
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.models.flax_init import TRUNC_STD, fan_in
from cl4wsis_tpu_torch.ops import cc, kernels, labelgen, segsort, topk
from cl4wsis_tpu_torch.ops.instance_postproc import get_ins_map
from cl4wsis_tpu_torch.ops.peaks import peak_extract_nchw, smoothing
from cl4wsis_tpu_torch.ops.resize import resize_bilinear
from cl4wsis_tpu_torch.serve import Predictor
from cl4wsis_tpu_torch.train import phase1, phase2, schedule, step0
from cl4wsis_tpu_torch.train.eval import validate_instances, validate_semseg
from cl4wsis_tpu_torch.train.state import TrainState
from cl4wsis_tpu_torch.train.trainer import pretrained_name
from cl4wsis_tpu_torch.utils import device_time
from cl4wsis_tpu_torch.utils.visualize import sample_image
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
SERVE_SIZES = ((375, 500), (500, 375), (500, 333), (512, 512))  # (H, W)
PER_REQUEST = {"cc_multilabel": 2, "topk": 1, "run_totals": 1, "stamp": 0,
               "cc_binary": 0}
PER_STEP = {"cc_multilabel": 2, "topk": 2, "run_totals": 1, "stamp": 2,
            "cc_binary": 0}
PER_FACTORY = dict(PER_STEP, topk=1)       # the CAM peaks are outside it
PER_STEP0 = dict.fromkeys(PER_STEP, 0) | {"stamp": 1}
PER_PHASE1 = dict.fromkeys(PER_STEP, 0)
OLD, NEW = 16, 5                           # VOC 15-5, step 1
B, S = 16, 512                             # batch, crop
MAX_INST = 50                              # step 0's instance slots
WARMUP_STEPS, TIMED_STEPS = 2, 5
# the COCO-to-VOC recipe: WideResNet-38 at output stride 8, crop 448,
# validation 512 (a 512 x 683 image pads to its 704^2 bucket); step 0 has
# 60 thing classes, step 1 adds 20
COCO_VOC = (61, 20)
WRN_KW = dict(backbone="wider_resnet38_a2", output_stride=8, crop_size=448)
S_WRN, S_WRN_VAL, VAL_BUCKET = 448, 512, 704
C0_WRN, NEW_WRN = COCO_VOC[0] - 1, COCO_VOC[1]
C_WRN = C0_WRN + NEW_WRN
KERNEL_INFO = {
    "topk": ("cl4wsis_tpu_torch/csrc/topk.cu",
             "cl4wsis_tpu/ops/pallas_topk.py:94"),
    "cc_multilabel": ("cl4wsis_tpu_torch/csrc/cc.cu",
                      "cl4wsis_tpu/ops/pallas_cc.py:297"),
    "run_totals": ("cl4wsis_tpu_torch/csrc/run_totals.cu",
                   "cl4wsis_tpu/ops/pallas_seg.py:124"),
    "stamp": ("cl4wsis_tpu_torch/csrc/stamp.cu",
              "cl4wsis_tpu/ops/pallas_stamp.py:90"),
    "cc_binary": ("cl4wsis_tpu_torch/csrc/cc.cu",
                  "cl4wsis_tpu/ops/pallas_cc.py:176"),
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
    us = 0
    for _ in range(3):      # a profile now and then loses rows, or all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = kernel_rows(prof)
        us = sum(e.self_device_time_total for e in rows)
        if us > 0 and all(e.count % iters == 0 for e in rows):
            break
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


def peak_rows(B, N, rs):
    """Rows like the CAM peak planes `heat * keep`: 0.0 where the max pool
    rejects a pixel (-0.0 where the heat is negative), a few peaks, a row
    with no peak and a row of fewer peaks than k."""
    x = np.zeros((B, N), np.float32)
    for b in range(B):
        pos = rs.choice(N, rs.randint(0, 200), replace=False)
        x[b, pos] = rs.rand(len(pos)).astype(np.float32)
    x[1] = 0.0
    x[2, rs.rand(N) < 0.3] = -0.0
    x[3] = 0.0
    x[3, [5, 8191, 8192, 200000]] = 0.5
    return x


def runs_of(lengths):
    """Sorted int32 keys with the given run lengths."""
    return np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)


def step_like_rows(nb, N, rs):
    """Key rows as the refinement hands them to run totals: the sorted
    roots of a few hundred small components (runs of 10-40 elements), then
    one run at the top key N over at least 90 % of the row."""
    rows = []
    for _ in range(nb):
        short = rs.randint(10, 41, N // 100)
        keys = np.repeat(3 * np.arange(len(short)), short)
        keys = keys[:rs.randint(N // 100, N // 10)]
        rows.append(np.concatenate([keys, np.full(N - len(keys), N)]))
    return np.stack(rows).astype(np.int32)


def run_totals_edge_cases(tile, rs):
    """Small key rows where the tiled passes meet their edges."""
    return {
        "single run": np.full((3, 5 * tile + 40), 11, np.int32),
        "all distinct": np.arange(3 * tile + 8, dtype=np.int32)[None].repeat(2, 0),
        "runs of one tile": runs_of([tile] * 5)[None],
        "runs of one tile + 1": runs_of([tile + 1] * 5)[None],
        "runs of one tile - 1": runs_of([tile - 1] * 5)[None],
        "runs ending on tile edges": runs_of(
            [tile // 2, tile // 2, 40 * tile, 1, tile - 1, 2 * tile, 5])[None],
        "N = 1": np.zeros((2, 1), np.int32),
        "N = tile - 1": np.sort(rs.randint(0, 9, (2, tile - 1))).astype(np.int32),
        "N = tile + 1": np.sort(rs.randint(0, 9, (2, tile + 1))).astype(np.int32),
    }


def run_totals_args(dev, rs, keys, payloads=None):
    """Sorted int32 key rows and three payloads (random unless given) on
    the card."""
    if payloads is None:
        payloads = [rs.randint(0, 512, keys.shape) for _ in range(3)]
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
            for a in [keys] + payloads]


def step_slots(name, rs, nb, K, H, W, C):
    """The two slot sets a phase-2 step stamps: "pseudo", 1-3 valid slots
    an image, and "refined" under random center heads, none valid."""
    cy = rs.uniform(0, H, (nb, K)).astype(np.float32)
    cx = rs.uniform(0, W, (nb, K)).astype(np.float32)
    cls = rs.randint(0, C, (nb, K)).astype(np.int32)
    valid = np.zeros((nb, K), bool)
    if name == "pseudo":
        for b in range(nb):
            valid[b, rs.choice(K, rs.randint(1, 4), replace=False)] = True
    return valid, cy, cx, cls


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


def painted_factory_batch(rs, n_comp=6, cell=128):
    """(16, 512, 512) inputs of the label factory with known answers: in
    every image `n_comp` rectangles of new classes in distinct grid cells,
    each holding exactly one CAM peak, with a gaussian center and offsets
    toward it; the rest background. Every component must be accepted."""
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
    C = OLD + NEW - 1
    seg = np.zeros((B, S, S), np.int32)
    center = np.zeros((B, C, S, S), np.float32)
    offset = rs.uniform(-20, 20, (B, 2, S, S)).astype(np.float32)
    pys = np.zeros((B, C, 25), np.int32)
    pxs = np.zeros((B, C, 25), np.int32)
    pvalid = np.zeros((B, C, 25), bool)
    label = np.zeros((B, C), np.float32)
    for b in range(B):
        cells = rs.choice((S // cell) ** 2, n_comp, replace=False)
        n_pk = np.zeros(C, int)
        for c_id in cells:
            gy, gx = divmod(int(c_id), S // cell)
            cy = gy * cell + cell // 2 + rs.randint(-8, 9)
            cx = gx * cell + cell // 2 + rs.randint(-8, 9)
            ry, rx = rs.randint(10, 40, 2)
            c = rs.randint(OLD - 1, C)
            box = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
            seg[b][box] = c + 1
            center[b, c] = np.maximum(center[b, c], rs.uniform(0.5, 1.0) *
                                      np.exp(-((yy - cy) ** 2 +
                                               (xx - cx) ** 2) / 18.0))
            offset[b, 0][box] = (cy - yy)[box]
            offset[b, 1][box] = (cx - xx)[box]
            pys[b, c, n_pk[c]], pxs[b, c, n_pk[c]] = cy, cx
            pvalid[b, c, n_pk[c]] = True
            n_pk[c] += 1
            label[b, c] = 1.0
    soft = np.full((B, C + 1, S, S), 0.02, np.float32)
    onehot = (seg[:, None] == np.arange(C + 1)[None, :, None, None])
    soft += 0.6 * onehot
    soft /= soft.sum(1, keepdims=True)
    soft[:, 1:] *= label[:, :, None, None]
    return (seg, label, pys, pxs, pvalid, soft, center, offset), B * n_comp


@contextlib.contextmanager
def plain_versions():
    """Route every kernel call of the serving path and of the train step's
    label factory to its plain PyTorch version, for the same-card
    comparison of the whole post-processing."""
    saved = (cc.connected_components_multilabel, topk.topk_hier,
             segsort.run_totals, labelgen.stamp_centers_batched)
    cc.connected_components_multilabel = cc.cc_multilabel_plain
    topk.topk_hier = topk.topk_plain
    segsort.run_totals = segsort.run_totals_plain
    labelgen.stamp_centers_batched = labelgen.stamp_centers
    try:
        yield
    finally:
        (cc.connected_components_multilabel, topk.topk_hier,
         segsort.run_totals, labelgen.stamp_centers_batched) = saved


@contextlib.contextmanager
def watching_run_totals():
    """While open, keep the run structure of every batch of key rows that
    segsort.run_totals is given: runs per row, the longest run per row and
    the row length (device tensors; read them after a synchronize)."""
    rows = []
    real = segsort.run_totals

    def watching(skey, *a):
        out = real(skey, *a)
        rows.append((segsort.run_starts(skey).sum(1), out[0].max(1).values,
                     skey.shape[1]))
        return out

    segsort.run_totals = watching
    try:
        yield rows
    finally:
        segsort.run_totals = real


def log_run_structure(what, rows):
    for i, (n_runs, longest, n) in enumerate(rows):
        n_runs, share = n_runs.cpu().numpy(), longest.cpu().numpy() / n
        log(f"{what} {i}: run totals got {len(n_runs)} key rows of {n}: runs "
            f"per row min {n_runs.min()}, median "
            f"{int(np.median(n_runs))}, max {n_runs.max()}; the longest "
            f"run's share of its row min {share.min():.4f}, median "
            f"{float(np.median(share)):.4f}, max {share.max():.4f}")


# ----------------------------------------------------------------- phases

def timings(kernel, plain, library=None, plain_iters=5):
    return dict(ms=time_ms(kernel), device_ms=device_ms(kernel),
                plain_ms=time_ms(plain, iters=plain_iters),
                library_ms=None if library is None else time_ms(library),
                library_device_ms=(None if library is None
                                   else device_ms(library)))


def check_kernels(dev, rs):
    """Phase 2: every kernel against its plain version; returns per-kernel
    results for the kernels line. Each kernel is timed at the phase-2
    step's shapes ("ms" and friends) and, for the serving kernels, at the
    request's shapes ("serving")."""
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
        [blobby(512, 512, 20, rs, cell=c) for c in (8, 16, 32, 64)] * 4
    ).astype(np.int32)).to(dev)
    for conn in (4, 8):
        e = max_abs_err(cc.cc_multilabel_cuda(batch, conn),
                        cc.cc_multilabel_plain(batch, conn))
        log(f"cc batched (16, 512, 512) conn={conn}: max_abs_err {e}")
        err = max(err, e)
    t = torch.from_numpy(maps["blobby"].astype(np.int32)).to(dev)
    res["cc_multilabel"] = dict(
        max_abs_err=err, bound_ms=bound_ms(2 * batch.numel() * 4),
        shape="(16, 512, 512) int32, connectivity 8, blobby 20-class maps",
        **timings(lambda: cc.cc_multilabel_cuda(batch, 8),
                  lambda: cc.cc_multilabel_plain(batch, 8), plain_iters=2),
        connectivity_4=dict(
            shape="(16, 512, 512) int32, connectivity 4 (the step's second "
                  "call), blobby 20-class maps",
            bound_ms=bound_ms(2 * batch.numel() * 4),
            **timings(lambda: cc.cc_multilabel_cuda(batch, 4),
                      lambda: cc.cc_multilabel_plain(batch, 4),
                      plain_iters=2)),
        serving=dict(shape="(512, 512) int32, connectivity 8, blobby",
                     bound_ms=bound_ms(2 * t.numel() * 4),
                     **timings(lambda: cc.cc_multilabel_cuda(t, 8),
                               lambda: cc.cc_multilabel_plain(t, 8))))

    # binary CC: 512^2 masks, single and batched, bool and uint8
    err = 0.0
    masks = [torch.from_numpy(m > 0).to(dev) for m in maps.values()]
    mbatch = torch.from_numpy(np.stack(
        [blobby(512, 512, 1, rs, cell=c) > 0 for c in (4, 8, 16, 32)] * 4)
    ).to(dev)
    for m in masks + [mbatch, mbatch.to(torch.uint8) * 5]:
        for conn in (4, 8):
            e = max_abs_err(cc.connected_components(m, conn),
                            cc.cc_binary_plain(m, conn))
            err = max(err, e)
    log(f"cc_binary 3 masks 512x512 and (16, 512, 512) bool/uint8, conn 4 "
        f"and 8: max_abs_err {err}")
    m0 = masks[0]
    res["cc_binary"] = dict(
        max_abs_err=err, bound_ms=bound_ms(m0.numel() * (1 + 4)),
        shape="(512, 512) bool, connectivity 8, blobby mask",
        **timings(lambda: cc.cc_binary_cuda(m0, 8),
                  lambda: cc.cc_binary_plain(m0, 8)))

    # top-k: CAM-like and peak-like rows (80, 262144) k 25 and NMS rows
    # k 16 (training); NMS rows (20, 262144) k 32 (serving). Equality is
    # bitwise, so +0.0 and -0.0 must not be swapped.
    x = torch.from_numpy(nms_rows(20, 512 * 512, rs)).to(dev)
    cam = torch.from_numpy(rs.rand(80, 512 * 512).astype(np.float32)
                           ** 8).to(dev)
    peaks80 = torch.from_numpy(peak_rows(80, 512 * 512, rs)).to(dev)
    nms80 = torch.from_numpy(nms_rows(80, 512 * 512, rs)).to(dev)
    err = 0.0
    for rows, k in ((x, 32), (cam, 25), (peaks80, 25), (nms80, 16),
                    (cam[:, :5000].contiguous(), 7)):
        gv, gi = topk.topk_cuda(rows, k)
        pv, pi = topk.topk_plain(rows, k)
        e = max(max_abs_err(gv, pv), max_abs_err(gi, pi))
        if not torch.equal(gv.view(torch.int32), pv.view(torch.int32)):
            e = float("inf")        # a signed zero swapped, say
        log(f"topk {tuple(rows.shape)} k={k}: max_abs_err {e}")
        err = max(err, e)

    def topk_case(rows, k, shape):
        return dict(shape=shape, bound_ms=bound_ms(rows.numel() * 4 +
                                                   rows.shape[0] * k * 8),
                    **timings(lambda: topk.topk_cuda(rows, k),
                              lambda: topk.topk_plain(rows, k),
                              lambda: torch.topk(rows, k)))
    res["topk"] = dict(
        max_abs_err=err,
        **topk_case(cam, 25, "(80, 262144) float32, k 25, CAM-like rows"),
        cases=[topk_case(peaks80, 25, "(80, 262144) float32, k 25, "
                                      "peak-like rows (mostly 0.0)"),
               topk_case(nms80, 16, "(80, 262144) float32, k 16, NMS rows "
                                    "(mostly -1.0)")],
        serving=topk_case(x, 32, "(20, 262144) float32, k 32, NMS-like rows"))
    for r in [res["topk"], *res["topk"]["cases"], res["topk"]["serving"]]:
        log(f"topk {r['shape']}: {r['device_ms']} ms device, torch.topk "
            f"{r['library_device_ms']} ms device")

    # run totals: (1, 262144) serving, (16, 262144) training on uniform
    # keys (runs of ~6.5) and on step-like rows (one run over >= 90 % of a
    # row), and small rows where runs meet the tiles' edges
    def rt_check(args, what):
        got = segsort.run_totals_cuda(*args)
        want = segsort.run_totals_plain(*args)
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        log(f"run_totals {what}: max_abs_err {e}")
        return e

    def rt_args(keys, payloads=None):
        return run_totals_args(dev, rs, keys, payloads)

    def rt_case(args, shape):
        return dict(shape=shape, bound_ms=bound_ms(8 * args[0].numel() * 4),
                    **timings(lambda: segsort.run_totals_cuda(*args),
                              lambda: segsort.run_totals_plain(*args)))
    err = 0.0
    for nb, n_keys in ((1, 3000), (16, 40000), (1, 1)):
        keys = np.sort(rs.randint(0, n_keys, (nb, 512 * 512)), axis=1)
        args = rt_args(keys)
        err = max(err, rt_check(args, f"({nb}, 262144) keys<{n_keys}"))
        if n_keys == 3000:
            serve_args = args
        if nb == 16:
            train_args = args
    step_keys = step_like_rows(16, 512 * 512, rs)
    yx = np.broadcast_to(np.arange(512 * 512), step_keys.shape)
    step_args = rt_args(step_keys, [yx // 512, yx % 512,
                                    np.zeros_like(step_keys)])
    err = max(err, rt_check(step_args, "(16, 262144) step-like rows"))
    tile = kernels.lib().cl4_run_totals_tile()
    for name, keys in run_totals_edge_cases(tile, rs).items():
        err = max(err, rt_check(rt_args(keys), f"{keys.shape} {name}"))
        wrap = [rs.choice([-1, 1], keys.shape) * (2 ** 30 - rs.randint(
            0, 9, keys.shape)) for _ in range(2)] + [np.full(keys.shape,
                                                             2 ** 30)]
        err = max(err, rt_check(rt_args(keys, wrap),
                                f"{keys.shape} {name}, sums wrapping int32"))
    res["run_totals"] = dict(
        max_abs_err=err,
        **rt_case(train_args, "(16, 262144) int32 x 4 in, x 4 out, uniform "
                              "keys (runs of ~6.5)"),
        cases=[rt_case(step_args, "(16, 262144) int32 x 4 in, x 4 out, "
                                  "step-like rows (one run over >= 90 %)")],
        serving=rt_case(serve_args, "(1, 262144) int32 x 4 in, x 4 out"))
    for r in [res["run_totals"], *res["run_totals"]["cases"],
              res["run_totals"]["serving"]]:
        log(f"run_totals {r['shape']}: {r['device_ms']} ms device, "
            f"{r['ms']} ms events, bound {r['bound_ms']:.6f} ms")

    # stamp: (16, K) slots -> (16, 20, 512, 512), K 64 (pseudo) and 120
    # (refined), sigma 6 and 30 (past the Pallas kernel's 21), slots on
    # every border, off the plane, invalid, class ids out of range
    err = 0.0
    C = OLD + NEW - 1
    for K in (64, 120):
        args = [torch.from_numpy(a).to(dev)
                for a in border_slots(rs, B, K, S, S, C)]
        for sigma in (6, 30):
            got = labelgen.stamp_centers_cuda(*args, C, sigma, (S, S))
            e = max_abs_err(got, labelgen.stamp_centers(*args, C, sigma,
                                                        (S, S)))
            log(f"stamp (16, {K}) slots -> (16, 20, 512, 512) sigma {sigma}: "
                f"max_abs_err {e}, max {float(got.max())}")
            err = max(err, e)
            if K == 120 and sigma == 6:
                stamp_args = args
    out_bytes = B * C * S * S * 4

    def stamp_case(args, sigma, shape):
        K = args[0].shape[1]
        return dict(shape=shape, bound_ms=bound_ms(out_bytes + K * B * 13),
                    **timings(lambda: labelgen.stamp_centers_cuda(
                                  *args, C, sigma, (S, S)),
                              lambda: labelgen.stamp_centers(
                                  *args, C, sigma, (S, S))))
    cases = []
    for name, K in (("pseudo", 64), ("refined", 120)):
        args = [torch.from_numpy(a).to(dev)
                for a in step_slots(name, rs, B, K, S, S, C)]
        e = max_abs_err(labelgen.stamp_centers_cuda(*args, C, 6, (S, S)),
                        labelgen.stamp_centers(*args, C, 6, (S, S)))
        log(f"stamp (16, {K}) {name} slots of a step, "
            f"{int(args[0].sum())} valid: max_abs_err {e}")
        err = max(err, e)
        cases.append(stamp_case(args, 6, (
            f"(16, {K}) slots, {int(args[0].sum())} valid (the step's {name} "
            f"stamp) -> (16, 20, 512, 512) float32, sigma 6")))
    # the step-0 step's stamp: the slots of a synthetic batch's instances
    C0 = OLD - 1
    batch0 = step0_batches(dev, 1)[0]
    count, cy, cx, cls = labelgen.batched_instance_stats(
        batch0["inst"], batch0["seg"], MAX_INST)
    s0 = (count > 0, cy, cx, cls)
    e = max_abs_err(labelgen.stamp_centers_cuda(*s0, C0, 6, (S, S)),
                    labelgen.stamp_centers(*s0, C0, 6, (S, S)))
    log(f"stamp (16, {MAX_INST}) step-0 slots of a synthetic batch, "
        f"{int(s0[0].sum())} valid -> (16, 15, 512, 512): max_abs_err {e}")
    err = max(err, e)
    step0_case = dict(
        shape=f"(16, {MAX_INST}) slots, {int(s0[0].sum())} valid (the step-0 "
              f"stamp of a synthetic batch) -> (16, 15, 512, 512) float32, "
              f"sigma 6",
        bound_ms=bound_ms(B * C0 * S * S * 4 + MAX_INST * B * 13),
        **timings(lambda: labelgen.stamp_centers_cuda(*s0, C0, 6, (S, S)),
                  lambda: labelgen.stamp_centers(*s0, C0, 6, (S, S))))
    res["stamp"] = dict(
        max_abs_err=err, cases=cases, step0=step0_case,
        **stamp_case(stamp_args, 6, "(16, 120) slots -> (16, 20, 512, 512) "
                                    "float32, sigma 6"))
    for r in [res["stamp"], *cases, step0_case]:
        log(f"stamp {r['shape']}: {r['device_ms']} ms device, {r['ms']} ms "
            f"events, bound {r['bound_ms']:.6f} ms")

    def wide():
        return labelgen.stamp_centers_cuda(*stamp_args, C, 30, (S, S))
    log(f"stamp (16, 120) slots, sigma 30 (183 x 183 windows): "
        f"{device_ms(wide, iters=3)} ms device, "
        f"{time_ms(wide, iters=3, warmup=1)} ms events")
    planes = torch.empty((B, C, S, S), dtype=torch.float32, device=dev)
    log(f"yardstick, out.zero_() on (16, 20, 512, 512) float32: "
        f"{device_ms(planes.zero_)} ms device, {time_ms(planes.zero_)} ms "
        f"events (a fill, not the stamp; the bound at 3.35 TB/s is "
        f"{bound_ms(out_bytes):.6f} ms)")
    del planes
    for name, r in res.items():
        if r["max_abs_err"] != 0.0:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version: {r['max_abs_err']}")
    for name, cases in check_kernels_coco_voc(dev, rs).items():
        res[name]["coco_voc"] = cases
    return res


def check_kernels_coco_voc(dev, rs):
    """Phase 2, continued: the four production kernels at the COCO-to-VOC
    chain's shapes (WideResNet-38 at 448^2, 80 thing classes of which 20
    new; validation images of 512 x 683 padded to their 704^2 bucket),
    each bit-equal to its plain version, timed. Returns per kernel the
    list of its cases."""
    N, NV = S_WRN * S_WRN, VAL_BUCKET * VAL_BUCKET
    res = {k: [] for k in ("cc_multilabel", "topk", "run_totals", "stamp")}

    def case(name, shape, err, n_bytes, kernel, plain, library=None,
             plain_iters=5):
        if err != 0.0:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version at {shape}: {err}")
        r = dict(shape=shape, max_abs_err=err, bound_ms=bound_ms(n_bytes),
                 **timings(kernel, plain, library, plain_iters))
        res[name].append(r)
        log(f"{name} at {shape}: max_abs_err 0.0, {r['device_ms']} ms "
            f"device, {r['ms']} ms events, plain {r['plain_ms']} ms, bound "
            f"{r['bound_ms']:.6f} ms")

    # CC: the phase-2 class maps at both connectivities; a validation map
    maps = torch.from_numpy(np.stack(
        [blobby(S_WRN, S_WRN, C_WRN, rs, cell=c) for c in (8, 16, 32, 64)]
        * 4).astype(np.int32)).to(dev)
    for conn in (8, 4):
        case("cc_multilabel", f"(16, 448, 448) int32, connectivity {conn}, "
             f"blobby 80-class maps (phase 2)",
             max_abs_err(cc.cc_multilabel_cuda(maps, conn),
                         cc.cc_multilabel_plain(maps, conn)),
             2 * maps.numel() * 4, lambda: cc.cc_multilabel_cuda(maps, conn),
             lambda: cc.cc_multilabel_plain(maps, conn), plain_iters=2)
    vmap = blobby(VAL_BUCKET, VAL_BUCKET, C_WRN, rs)
    vmap[512:], vmap[:, 683:] = 0, 0          # the bucket's pad: background
    vmap = torch.from_numpy(vmap.astype(np.int32)).to(dev)
    case("cc_multilabel", "(704, 704) int32, connectivity 8, blobby 80-class "
         "map of a 512 x 683 image in its bucket (validation)",
         max_abs_err(cc.cc_multilabel_cuda(vmap, 8),
                     cc.cc_multilabel_plain(vmap, 8)),
         2 * vmap.numel() * 4, lambda: cc.cc_multilabel_cuda(vmap, 8),
         lambda: cc.cc_multilabel_plain(vmap, 8))
    del maps, vmap

    # top-k: the phase-2 CAM peaks (20 new classes x 16 images, k 25), the
    # refinement's NMS rows (k 16), validation's NMS rows (80 classes, k 32)
    nr = B * NEW_WRN
    for rows, k, what in (
            (rs.rand(nr, N).astype(np.float32) ** 8, 25,
             "CAM-like rows (phase-2 CAM peaks)"),
            (peak_rows(nr, N, rs), 25, "peak-like rows (mostly 0.0)"),
            (nms_rows(nr, N, rs), 16, "NMS rows (phase-2 refinement)"),
            (nms_rows(C_WRN, NV, rs), 32, "NMS rows (validation)")):
        rows = torch.from_numpy(rows).to(dev)
        gv, gi = topk.topk_cuda(rows, k)
        pv, pi = topk.topk_plain(rows, k)
        err = max(max_abs_err(gv, pv), max_abs_err(gi, pi))
        if not torch.equal(gv.view(torch.int32), pv.view(torch.int32)):
            err = float("inf")        # a signed zero swapped, say
        case("topk", f"{tuple(rows.shape)} float32, k {k}, {what}", err,
             rows.numel() * 4 + rows.shape[0] * k * 8,
             lambda: topk.topk_cuda(rows, k), lambda: topk.topk_plain(rows, k),
             lambda: torch.topk(rows, k))
    del rows, gv, gi, pv, pi

    # run totals: the refinement's (16, 448^2) rows, uniform and step-like
    # (the pixel's y and x as payloads); validation's (1, 704^2)
    yx = np.broadcast_to(np.arange(N), (B, N))
    for args, what in (
            (run_totals_args(dev, rs, np.sort(
                rs.randint(0, 40000, (B, N)), axis=1)),
             "uniform keys (runs of ~5)"),
            (run_totals_args(dev, rs, step_like_rows(B, N, rs),
                             [yx // S_WRN, yx % S_WRN, np.zeros_like(yx)]),
             "step-like rows (one run over >= 90 %)"),
            (run_totals_args(dev, rs, np.sort(
                rs.randint(0, 3000, (1, NV)), axis=1)), "validation")):
        got = segsort.run_totals_cuda(*args)
        want = segsort.run_totals_plain(*args)
        case("run_totals", f"{tuple(args[0].shape)} int32 x 4 in, x 4 out, "
             f"{what}", max(max_abs_err(g, w) for g, w in zip(got, want)),
             8 * args[0].numel() * 4,
             lambda: segsort.run_totals_cuda(*args),
             lambda: segsort.run_totals_plain(*args))
    del args, got, want

    # stamp: phase 2's pseudo (64 slots an image) and refined (20 new
    # classes x (16 + 8)) slot sets -> (16, 80, 448, 448); border cases;
    # step 0's slots of a synthetic batch -> (16, 60, 448, 448)
    size = (S_WRN, S_WRN)

    def stamp_case(slots, C, what):
        K = slots[0].shape[1]
        case("stamp", f"(16, {K}) slots, {int(slots[0].sum())} valid ({what})"
             f" -> (16, {C}, 448, 448) float32, sigma 6",
             max_abs_err(labelgen.stamp_centers_cuda(*slots, C, 6, size),
                         labelgen.stamp_centers(*slots, C, 6, size)),
             B * C * N * 4 + K * B * 13,
             lambda: labelgen.stamp_centers_cuda(*slots, C, 6, size),
             lambda: labelgen.stamp_centers(*slots, C, 6, size),
             plain_iters=2)
    K_refined = NEW_WRN * 24
    border = [torch.from_numpy(a).to(dev) for a in
              border_slots(rs, B, K_refined, S_WRN, S_WRN, C_WRN)]
    e = max_abs_err(labelgen.stamp_centers_cuda(*border, C_WRN, 6, size),
                    labelgen.stamp_centers(*border, C_WRN, 6, size))
    log(f"stamp (16, {K_refined}) slots on every border -> (16, 80, 448, "
        f"448): max_abs_err {e}")
    if e != 0.0:
        raise AssertionError("the stamp disagrees with its plain version on "
                             "the border slots at 448^2")
    for name, K in (("pseudo", 64), ("refined", K_refined)):
        stamp_case([torch.from_numpy(a).to(dev) for a in
                    step_slots(name, rs, B, K, S_WRN, S_WRN, C_WRN)],
                   C_WRN, f"the phase-2 step's {name} stamp")
    b0 = next(synthetic_batches(B, S_WRN, C0_WRN, seed=0, n_batches=1))
    count, cy, cx, cls = labelgen.batched_instance_stats(
        torch.from_numpy(b0["inst"]).to(dev),
        torch.from_numpy(b0["seg"]).to(dev), MAX_INST)
    stamp_case((count > 0, cy, cx, cls), C0_WRN,
               "the step-0 stamp of a synthetic batch")
    return res


def border_slots(rs, nb, K, H, W, C):
    """Random slots plus one on every border and corner, off-plane centers,
    invalid slots and class ids out of range (numpy)."""
    cy = rs.uniform(0, H, (nb, K)).astype(np.float32)
    cx = rs.uniform(0, W, (nb, K)).astype(np.float32)
    cy[:, :8] = [0.0, H - 0.5, 0.0, H - 1, 0.2, H - 1, H / 2, H / 2]
    cx[:, :8] = [0.0, 0.0, W - 0.5, W - 1, W / 2, W / 2, 0.7, W - 0.1]
    cy[:, 8:12] = [-1.0, H + 0.5, 10.0, -0.001]
    cx[:, 8:12] = [10.0, 10.0, W + 3.0, 10.0]
    cls = rs.randint(0, C, (nb, K)).astype(np.int32)
    cls[:, 12], cls[:, 13] = C + 5, -3
    valid = rs.rand(nb, K) > 0.25
    valid[:, :14] = True
    return valid, cy, cx, cls


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


def painted_factory(dev, rs):
    """Phase 4: the label factory through the kernels and through the plain
    versions on a painted batch of known components."""
    arrays, n_known = painted_factory_batch(rs)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    kw = dict(num_classes=OLD + NEW - 1, first_class=OLD - 1)
    before = dict(kernels.LAUNCHES)
    with watching_run_totals() as key_rows:
        got = phase2.label_factory(*args, **kw)
    torch.cuda.synchronize()
    log_run_structure("painted factory batch, call", key_rows)
    used = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    if used != PER_FACTORY:
        raise AssertionError(f"label factory launches {used}, expected "
                             f"{PER_FACTORY}")
    with plain_versions():
        before = dict(kernels.LAUNCHES)
        want = phase2.label_factory(*args, **kw)
        if kernels.LAUNCHES != before:
            raise AssertionError("the plain label factory launched a kernel")

    def leaves(out, prefix=""):
        for k, v in out.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + ".")
            elif isinstance(v, tuple):
                for i, t in enumerate(v):
                    yield f"{prefix}{k}[{i}]", t
            else:
                yield prefix + k, v

    want_leaves = dict(leaves(want))
    for name, t in leaves(got):
        if not torch.equal(t, want_leaves[name]):
            raise AssertionError(f"label factory: {name} differs between the "
                                 f"kernel and the plain path")
    found = int(got["n_match"].sum())
    slots = int(got["p_slots"][0].sum())
    refined = int(got["refined"]["stamp_valid"].sum())
    if found != n_known or slots != n_known:
        raise AssertionError(f"label factory accepted {found} components "
                             f"({slots} slots) of {n_known} painted")
    log(f"painted factory batch (16, 512, 512): {found} of {n_known} "
        f"components accepted, {refined} refined slots, launches {used}; "
        f"kernel and plain paths equal in all {len(want_leaves)} outputs")
    log(f"label factory alone on the painted batch: "
        f"{time_ms(lambda: phase2.label_factory(*args, **kw), iters=5):.3f} "
        f"ms (CUDA events)")


def build_training(dev):
    """The full-width models (random weights from a seed), the optimizer of
    bench_phase2 (Adam 5e-5, poly over 10000, groups 0/0/10/0) and two
    synthetic batches with every new class labelled."""
    torch.manual_seed(0)
    model = make_model((OLD, NEW), "resnet101", 16, S)
    model_old = make_model((OLD,), "resnet101", 16, S)
    pl = PseudoLabeler(OLD + NEW)
    pg = PeakGenerator(OLD + NEW - 1, OLD - 1)
    with torch.no_grad():
        pg.extra_conv4.bias += 0.5     # a CAM that relu does not zero out
    for m in (model, model_old, pl, pg):
        m.to(dev, memory_format=torch.channels_last).eval()
    opt = schedule.make_optimizer(model, "adam", group_scale={
        "body": 0.0, "seg": 0.0, "instance": 10.0, "pseudo": 0.0})
    state = TrainState(model, opt, schedule.make_schedule("poly", 5e-5, 10000))
    batches = []
    for b in synthetic_batches(B, S, OLD + NEW - 1, seed=0, n_batches=2):
        l1h = b["l1h"][:, 1:].copy()
        l1h[:, OLD - 1:] = 1.0
        batches.append({"image": torch.from_numpy(b["image"]).to(dev),
                        "l1h": torch.from_numpy(l1h).to(dev)})
    return model, model_old, pl, pg, state, batches


def choose_pseudo_thresh(model, pl, pg, batches, old=OLD, lift=False):
    """The CPU parity test's surgery at full size: a new class and a pseudo
    threshold that lies between the top two CAM peaks of that class in at
    least one image of every batch (the most such images overall), and a
    seg bias toward that class in the newest classifier, so that those
    images' image-sized component holds exactly one live peak. `old`: the
    classes before the newest step, background included. With `lift`,
    the pseudolabeler's bias of each new class is first raised so that
    the lowest of the images' peaks of its channel reads 1, and the peak
    generator's 1x1 conv made non-negative with a zero bias, so that the
    CAM is the PAM-masked channels: a trained channel below 0 everywhere
    leaves PAM nothing and the CAM flat, without a peak to threshold (the
    15-1 chain's step 2 on the card)."""
    kind = batches[0]["image"].device.type
    bodies = []
    for batch in batches:
        x = batch["image"].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad(), torch.autocast(kind, dtype=torch.bfloat16):
            bodies.append(model.forward_seg(x, interpolate=False)[1]["body"])
    new = pg.num_classes - pg.old_classes
    if lift:
        with torch.no_grad(), torch.autocast(kind, dtype=torch.bfloat16):
            low = torch.cat([pl(body)[:, -new:].float().amax(dim=(2, 3))
                             for body in bodies]).amin(dim=0)
            pl.cls.bias[-new:] += 1.0 - low
            pg.extra_conv4.weight.abs_()
            pg.extra_conv4.bias.zero_()
    tops = []
    for body, batch in zip(bodies, batches):
        with torch.no_grad(), torch.autocast(kind, dtype=torch.bfloat16):
            _, cam = pg(pl(body), label=batch["l1h"])
        cam = resize_bilinear(smoothing(cam.float())[:, old - 1:],
                              tuple(batch["image"].shape[1:3]))
        tops.append(peak_extract_nchw(cam, kernel=15, k=2)[0].cpu().numpy())
    best = None
    for c in range(tops[0].shape[1]):
        for t in ((conf[b, c, 0] + conf[b, c, 1]) / 2
                  for conf in tops for b in range(conf.shape[0])):
            hits = [int(((conf[:, c, 0] > t) & (conf[:, c, 1] < t)).sum())
                    for conf in tops]
            if min(hits) > 0 and (best is None or sum(hits) > best[0]):
                best = (sum(hits), float(t), c)
    if best is None:
        raise AssertionError(
            "no pseudo threshold lets the factory fire in every batch; "
            "images a batch whose top two CAM peaks differ: " + str(
                [int((conf[:, :, 0] > conf[:, :, 1]).any(1).sum())
                 for conf in tops]))
    n, thresh, c = best
    with torch.no_grad():
        model.cls[-1].bias[c] += 10.0
    return thresh, (n, c + old - 1)


def train(dev):
    """Phase 5: warm-up and timed phase-2 steps, launches per step, then a
    profiled step. Returns the launches of the warm-up and timed steps."""
    t0 = time.perf_counter()
    model, model_old, pl, pg, state, batches = build_training(dev)
    thresh, pick = choose_pseudo_thresh(model, pl, pg, batches)
    step = phase2.make_phase2_train_step(model, model_old, pl, pg, OLD,
                                         pseudo_thresh=thresh, device="cuda",
                                         dtype="bfloat16")
    log(f"training set-up {time.perf_counter() - t0:.1f} s; pseudo_thresh "
        f"{thresh:.6f}: class {pick[1]} has exactly one peak above it in "
        f"{pick[0]} images of the 2 batches")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(3)

    # count the valid slots each stamp is given (reads wait for the step)
    stamped = []
    real_stamp = labelgen.stamp_centers_batched

    def counting_stamp(valid, *a):
        stamped.append(valid.sum())
        return real_stamp(valid, *a)

    labelgen.stamp_centers_batched = counting_stamp

    torch.cuda.synchronize()
    kernels.reset_launches()
    times, metrics = [], []

    def one_step(i):
        before_l = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        m = step(state, batches[i % 2], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        delta = {k: kernels.LAUNCHES[k] - before_l[k] for k in before_l}
        if delta != PER_STEP:
            raise AssertionError(f"step {i}: launches {delta}, expected "
                                 f"{PER_STEP}")
        metrics.append({k: float(v) for k, v in m.items()})

    try:
        # the warm-up steps also record the run structure of their key rows;
        # the timed steps call run totals as the step itself does
        with watching_run_totals() as key_rows:
            for i in range(WARMUP_STEPS):
                one_step(i)
        torch.cuda.reset_peak_memory_stats()
        for i in range(WARMUP_STEPS, WARMUP_STEPS + TIMED_STEPS):
            one_step(i)
    finally:
        labelgen.stamp_centers_batched = real_stamp
    launches = dict(kernels.LAUNCHES)
    log_run_structure("step", key_rows)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    slots = [(int(stamped[2 * i]), int(stamped[2 * i + 1]))
             for i in range(len(times))]
    for i, (ms, mt, sl) in enumerate(zip(times, metrics, slots)):
        log(f"step {i} ({'warm-up' if i < WARMUP_STEPS else 'timed'}): "
            f"{ms:.3f} ms, loss {mt['loss']:.6f} (center {mt['l_center']:.6f},"
            f" offset {mt['l_offset']:.6f}), pseudo weight px "
            f"{mt['pseudo_weight_px']:.1f}, truncated "
            f"{int(mt['label_truncated'])}, valid stamp slots pseudo/refined "
            f"{sl[0]}/{sl[1]}")
    timed = times[WARMUP_STEPS:]
    median = float(np.median(timed))
    log(f"phase-2 step, batch {B} at {S}x{S}, bf16: median {median:.3f} ms "
        f"(timed samples {[round(v, 3) for v in timed]}), "
        f"{B / median * 1e3:.3f} img/s, peak memory {peak:.3f} GiB, "
        f"launches over {len(times)} steps {launches}")

    # checks: finite losses, the instance branch moved, the rest did not
    if not all(np.isfinite(mt["loss"]) for mt in metrics):
        raise AssertionError("a phase-2 loss is not finite")
    if not all(sl[0] > 0 for sl in slots):
        raise AssertionError("a step's pseudo stamp had no valid slot")
    after = model.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    wrong = [k for k in moved
             if schedule.default_group_fn(k) != "instance"]
    if wrong or not moved:
        raise AssertionError(f"parameters moved outside the instance branch "
                             f"({wrong[:5]}) or none moved ({len(moved)})")
    n_inst = sum(schedule.default_group_fn(k) == "instance" for k in before)
    log(f"training checks: losses finite, {len(moved)} of {n_inst} instance "
        f"tensors moved, body and seg parameters and BN stats unchanged")
    x = batches[0]["image"].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)

    def frozen():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            model_old(x, interpolate=False)
            model.forward_seg(x, interpolate=False)
            model.forward_seg(torch.flip(x, dims=[3]), interpolate=False)
    log(f"frozen forwards alone (old model, seg on image and flip), batch "
        f"{B}: {time_ms(frozen, iters=3, warmup=1):.3f} ms (CUDA events)")
    profile_step(step, state, batches[0], gen, median, check_trace=True)
    return launches


def profile_step(step, state, batch, gen, median_ms, what="step",
                 check_trace=False):
    """One step under torch.profiler: the device's busy time (returned, ms)
    and its idle share of `median_ms`, the top kernels and operators. With
    `check_trace` the step's Chrome trace, read by utils/device_time, must
    give a busy time (the union of the device events) within
    DEVICE_TIME_RTOL under the summed kernel times, and never above."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if check_trace:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "step.json")
            prof.export_chrome_trace(path)
            rep = device_time.device_time_report(path)
        union_ms = rep["device_busy_s"] * 1e3
        log(f"profiled {what}, its Chrome trace through utils/device_time: "
            f"busy {union_ms:.3f} ms (union of the device events) against "
            f"{busy_ms:.3f} ms summed kernel times, ratio "
            f"{union_ms / busy_ms:.6f}; planes {rep['planes']}")
        if not (1 - DEVICE_TIME_RTOL) * busy_ms <= union_ms <= \
                busy_ms * (1 + 1e-6):
            raise AssertionError(f"device_time busy {union_ms} ms against "
                                 f"the profile's {busy_ms} ms")
    top = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)
    log(f"profiled {what}: device busy {busy_ms:.3f} ms in "
        f"{sum(e.count for e in rows)} kernels and copies, idle share "
        f"{1 - busy_ms / median_ms:.3f} of the unprofiled median step")
    for e in top[:20]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    # the operators that launched them: the names kernels do not show
    from torch.autograd import DeviceType
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    log("top operators by the device time of the kernels they launch:")
    for e in ops[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:60]}")
    return busy_ms


def step0_batches(dev, n):
    """`n` synthetic (16, 512, 512) batches of the 15 base thing classes on
    the card: image, seg, inst."""
    return [{k: torch.from_numpy(b[k]).to(dev) for k in ("image", "seg",
                                                          "inst")}
            for b in synthetic_batches(B, S, OLD - 1, seed=0, n_batches=n)]


def run_steps(what, step, state, batches, gen, per_step,
              warmup=WARMUP_STEPS, timed=TIMED_STEPS, size=S):
    """`warmup` and `timed` steps over `batches` in turn, each step's
    kernel launches held to `per_step`. Returns the metrics of every step,
    the median of the timed steps (ms), the launches of all steps and the
    peak memory of the timed steps (GiB)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, metrics = [], []
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        m = step(state, batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if delta != per_step:
            raise AssertionError(f"{what} step {i}: launches {delta}, "
                                 f"expected {per_step}")
        metrics.append({k: float(v) for k, v in m.items()})
        log(f"{what} step {i} ({'warm-up' if i < warmup else 'timed'}"
            f"): {times[-1]:.3f} ms, " +
            ", ".join(f"{k} {v:.6f}" for k, v in metrics[-1].items()))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed_ms = times[warmup:]
    median = float(np.median(timed_ms))
    log(f"{what} step, batch {B} at {size}x{size}, bf16: median "
        f"{median:.3f} ms (timed samples {[round(v, 3) for v in timed_ms]}), "
        f"{B / median * 1e3:.3f} img/s, peak memory {peak:.3f} GiB, "
        f"launches over {len(times)} steps {launches}")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"a {what} loss is not finite")
    return metrics, median, launches, peak


def moved_groups(before, after, group_fn):
    """Per learning-rate group: the state-dict tensors that changed."""
    moved = {}
    for k, t in before.items():
        g = group_fn(k)
        moved[g] = moved.get(g, 0) + int(not torch.equal(t, after[k]))
    return moved


_WRAPPED = {"topk": (topk, "topk_hier", topk.topk_plain),
            "cc_multilabel": (cc, "connected_components_multilabel",
                              cc.cc_multilabel_plain),
            "run_totals": (segsort, "run_totals", segsort.run_totals_plain),
            "stamp": (labelgen, "stamp_centers_batched",
                      labelgen.stamp_centers)}


def bits_equal(a, b):
    """Equal bit for bit (a float32 -0.0 is not +0.0)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@contextlib.contextmanager
def first_step_checked(what, per_step, kept=None, valid=None):
    """While open, the first `per_step` calls of each kernel's wrapper (one
    step's own inputs) are held bit for bit against the plain version on
    the same inputs at once, so that no output stays on the card, and
    `kept`, where given, gets each kernel's first arguments and `valid`
    the count of valid slots of each checked stamp call; on leaving,
    raise if one disagreed or a call never came. It yields `pause`, a
    context manager in which no call is checked or kept."""
    kept = {} if kept is None else kept
    valid = [] if valid is None else valid
    seen = {name: [] for name in _WRAPPED if per_step[name]}
    saved = {name: getattr(mod, attr)
             for name, (mod, attr, _) in _WRAPPED.items()}
    paused = []

    @contextlib.contextmanager
    def pause():
        paused.append(True)
        try:
            yield
        finally:
            paused.pop()

    def checking(name, real, plain):
        def run(*a, **kw):
            out = real(*a, **kw)
            if not paused and name in seen and \
                    len(seen[name]) < per_step[name]:
                want = plain(*a, **kw)
                outs = out if isinstance(out, tuple) else (out,)
                wants = want if isinstance(want, tuple) else (want,)
                e = max(0.0 if bits_equal(g, w) else max(max_abs_err(g, w),
                                                         1e-30)
                        for g, w in zip(outs, wants))
                n_valid = ""
                if a[0].dtype == torch.bool:
                    valid.append(int(a[0].sum()))
                    n_valid = f", {valid[-1]} valid"
                seen[name].append((f"{tuple(a[0].shape)}{n_valid} -> "
                                   f"{tuple(outs[0].shape)}", e))
                kept.setdefault(name, (a, kw))
            return out
        return run

    for name, (mod, attr, plain) in _WRAPPED.items():
        setattr(mod, attr, checking(name, saved[name], plain))
    try:
        yield pause
    finally:
        for name, (mod, attr, _) in _WRAPPED.items():
            setattr(mod, attr, saved[name])
    for name, calls in seen.items():
        log(f"{what} step's own {name} inputs, kernel against plain: " +
            ", ".join(f"{call}: max_abs_err {e}" for call, e in calls[:4]) +
            (f" and {len(calls) - 4} calls more" if len(calls) > 4 else ""))
        if any(e != 0.0 for _, e in calls) or len(calls) < per_step[name]:
            raise AssertionError(f"{what}: {name} disagrees with its plain "
                                 f"version on the step's own inputs, or was "
                                 f"not called: {calls}")


def train_step0(dev):
    """Phase 6: warm-up and timed step-0 steps (the JAX bench_step0's
    set-up), the stamp once a step and bit-equal to its plain version on
    the step's own slots; then a profiled step. Returns the launches."""
    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = make_model((OLD,), "resnet101", 16, S)
    step = step0.make_step0_train_step(model, sigma=6, max_inst=MAX_INST,
                                       device="cuda", dtype="bfloat16")
    state = step0.init_state(model, "adam",
                             schedule.make_schedule("poly", 5e-5, 10000))
    batches = step0_batches(dev, 2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    log(f"step-0 set-up {time.perf_counter() - t0:.1f} s")

    with first_step_checked("step-0", PER_STEP0):
        metrics, median, launches, _ = run_steps("step-0", step, state,
                                                 batches, gen, PER_STEP0)
    if not all(m["l_center"] > 0 and m["l_offset"] > 0 for m in metrics):
        raise AssertionError("a step-0 step had no instance loss")
    moved = moved_groups(before, model.state_dict(),
                         schedule.default_group_fn)
    if min(moved.values()) == 0:
        raise AssertionError(f"a group did not move: {moved}")
    log(f"step-0 checks: losses finite, center and offset terms live, "
        f"tensors moved per group {moved}")
    profile_step(step, state, batches[0], gen, median)
    return launches


def train_phase1(dev):
    """Phase 7: warm-up and timed phase-1 steps of the use_pseudo program
    and one step of the warm-up program (the JAX bench_phase1's set-up),
    no kernel launched; then a profiled step. Returns the launches."""
    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = make_model((OLD, NEW), "resnet101", 16, S, branch="none")
    model_old = make_model((OLD,), "resnet101", 16, S, branch="none")
    pl = PseudoLabeler(OLD + NEW)
    pg = PeakGenerator(OLD + NEW - 1, OLD - 1)
    net = torch.nn.ModuleDict(dict(model=model, pseudolabeler=pl,
                                   peakgenerator=pg))
    kw = dict(device="cuda", dtype="bfloat16")
    step = phase1.make_phase1_train_step(model, model_old, pl, pg, OLD,
                                         use_pseudo=True, **kw)
    warm = phase1.make_phase1_train_step(model, model_old, pl, pg, OLD,
                                         use_pseudo=False, **kw)
    opt = schedule.make_optimizer(
        net, "sgd", group_scale={"body": 1.0, "seg": 10.0, "pseudo": 10.0},
        group_fn=phase1.phase1_group_fn, momentum=0.9)
    state = TrainState(net, opt, schedule.make_schedule("poly", 1e-3, 10000))
    batches = [{"image": torch.from_numpy(b["image"]).to(dev),
                "l1h": torch.from_numpy(b["l1h"][:, 1:].copy()).to(dev)}
               for b in synthetic_batches(B, S, OLD + NEW - 1, seed=0,
                                          n_batches=2)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    old_before = {k: v.clone() for k, v in model_old.state_dict().items()}
    log(f"phase-1 set-up {time.perf_counter() - t0:.1f} s")

    metrics, median, launches, _ = run_steps("phase-1", step, state,
                                             batches, gen, PER_PHASE1)
    kernels.reset_launches()
    t = time.perf_counter()
    m = warm(state, batches[0], gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    m = {k: float(v) for k, v in m.items()}
    log(f"phase-1 warm-up program (use_pseudo=False), one step: {ms:.3f} ms,"
        f" " + ", ".join(f"{k} {v:.6f}" for k, v in m.items()) +
        f", launches {dict(kernels.LAUNCHES)}")
    if dict(kernels.LAUNCHES) != PER_PHASE1 or not all(
            np.isfinite(v) for v in m.values()):
        raise AssertionError("the phase-1 warm-up program launched a kernel "
                             "or gave a loss that is not finite")
    if m["l_seg"] != 0.0 or not all(mt["l_seg"] > 0 for mt in metrics):
        raise AssertionError("the pseudo-GT seg loss is not live in exactly "
                             "the use_pseudo program")
    moved = moved_groups(before, net.state_dict(), phase1.phase1_group_fn)
    if min(moved.values()) == 0:
        raise AssertionError(f"a group did not move: {moved}")
    if not all(torch.equal(v, model_old.state_dict()[k])
               for k, v in old_before.items()):
        raise AssertionError("the old model changed")
    log(f"phase-1 checks: losses finite, l_seg live only with use_pseudo, "
        f"tensors moved per group {moved}, the old model unchanged")
    profile_step(step, state, batches[0], gen, median)
    return launches


CHAIN_COMMON = ["--synthetic", "--dataset", "voc", "--task", "15-5",
                "--batch_size", str(B), "--crop_size", str(S), "--dtype",
                "bfloat16", "--epochs", "1", "--device", "cuda"]
CHAIN_RUNS = {
    "step 0": ["--step", "0", "--name", "exp", "--bce", "--optim", "adam",
               "--lr", "5e-5"],
    "phase 1": ["--step", "1", "--name", "exp_p1", "--weakly", "--phase",
                "1", "--optim", "sgd", "--lr", "1e-3", "--lr_policy",
                "warmup", "--loss_de", "1", "--affinity", "--pseudo_ep",
                "0"],
    "phase 2": ["--step", "1", "--name", "exp_p2", "--weakly", "--phase",
                "2", "--optim", "adam", "--lr", "5e-5"],
}
CHAIN_PER_STEP = {"step 0": PER_STEP0, "phase 1": PER_PHASE1,
                  "phase 2": PER_STEP}
# the fresh layers whose start the chain's step 0 shows (the CLI's
# default, flax's init families): kernels and the biases they must hold
START_KERNELS = ("body.mod1.conv1.weight",
                 "decoder.instance_decoder.aspp.project.0.weight",
                 "cls.0.weight")
START_BIASES = ("cls.0.bias", "instance_head.classifier.center.cls.0.bias",
                "instance_head.classifier.offset.cls.0.bias")
START_STD_RTOL = 0.10


class ChainRecorder:
    """Given to cli.main as `on_trainer`: keeps every trainer the CLI
    builds, a copy of its START_KERNELS and START_BIASES as the trainer
    built them (before any checkpoint is loaded or step taken), its epoch
    metrics, the times of its checkpoint saves and loads (each ending in
    a synchronize) and the last batch it put on the card."""

    def __init__(self):
        self.made = []

    def __call__(self, trainer):
        trainer.times, trainer.epochs = {}, []
        sd = trainer.model.state_dict()
        trainer.start = {k: sd[k].detach().clone()
                         for k in START_KERNELS + START_BIASES if k in sd}

        def timed(name, method):
            def run(*a):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = method(*a)
                torch.cuda.synchronize()
                trainer.times[name] = time.perf_counter() - t
                return out
            return run

        for name in ("save", "load_step_ckpt", "load_seg_ckpt"):
            setattr(trainer, name, timed(name, getattr(trainer, name)))
        train_epoch = trainer.train_epoch

        def recorded_epoch(*a, **kw):
            trainer.epochs.append(train_epoch(*a, **kw))
            return trainer.epochs[-1]
        trainer.train_epoch = recorded_epoch
        device_batch = trainer._device_batch

        def keeping_batch(batch):
            trainer.last_batch = device_batch(batch)
            return trainer.last_batch
        trainer._device_batch = keeping_batch
        self.made.append(trainer)


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def check_start(trainer, loss):
    """The step-0 trainer's fresh layers in the CLI's default start,
    flax's families: each of START_KERNELS at std within START_STD_RTOL of
    sqrt(1 / fan_in) and inside the truncation bound 2 sqrt(1 / fan_in) /
    TRUNC_STD, each of START_BIASES exactly 0. Logs them beside the run's
    epoch loss and the card."""
    got = {}
    for k in START_KERNELS:
        w = trainer.start[k].double()
        want = (1.0 / fan_in(w)) ** 0.5
        got[k] = {"fan_in": fan_in(w), "std": float(w.std()),
                  "std_over_want": float(w.std()) / want,
                  "max_over_bound": float(w.abs().max()) * TRUNC_STD
                  / (2 * want)}
    biases = {k: float(trainer.start[k].abs().max()) for k in START_BIASES}
    log("chain step 0 start (flax's families, --torch_init false): " +
        json.dumps({"kernels": got, "bias_abs_max": biases,
                    "epoch_loss": loss, "card": card_line()}))
    bad = [k for k, r in got.items()
           if abs(r["std_over_want"] - 1) >= START_STD_RTOL
           or r["max_over_bound"] > 1 + 1e-6]
    bad += [k for k, v in biases.items() if v != 0]
    if bad:
        raise AssertionError(f"chain step 0: {bad} not in flax's families")


def chain(root):
    """Phase 8: the CLI chain at full width from the CLI's default start
    (its step-0 trainer's fresh layers checked in flax's families); returns
    the launches of each run, the phase-2 trainer and each run's epoch
    metrics and step times (ms)."""
    step0_ckpt = os.path.join(root, "ck", "step", "voc-15-5-ov", "exp_0")
    p1_ckpt = os.path.join(root, "ck", "step", "voc-15-5-ov", "exp_p1_1")
    extra = {"phase 1": ["--step_ckpt", step0_ckpt],
             "phase 2": ["--step_ckpt", step0_ckpt, "--seg_ckpt", p1_ckpt]}
    launches, seen = {}, {}
    rec = ChainRecorder()
    for run, argv in CHAIN_RUNS.items():
        argv = CHAIN_COMMON + argv + extra.get(run, []) + [
            "--checkpoint", os.path.join(root, "ck"), "--visualize",
            "false", "--profile_dir",
            os.path.join(root, "trace", run.replace(" ", ""))]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        if cli.main(argv, on_trainer=rec) != 0:
            raise AssertionError(f"chain {run}: main() failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[run] = dict(kernels.LAUNCHES)
        tr = rec.made[-1]
        m = tr.epochs[0]
        n = m["n_batches"]
        want = {k: v * n for k, v in CHAIN_PER_STEP[run].items()}
        if launches[run] != want:
            raise AssertionError(f"chain {run}: launches "
                                 f"{launches[run]}, expected {want}")
        path = tr.default_ckpt_path()
        if not os.path.exists(path):
            raise AssertionError(f"chain {run}: no checkpoint {path}")
        steps = [round(v * 1e3, 3) for v in tr.step_timer.times]
        seen[run] = {"epoch": dict(m), "steps_ms": steps}
        log(f"chain {run}: main() {wall:.3f} s, epoch {n} batches "
            f"{m['epoch_time_s']:.3f} s, loss {m['loss']:.6f}, step times "
            f"ms {steps} (steps 2-3 under torch.profiler), checkpoint "
            f"{os.path.getsize(path) / 2 ** 30:.3f} GiB, " +
            ", ".join(f"{k} {v:.3f} s" for k, v in tr.times.items()) +
            f", launches {launches[run]}")
        if run == "step 0":
            check_start(tr, m["loss"])
        if run == "phase 2":
            log(f"chain phase 2 epoch means: pseudo_weight_px "
                f"{m['pseudo_weight_px']:.1f}, label_truncated "
                f"{m['label_truncated']:.2f}, l_center "
                f"{m['l_center']:.6f}, l_offset {m['l_offset']:.6f}")
    t2 = rec.made[-1]
    rec.made.clear()            # the step-0 and phase-1 trainers go

    # checkpoint identities, bit for bit
    p1 = load_checkpoint(p1_ckpt)["model"]
    s0 = load_checkpoint(step0_ckpt)["model"]
    sd = t2.model.state_dict()
    frozen = [k for k in p1 if schedule.default_group_fn(k) in ("body", "seg")]
    bad = [k for k in frozen if not torch.equal(sd[k].cpu(), p1[k])]
    old = t2.model_old.state_dict()
    bad += [k for k in old if not torch.equal(old[k].cpu(), s0[k])]
    if bad or set(frozen) != {k for k in sd if schedule.default_group_fn(k)
                              in ("body", "seg")}:
        raise AssertionError(f"chain: {len(bad)} tensors differ from their "
                             f"checkpoint ({bad[:4]}), {len(frozen)} checked")
    log(f"chain checks: 3 checkpoints written; phase 2's {len(frozen)} body "
        f"and seg tensors equal the phase-1 checkpoint's and the old model's "
        f"{len(old)} tensors step 0's, bit for bit")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, t2, seen


def painted_samples(rs, n=8, n_inst=8):
    """`n` validation samples at VOC-native sizes: images painted with
    `n_inst` boxes of painted_scene's instances, coloured by class, their
    masks and 0-based classes, and the seg map."""
    out = []
    for i in range(n):
        H, W = SERVE_SIZES[i % len(SERVE_SIZES)]
        _, _, _, insts = painted_scene(H, W, NEW, rs, n_inst=n_inst)
        img = rs.uniform(0.0, 0.3, (H, W, 3)).astype(np.float32)
        seg = np.zeros((H, W), np.int64)
        for c, box in insts:
            img[box] = [0.2 + 0.15 * c, 0.9 - 0.15 * c, 0.5]
            seg[box] = OLD + c
        img = (img - np.array([0.485, 0.456, 0.406], np.float32)) / \
            np.array([0.229, 0.224, 0.225], np.float32)
        out.append({"image": img[None].astype(np.float32), "seg": seg,
                    "gt_masks": np.stack([b for _, b in insts]),
                    "gt_labels": np.array([OLD - 1 + c for c, _ in insts])})
    return out


def recorded(fn, times, outs):
    """`fn` that also keeps each call's time (ms, ending in a synchronize)
    and output."""
    def run(*a):
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        outs.append(out)
        return out
    return run


def same_results(a, b):
    return (a.keys() == b.keys() and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True)
        for k in a))


def validate(trainer, rs):
    """Phase 9: validation on the card with the phase-2 trainer's model
    (left by its epoch with the decoder in train mode), its center heads'
    biases raised by 0.3 so that NMS finds centers in the maps of random
    weights (as the CPU serving tests do). The ground truth is the painted
    boxes plus every second instance the model itself finds without flip,
    so that AP is not 0 throughout. Returns the kernel launches of the
    instance validations through the kernels."""
    with torch.no_grad():
        for conv in trainer.model.instance_head.classifier.center.cls:
            conv.bias += 0.3
    samples = painted_samples(rs)
    trainer.cfg = dataclasses.replace(trainer.cfg, val_flip=False)
    fwd = cli.make_instance_forward(trainer)
    for smp in samples:
        out = fwd(torch.from_numpy(smp["image"]), smp["gt_masks"].shape[1:])
        ins, lab = out["ins_map"].cpu().numpy(), out["label"].cpu().numpy()
        ids = [i for i in np.unique(ins) if i >= 0][::2]
        smp["gt_masks"] = np.concatenate(
            [smp["gt_masks"]] + [(ins == i)[None] for i in ids])
        smp["gt_labels"] = np.concatenate([smp["gt_labels"], lab[ids]])
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    for flip in (False, True):
        trainer.cfg = dataclasses.replace(trainer.cfg, val_flip=flip)
        fwd = cli.make_instance_forward(trainer)
        times, outs, plain_outs = [], [], []
        kernels.reset_launches()
        got = validate_instances(recorded(fwd, times, outs), samples)
        used = dict(kernels.LAUNCHES)
        want_l = {k: v * len(samples) for k, v in PER_REQUEST.items()}
        if used != want_l:
            raise AssertionError(f"validate flip={flip}: launches {used}, "
                                 f"expected {want_l}")
        launches = {k: launches[k] + v for k, v in used.items()}
        with plain_versions():
            want = validate_instances(recorded(fwd, [], plain_outs), samples)
        if kernels.LAUNCHES != used:
            raise AssertionError("the plain validation launched a kernel")
        score_err = 0.0
        for o, p in zip(outs, plain_outs):
            for k in ("ins_map", "label", "valid", "truncated"):
                if not torch.equal(o[k], p[k]):
                    raise AssertionError(f"validate flip={flip}: {k} differs "
                                         f"between the kernel and the plain "
                                         f"path")
            score_err = max(score_err, max_abs_err(o["score"], p["score"]))
        if not same_results(got, want) or score_err > 1e-6:
            raise AssertionError(f"validate flip={flip}: kernel and plain "
                                 f"paths differ: {got} / {want}, scores "
                                 f"{score_err}")
        if trainer.model.training or not np.isfinite(got["map"]):
            raise AssertionError(f"validate flip={flip}: bad result {got}")
        n_valid = [int(o["valid"].sum()) for o in outs]
        log(f"validate_instances, flip {flip}, {len(samples)} painted images "
            f"at VOC-native sizes, {sum(len(x['gt_labels']) for x in samples)}"
            f" ground-truth instances: map {got['map']:.6f}, map50 "
            f"{got['map50']:.6f}, truncated_centers "
            f"{got['truncated_centers']}, valid slots an image {n_valid}; "
            f"kernel and plain paths equal (AP arrays, maps, slots; score "
            f"max_abs_err {score_err}); median "
            f"{float(np.median(times)):.3f} ms an image (samples "
            f"{[round(v, 3) for v in times]}), launches {used}")
    for mode, build, kw in (
            ("DeeplabV3 seg", cli.make_classify_seg, {}),
            ("phase-1 CAM", cli.make_classify_cam,
             {"old_classes": trainer.old_classes})):
        times = []
        res = validate_semseg(recorded(build(trainer), times, []), samples,
                              trainer.tot_classes, **kw)
        if res["Total samples"] != len(samples) or not all(
                np.isfinite(v) for v in res["Agg"]):
            raise AssertionError(f"validate_semseg {mode}: {res}")
        log(f"validate_semseg, {mode} mode: mean IoU {res['Mean IoU']:.6f}, "
            f"mean acc {res['Mean Acc']:.6f}; median "
            f"{float(np.median(times)):.3f} ms an image")
    return launches


# ------------------------------------------------------- real-data chain

VOC_SIZES = ((500, 375), (375, 500), (500, 333), (333, 500))   # (W, H)
N_TRAIN, N_VAL = 48, 16                    # 3 batches of 16; validation
LOADER_WORKERS = 4
# each run validates N_VAL images after its epoch: instance mAP through the
# kernels at step 0 and phase 2, the phase-1 CAM mIoU without them
VOC_PER_VAL = {"step 0": PER_REQUEST, "phase 1": PER_PHASE1,
               "phase 2": PER_REQUEST}


def palette(c):
    """Class-keyed RGB fill (tests/test_data.py's painted fixtures)."""
    return np.array([(c * 37) % 200 + 55, (c * 91) % 200 + 55,
                     (c * 151) % 200 + 55], np.uint8)


def paint_objects(arr, i, cats, rs):
    """Paint class-coloured boxes of the classes `cats` (the first at the
    top, the second below the middle) into image `i`'s array (H, W, 3),
    scaled to the canvas; returns their COCO annotations without ids."""
    H, W = arr.shape[:2]
    sc = min(W, H) // 64
    ow = 16 * sc
    x0 = 4 + (3 * i) % (W - 12 - ow)
    anns = []
    for k, c in enumerate(cats):
        y0 = H // 2 + 2 if k == 1 else 4
        oh = (16 + c % 7) * sc
        poly = [x0, y0, x0 + ow, y0, x0 + ow, y0 + oh, x0, y0 + oh]
        anns.append({"category_id": c, "segmentation": [poly], "iscrowd": 0,
                     "bbox": [x0, y0, ow, oh], "area": ow * oh})
        block = (palette(c)[None, None, :].astype(np.int32)
                 + rs.randint(-12, 13, (oh, ow, 3)))
        arr[y0:y0 + oh, x0:x0 + ow] = np.clip(block, 0, 255)
    return anns


def write_painted_set(img_dirs, sizes, classes_of, n_categories,
                      n_train=None):
    """`n_train` (N_TRAIN) + N_VAL JPEGs of gray noise at `sizes` (W x H, in
    turn) into img_dirs["train"] / ["val"] (the first `n_train` train),
    each painted with the classes `classes_of(i)` by paint_objects.
    Returns the COCO bodies of the two splits and the annotations with
    their image sizes."""
    n_train = N_TRAIN if n_train is None else n_train
    from PIL import Image
    rs = np.random.RandomState(0)
    body = {split: {"images": [], "annotations": [], "categories": [
        {"id": c, "name": str(c)} for c in range(1, n_categories + 1)]}
        for split in ("train", "val")}
    ann_id = 1
    for i in range(n_train + N_VAL):
        split = "train" if i < n_train else "val"
        W, H = sizes[i % len(sizes)]
        name = f"img_{i:03d}.jpg"
        arr = (rs.rand(H, W, 3) * 40 + 100).astype(np.uint8)
        body[split]["images"].append({"id": i + 1, "file_name": name,
                                      "height": H, "width": W})
        for ann in paint_objects(arr, i, classes_of(i), rs):
            body[split]["annotations"].append(
                dict(ann, id=ann_id, image_id=i + 1))
            ann_id += 1
        os.makedirs(img_dirs[split], exist_ok=True)
        Image.fromarray(arr).save(os.path.join(img_dirs[split], name))
    sizes_of = {im["id"]: (im["height"], im["width"])
                for b in body.values() for im in b["images"]}
    return body, [(a, sizes_of[a["image_id"]]) for b in body.values()
                  for a in b["annotations"]]


def write_mini_voc(root, classes_of=lambda i: (16 + i % 5, i % 15 + 1),
                   n_train=None):
    """A painted mini-VOC, modelled on tests/test_data.py's fixture with
    rich=True and paint=True, at VOC-native sizes: JPEGs of gray noise
    cycling 500x375, 375x500, 500x333 and 333x500 (W x H), each with the
    classes `classes_of(i)` (by default one new class of 15-5, 16-20, and
    one old class, 1-15) painted as class-coloured boxes scaled to the
    canvas, and their polygons in voc/pascal_sbd_{train,val}.json (the
    first `n_train` (N_TRAIN) images train, the next N_VAL validate).
    Returns the annotations with their image sizes."""
    img_dir = os.path.join(root, "voc", "JPEGImages")
    body, anns = write_painted_set({"train": img_dir, "val": img_dir},
                                   VOC_SIZES, classes_of, 20, n_train)
    for split, b in body.items():
        with open(os.path.join(root, "voc", f"pascal_sbd_{split}.json"),
                  "w") as f:
            json.dump(b, f)
    return anns


def check_native(anns):
    """The mask library builds here, and its rasterised polygons round-trip
    through its RLE encode and decode and the numpy ones, equally."""
    from cl4wsis_tpu_torch.data import maskrle, native
    t = time.perf_counter()
    path = native.build()
    native.lib()
    built = time.perf_counter() - t
    for ann, (h, w) in anns:
        m = maskrle.ann_to_mask(ann, h, w)
        x, y, bw, bh = ann["bbox"]
        counts = native.rle_encode(m)
        if (m.shape != (h, w) or m.sum() != bw * bh
                or not m[y:y + bh, x:x + bw].all()
                or counts != maskrle.rle_encode(m)["counts"]
                or not np.array_equal(native.rle_decode(counts, h, w), m)
                or not np.array_equal(maskrle.rle_decode(counts, h, w), m)):
            raise AssertionError(f"mask library: annotation {ann['id']} "
                                 f"does not round-trip")
    log(f"mask library {path.name} built and loaded in {built:.2f} s; "
        f"{len(anns)} polygon masks at VOC sizes round-trip through its RLE "
        f"encode/decode and the numpy ones, equal")


class LoaderWatch:
    """Wraps cli.build_data: keeps the train and validation sets the CLI
    builds, and the host time each of the trainer's requests for a batch
    waited on the loader's epoch iterator."""

    def __init__(self):
        self.real = cli.build_data
        self.waits, self.train, self.val = [], None, None

    def __call__(self, cfg):
        loader, val = self.real(cfg)
        self.train, self.val, self.waits = loader.dataset, val, []
        epoch = loader.epoch
        loader.epoch = lambda e: watched(epoch(e), self.waits)
        return loader, val


def watched(batches, waits):
    """The batches, appending to `waits` the host ms each request for the
    next one waited."""
    it = iter(batches)
    while True:
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        waits.append((time.perf_counter() - t) * 1e3)
        yield batch


class Repeated(torch.utils.data.Dataset):
    """`k` passes over a dataset indexed by (epoch, index), one epoch."""

    def __init__(self, ds, k):
        self.ds, self.k = ds, k

    def __len__(self):
        return self.k * len(self.ds)

    def __getitem__(self, key):
        epoch, i = key
        return self.ds[(epoch, i % len(self.ds))]


def no_workers_left(what, wait_s=10.0):
    """Raise if a worker process the loaders started is still alive
    `wait_s` after they were closed (a terminated worker takes a moment
    to be reaped)."""
    import multiprocessing
    t = time.perf_counter()
    while multiprocessing.active_children():
        if time.perf_counter() - t > wait_s:
            raise AssertionError(f"{what}: loader workers left "
                                 f"{multiprocessing.active_children()}")
        time.sleep(0.1)


def loader_alone(train, trainer, step_ms):
    """The loader without the CLI at 0 and LOADER_WORKERS worker processes
    (pinned, as the CLI on the card builds it): a window of 24 batches (6
    at 0 workers), three times the workers' prefetch depth of 8: epoch 0
    with nothing but the loader (the first batch's wait, then the workers'
    steady production per batch after the depth), epoch 1 consumed by the
    phase-2 trainer's own epoch (`trainer`), whose steps hold the host as
    the chain's do. Its total wait for batches is read as a share of
    `step_ms` (the chain's phase-2 step) per batch, with the mean and the
    largest wait."""
    from cl4wsis_tpu_torch.data.loader import Loader
    for workers in (0, LOADER_WORKERS):
        rep = Loader(Repeated(train, 8 if workers else 2), B, seed=42,
                     num_workers=workers, pin_memory=True)
        t = time.perf_counter()
        arrivals = []
        for b in rep.epoch(0):
            arrivals.append(time.perf_counter() - t)
            if not b["image"].is_pinned():
                raise AssertionError("the loader's batch is not pinned")
        depth = 2 * workers
        per_batch = (arrivals[-1] - arrivals[depth]) * 1e3 / (
            len(arrivals) - 1 - depth)
        log(f"loader, {workers} workers (os.cpu_count() {os.cpu_count()}), "
            f"{len(arrivals)} batches with no consumer: first after {arrivals[0] * 1e3:.3f} ms, then "
            f"{per_batch:.3f} ms a batch after the first {depth + 1} "
            f"({per_batch / B:.3f} ms an image)")
        waits = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = trainer.train_epoch(1, watched(rep.epoch(1), waits))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        rep.close()
        no_workers_left(f"loader, {workers} workers")
        n = len(waits)
        if m["n_batches"] != n or n != len(rep) or \
                not np.isfinite(m["loss"]):
            raise AssertionError(f"loader, {workers} workers, phase-2 "
                                 f"epoch: {n} batches, {m}")
        log(f"loader, {workers} workers, feeding a phase-2 epoch of {n} "
            f"batches: epoch {wall:.3f} ms, {wall / n:.3f} ms a batch "
            f"against the chain's step {step_ms:.3f} ms; wait for batches "
            f"total {sum(waits):.3f} ms = {sum(waits) / (n * step_ms):.4f} "
            f"of {n} steps, mean {np.mean(waits):.3f} ms, largest "
            f"{max(waits):.3f} ms, first {waits[0]:.3f} ms; waits ms "
            f"{[round(v, 3) for v in waits]}")


def real_chain(root, common, task_dir, what, after_run=None):
    """The CLI three times (CHAIN_RUNS) with `common` on the data under
    root/data, 4 loader workers and validation after each run: the
    launches of each run held to its steps and its validation, the host
    wait for each batch, the run's peak memory, phase 2's body and seg
    equal to phase 1's. `after_run(run, trainer, steps_ms)`, where given,
    sees each run's trainer. Returns the launches and step times of each
    run, the phase-2 trainer and the validation set."""
    step0_ckpt = os.path.join(root, "ck", "step", task_dir, "exp_0")
    p1_ckpt = os.path.join(root, "ck", "step", task_dir, "exp_p1_1")
    extra = {"phase 1": ["--step_ckpt", step0_ckpt],
             "phase 2": ["--step_ckpt", step0_ckpt, "--seg_ckpt", p1_ckpt]}
    launches, steps, rec, watch = {}, {}, ChainRecorder(), LoaderWatch()
    real_validation, val_ms = cli.run_validation, {}

    def timed_validation(trainer, val, logger, tag):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_validation(trainer, val, logger, tag)
        torch.cuda.synchronize()
        val_ms[tag] = (time.perf_counter() - t) * 1e3 / len(val)

    cli.build_data, cli.run_validation = watch, timed_validation
    try:
        for run, argv in CHAIN_RUNS.items():
            argv = common + argv + extra.get(run, []) + [
                "--checkpoint", os.path.join(root, "ck"), "--visualize",
                "false", "--profile_dir",
                os.path.join(root, "trace", run.replace(" ", ""))]
            torch.cuda.synchronize()
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            if cli.main(argv, on_trainer=rec) != 0:
                raise AssertionError(f"{what} {run}: main() failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            launches[run] = dict(kernels.LAUNCHES)
            tr, val = rec.made[-1], watch.val
            m = tr.epochs[0]
            n = m["n_batches"]
            want = {k: v * n + VOC_PER_VAL[run][k] * len(val)
                    for k, v in CHAIN_PER_STEP[run].items()}
            if n != N_TRAIN // B or len(val) != N_VAL:
                raise AssertionError(f"{what} {run}: {n} batches, "
                                     f"{len(val)} validation images")
            if launches[run] != want:
                raise AssertionError(f"{what} {run}: launches "
                                     f"{launches[run]}, expected {want}")
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"{what} {run}: {m}")
            path = tr.default_ckpt_path()
            if not os.path.exists(path):
                raise AssertionError(f"{what} {run}: no checkpoint {path}")
            steps[run] = [round(v * 1e3, 3) for v in tr.step_timer.times]
            log(f"{what} {run}: main() {wall:.3f} s, epoch {n} batches "
                f"{m['epoch_time_s']:.3f} s, loss {m['loss']:.6f}, step "
                f"times ms {steps[run]} (step 2 under torch.profiler), batch "
                f"waits ms {[round(v, 3) for v in watch.waits]} (the "
                f"trainer takes 3 batches before its first step), peak "
                f"memory {peak:.3f} GiB, checkpoint "
                f"{os.path.getsize(path) / 2 ** 30:.3f} GiB, " +
                ", ".join(f"{k} {v:.3f} s" for k, v in tr.times.items()) +
                f", validation {val_ms['test']:.3f} ms an image, launches "
                f"{launches[run]}")
            if run == "phase 2":
                log(f"{what} phase 2 epoch means: pseudo_weight_px "
                    f"{m['pseudo_weight_px']:.1f}, label_truncated "
                    f"{m['label_truncated']:.2f}, l_center "
                    f"{m['l_center']:.6f}, l_offset {m['l_offset']:.6f}")
            no_workers_left(f"{what} {run}")
            if after_run is not None:
                after_run(run, tr, steps[run])
            if run != "phase 2":
                rec.made.clear()
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        cli.build_data, cli.run_validation = watch.real, real_validation
    t2 = rec.made[-1]
    rec.made.clear()

    p1 = load_checkpoint(p1_ckpt)["model"]
    sd = t2.model.state_dict()
    frozen = [k for k in p1 if schedule.default_group_fn(k) in ("body", "seg")]
    bad = [k for k in frozen if not torch.equal(sd[k].cpu(), p1[k])]
    if bad or len(frozen) < 100:
        raise AssertionError(f"{what}: {len(bad)} body/seg tensors differ "
                             f"from the phase-1 checkpoint")
    log(f"{what} checks: losses finite, launches as expected, phase 2's "
        f"{len(frozen)} body and seg tensors equal phase 1's bit for bit")
    return launches, steps, t2, watch


def voc_chain(root):
    """Phase 10: the CLI chain on the painted mini-VOC at full width, with
    the loader's worker processes, validation after each run, serving
    from the phase-2 checkpoint, and validation through the kernels
    against the plain versions. Returns the launches of each run and of
    the serving from the checkpoint."""
    anns = write_mini_voc(os.path.join(root, "data"))
    check_native(anns)
    common = [a for a in CHAIN_COMMON if a != "--synthetic"] + [
        "--data_root", os.path.join(root, "data"), "--crop_size_val",
        str(S), "--num_workers", str(LOADER_WORKERS), "--pretrained",
        "false"]
    launches, steps, t2, watch = real_chain(root, common, "voc-15-5-ov",
                                            "voc chain")
    samples = [watch.val[i] for i in range(len(watch.val))]
    validate_voc(t2, samples, "as trained")
    serve_launches, lifted = serve_from_checkpoint(
        t2, t2.default_ckpt_path(), root)
    t2.model.load_state_dict(lifted)
    validate_voc(t2, samples, "center bias +0.3")
    # phase 2's step 1: step 0 sets up cuDNN, step 2 runs under the profiler
    loader_alone(watch.train, t2, steps["phase 2"][1])
    del t2
    gc.collect()
    torch.cuda.empty_cache()
    return launches, serve_launches


def validate_voc(trainer, samples, what):
    """validate_instances of the trainer's model over the mini-VOC's
    validation samples (resized to a short side of 512, as the CLI
    validates), through the kernels and through the plain versions: the
    slots, scores, maps and AP arrays must agree."""
    fwd = cli.make_instance_forward(trainer)
    times, outs, plain_outs = [], [], []
    kernels.reset_launches()
    got = validate_instances(recorded(fwd, times, outs), samples)
    used = dict(kernels.LAUNCHES)
    if used != {k: v * len(samples) for k, v in PER_REQUEST.items()}:
        raise AssertionError(f"validate voc ({what}): launches {used}")
    with plain_versions():
        want = validate_instances(recorded(fwd, [], plain_outs), samples)
    score_err = 0.0
    for o, p in zip(outs, plain_outs):
        for k in ("ins_map", "label", "valid", "truncated"):
            if not torch.equal(o[k], p[k]):
                raise AssertionError(f"validate voc ({what}): {k} differs "
                                     f"between the kernels and the plain "
                                     f"versions")
        score_err = max(score_err, max_abs_err(o["score"], p["score"]))
    if not same_results(got, want) or score_err > 1e-6 or \
            not np.isfinite(got["map"]):
        raise AssertionError(f"validate voc ({what}): {got} / {want}, "
                             f"scores {score_err}")
    shapes = sorted({tuple(s["image"].shape[1:3]) for s in samples})
    log(f"validate voc ({what}): {len(samples)} images at {shapes}: map "
        f"{got['map']:.6f}, map50 {got['map50']:.6f}, valid slots an image "
        f"{[int(o['valid'].sum()) for o in outs]}; kernels and plain versions "
        f"equal (slots, AP arrays; score max_abs_err {score_err}); median "
        f"{float(np.median(times)):.3f} ms an image (samples "
        f"{[round(v, 3) for v in times]})")


def serve_from_checkpoint(trainer, path, root, classes=(OLD, NEW),
                          model_kw=None, variants=("as written",
                                                   "center bias +0.3"),
                          flips=(False, True)):
    """Predictor.from_checkpoint on the phase-2 checkpoint the chain wrote
    ("as written"), and on a copy with the center heads' biases raised by
    0.3 (so that the random weights give instances): 4 requests each,
    for each of `flips`. Flip off must equal a Predictor over the
    trainer's model with the same state dict bit for bit; every to_coco
    RLE must decode to its mask. `model_kw` go to from_checkpoint
    (backbone, output_stride, crop_size). Returns the launches and the
    raised state dict."""
    from cl4wsis_tpu_torch.cl.ckpt import save_checkpoint
    from cl4wsis_tpu_torch.data.maskrle import rle_decode
    lifted = {k: v.clone() for k, v in load_checkpoint(path)["model"].items()}
    for k in lifted:
        if k.startswith("instance_head.classifier.center.cls.") and \
                k.endswith(".bias"):
            lifted[k] += 0.3
    lifted_path = os.path.join(root, "lifted")
    save_checkpoint(lifted_path, {"model": lifted})
    rs = np.random.RandomState(5)
    images = [request_image(h, w, rs) for h, w in SERVE_SIZES]
    kernels.reset_launches()
    n_inst = {}
    paths = {"as written": path, "center bias +0.3": lifted_path}
    for what in variants:
        ck = paths[what]
        t = time.perf_counter()
        served = {flip: Predictor.from_checkpoint(ck, classes, val_flip=flip,
                                                  **(model_kw or {}))
                  for flip in flips}
        load_s = time.perf_counter() - t
        ref = Predictor(trainer.model, load_checkpoint(ck)["model"])
        for flip, pred in served.items():
            lat, counts = [], []
            for img in images:
                t = time.perf_counter()
                r = pred(img)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t) * 1e3)
                if not flip:
                    want = ref(img)
                    for k in ("ins_map", "labels", "scores", "valid", "seg"):
                        if not np.array_equal(getattr(r, k), getattr(want, k)):
                            raise AssertionError(
                                f"from_checkpoint ({what}): {k} differs from "
                                f"the trainer's model")
                coco = r.to_coco(image_id=1)
                for res, inst in zip(coco, r.instances()):
                    seg = res["segmentation"]
                    if not np.array_equal(rle_decode(seg["counts"],
                                                     *seg["size"]),
                                          inst["mask"].astype(np.uint8)):
                        raise AssertionError(f"from_checkpoint ({what}): an "
                                             f"RLE does not decode back")
                counts.append(len(coco))
            n_inst[(what, flip)] = sum(counts)
            log(f"from_checkpoint ({what}), flip {flip}: built in "
                f"{load_s:.3f} s (every flip), latency ms "
                f"{[round(v, 3) for v in lat]}, instances {counts}, every "
                f"to_coco RLE decodes to its mask" +
                (", outputs bit-equal to the trainer's model" if not flip
                 else ""))
        del served, ref
    if n_inst[("center bias +0.3", False)] == 0:
        raise AssertionError("from_checkpoint: no instance to export")
    launches = dict(kernels.LAUNCHES)
    want = {k: v * len(images) * len(variants) * (len(flips) + 1)
            for k, v in PER_REQUEST.items()}
    if launches != want:        # checkpoints x (flips, the reference)
        raise AssertionError(f"from_checkpoint: launches {launches}, "
                             f"expected {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, lifted


# ------------------------------------------------- COCO-to-VOC chain

COCO_SIZES = ((640, 480), (480, 640), (640, 427))   # (W, H)


def write_mini_coco(root):
    """A painted mini-COCO for the COCO-to-VOC step 0, in the layout of
    tests/test_coco_data.py's fixture: JPEGs of gray noise at COCO-native
    sizes cycling 640x480, 480x640 and 640x427 (W x H), each with two of
    the 60 step-0 classes (all of them in turn) painted as class-coloured
    boxes, their polygons in coco/annotations/instances_{train,val}2017.json
    (the first N_TRAIN images train, the next N_VAL validate) and the file
    lists in coco/split/{train,val}.txt. Returns the annotations with
    their image sizes."""
    labels = [c for c in tasks.get_task_labels("coco-voc", "voc", 0)[0] if c]
    coco = os.path.join(root, "coco")
    folders = {"train": "train2017", "val": "val2017"}
    body, anns = write_painted_set(
        {split: os.path.join(coco, "images", f) for split, f in
         folders.items()}, COCO_SIZES,
        lambda i: (labels[2 * i % len(labels)],
                   labels[(2 * i + 1) % len(labels)]), 90)
    os.makedirs(os.path.join(coco, "annotations"))
    os.makedirs(os.path.join(coco, "split"))
    for split, b in body.items():
        with open(os.path.join(coco, "annotations",
                               f"instances_{folders[split]}.json"), "w") as f:
            json.dump(b, f)
        with open(os.path.join(coco, "split", f"{split}.txt"), "w") as f:
            f.write("".join(im["file_name"][:-4] + "\n"
                            for im in b["images"]))
    return anns


def coco_voc_chain(root):
    """Phase 11: the COCO-to-VOC recipe through the CLI at full width
    (WideResNet-38, output stride 8, crop 448, validation 512, batch 16,
    bf16, --dataset coco-voc --task voc, Config.finalize unpatched): step
    0 on a painted mini-COCO, phase 1 and phase 2 on a painted mini-VOC in
    the COCO label space, each validating; one more step of each run's
    own train step under torch.profiler; two validation forwards under
    torch.profiler; from_checkpoint on the phase-2 checkpoint with center
    biases +0.3, bit-equal to the trainer's model; the phase-2 model's
    validation with those biases through the kernels and the plain
    versions (equal; 8 of the 16 validation images). Returns the launches
    of each run and of the serving from the checkpoint."""
    data = os.path.join(root, "data")
    anns = write_mini_coco(data) + write_mini_voc(data)
    check_native(anns)
    common = ["--dataset", "coco-voc", "--task", "voc", "--data_root", data,
              "--batch_size", str(B), "--dtype", "bfloat16", "--epochs",
              "1", "--device", "cuda", "--num_workers", str(LOADER_WORKERS),
              "--pretrained", "false"]
    want_cfg = ("wider_resnet38_a2", 8, S_WRN, S_WRN_VAL, False,
                "WiderResNet38A2", (S_WRN, S_WRN))

    def profile_run(run, tr, steps_ms):
        cfg = tr.cfg
        got = (cfg.backbone, cfg.output_stride, cfg.crop_size,
               cfg.crop_size_val, cfg.remat, type(tr.model.body).__name__,
               tuple(tr.last_batch["image"].shape[1:3]))
        if got != want_cfg:
            raise AssertionError(f"coco-voc chain {run}: the recipe is not "
                                 f"WideResNet-38 at OS8, 448/512: {got}")
        gen = torch.Generator(device=tr.device).manual_seed(7)
        profile_step(tr._get_step(0), tr.state, tr.last_batch, gen,
                     steps_ms[1], what=f"coco-voc chain {run} step (one "
                     f"more, on its last batch; idle share of its step 1)")

    launches, _, t2, watch = real_chain(root, common, "coco-voc-voc-ov",
                                        "coco-voc chain", profile_run)
    if t2.classes != list(COCO_VOC) or \
            t2.pseudolabeler.conv1.in_channels != 4096:
        raise AssertionError(f"coco-voc chain: classes {t2.classes}")
    samples = [watch.val[i] for i in range(len(watch.val))]
    fwd = cli.make_instance_forward(t2)
    for smp in (samples[0], samples[3]):   # 512 x 682 and 768 x 512
        img = torch.from_numpy(np.asarray(smp["image"], np.float32))
        hw = smp["gt_masks"].shape[1:]
        fwd(img, hw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fwd(img, hw)
        torch.cuda.synchronize()
        profile_step(lambda *a: fwd(img, hw), None, None, None,
                     (time.perf_counter() - t) * 1e3,
                     what=f"validation forward of a {tuple(hw)} image")
    serve_launches, lifted = serve_from_checkpoint(
        t2, t2.default_ckpt_path(), root, COCO_VOC, WRN_KW,
        variants=("center bias +0.3",), flips=(False,))
    t2.model.load_state_dict(lifted)
    # 8 of the 16 images, to pay for the dist phase (PERF.md section 4)
    validate_voc(t2, samples[:8], "coco-voc, center bias +0.3")
    del t2
    gc.collect()
    torch.cuda.empty_cache()
    return launches, serve_launches


def wrn_step0(dev):
    """Phase 12: the recipe's step-0 train step (make_model((61,),
    WideResNet-38, OS8, 448), batch 16 at 448^2, bf16, Adam 5e-5) without
    and with --remat: 1 warm-up and 2 timed steps each, the peak memory of
    the timed steps, the stamp launched once a step and bit-equal to its
    plain version on the step's own (16, 50) slots."""
    batches = [{k: torch.from_numpy(b[k]).to(dev)
                for k in ("image", "seg", "inst")}
               for b in synthetic_batches(B, S_WRN, C0_WRN, seed=0,
                                          n_batches=2)]
    runs = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = make_model(COCO_VOC[:1], remat=remat, **WRN_KW)
        step = step0.make_step0_train_step(model, sigma=6, max_inst=MAX_INST,
                                           device="cuda", dtype="bfloat16")
        state = step0.init_state(model, "adam",
                                 schedule.make_schedule("poly", 5e-5, 10000))
        gen = torch.Generator(device="cuda").manual_seed(3)
        what = f"WideResNet-38 step-0 (remat {remat})"
        with first_step_checked(what, PER_STEP0):
            metrics, median, _, peak = run_steps(
                what, step, state, batches, gen, PER_STEP0, warmup=1,
                timed=2, size=S_WRN)
        runs[remat] = (median, peak, metrics[0]["loss"])
        del model, step, state
        gc.collect()
        torch.cuda.empty_cache()
    (m0, p0, l0), (m1, p1, l1) = runs[False], runs[True]
    log(f"WideResNet-38 step 0, batch {B} at {S_WRN}x{S_WRN}, bf16: peak "
        f"memory {p0:.3f} GiB without --remat, {p1:.3f} GiB with; median "
        f"step {m0:.3f} / {m1:.3f} ms; first-step loss {l0:.6f} / {l1:.6f}")
    if not p1 < p0:
        raise AssertionError("--remat did not lower the step's peak memory")


class FixedDropout(torch.nn.Module):
    """Dropout with a given keep mask, on whatever device the input is."""

    def __init__(self, keep):
        super().__init__()
        self.keep = keep

    def forward(self, x, generator=None):
        return torch.where(self.keep.to(x.device), x / 0.5, 0.0)


TINY = (1, 1, 1, 1)
# card against CPU, float32 with TF32 off, at phase 2's learning rate. The
# update is held per parameter tensor: the distance between the card's and
# the CPU's update, less the tensor's own float32 rounding, over the CPU's
# update (update_reading). A detached loss term reads 0.3 to 1 in the
# CPU tests against JAX (tests/test_torch_step0.py, test_torch_phase1.py).
CPU_TOL = {"loss (relative)": 2e-4, "parameter updates (relative)": 0.05,
           "BN statistics": 5e-5, "head.red_bn statistics": 1e-3,
           "dead branch updates (of the largest)": 1e-9}
# Under AIN the head's pooled branch is dead in train mode: its norm sees
# one pixel a sample (output = bias), and red_bn removes every per-sample
# spatial constant, so the exact gradient of these tensors is 0 and their
# float32 updates are rounding noise (3e-14 of the largest, CPU). They are
# held to that, not to a relative reading of noise against noise.
AIN_DEAD = ("head.global_pooling_conv.", "head.global_pooling_bn.",
            "head.pool_red_conv.")
TINY_LR = 1e-4


def update_reading(before, cpu, card):
    """||card update - CPU update|| less the float32 spacing of the CPU's
    result, over ||CPU update|| (0, or inf where the CPU's update is 0)."""
    d_cpu = cpu.double() - before.double()
    err = float((card.double() - before.double() - d_cpu).norm())
    floor = float(np.linalg.norm(
        np.spacing(np.abs(cpu.float().numpy())).astype(np.float64)))
    ref = float(d_cpu.norm())
    return (max(err - floor, 0.0) / ref if ref > 0 else
            0.0 if err <= floor else float("inf"))


def tiny_step0(dev, backbone="resnet101", structure=TINY,
               norm_act="iabn_sync"):
    """The tiny step 0 at batch 2 (a ResNet-18 is kept at full depth)."""
    torch.manual_seed(0)
    model = make_model((3,), backbone, 16, 64, norm_act=norm_act,
                       backbone_structure=structure)
    keep = torch.rand((2, 256, 4, 4),
                      generator=torch.Generator().manual_seed(1)) >= 0.5
    model.decoder.instance_decoder.aspp.project_drop = FixedDropout(keep)
    step = step0.make_step0_train_step(model, device=dev)
    state = step0.init_state(model, "sgd",
                             schedule.make_schedule("poly", TINY_LR, 100))
    b = next(synthetic_batches(2, 64, 2, seed=4))
    batch = {k: torch.from_numpy(b[k]) for k in ("image", "seg", "inst")}
    return model, lambda: step(state, batch)


def tiny_phase1(dev, image=None):
    """The tiny phase-1 step at batch 4: at batch 2 the head's train-mode
    global_pooling_bn normalises each channel over 2 pooled values, some
    with a variance far under its eps, and the step's update moves by ~5%
    under 1e-7 input noise (scripts/card_vs_cpu_noise.py). `image`, where
    given, replaces the batch's images."""
    torch.manual_seed(0)
    model = make_model((3, 2), "resnet101", 16, 64, branch="none",
                       backbone_structure=TINY)
    model_old = make_model((3,), "resnet101", 16, 64, branch="none",
                           backbone_structure=TINY)
    pl, pg = PseudoLabeler(5), PeakGenerator(4, 2)
    net = torch.nn.ModuleDict(dict(model=model, pseudolabeler=pl,
                                   peakgenerator=pg))
    step = phase1.make_phase1_train_step(model, model_old, pl, pg, 3,
                                         use_pseudo=True, device=dev)
    opt = schedule.make_optimizer(
        net, "sgd", group_scale={"body": 1.0, "seg": 10.0, "pseudo": 10.0},
        group_fn=phase1.phase1_group_fn)
    state = TrainState(net, opt,
                       schedule.make_schedule("poly", TINY_LR, 100))
    b = next(synthetic_batches(4, 64, 4, seed=6))
    batch = {"image": torch.from_numpy(b["image"] if image is None
                                       else image),
             "l1h": torch.from_numpy(b["l1h"][:, 1:].copy())}
    draws = {"angle_k": 1, "labels_neg": torch.randint(
        0, 3, (4, 4, 4), generator=torch.Generator().manual_seed(2))}
    return net, lambda: step(state, batch, draws=draws)


def card_vs_cpu():
    """Phase 13: one step of each train step at a tiny size on the card and
    on the CPU, from the same weights, batch and draws; step 0 also with
    the ABR and AIN norms and on a full-depth ResNet-18 (basic blocks)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for what, build, dead in (
                ("step 0", tiny_step0, ()), ("phase 1", tiny_phase1, ()),
                ("step 0, --norm_act abr",
                 functools.partial(tiny_step0, norm_act="abr"), ()),
                ("step 0, --norm_act ain",
                 functools.partial(tiny_step0, norm_act="ain"), AIN_DEAD),
                ("step 0, full-depth resnet18", functools.partial(
                    tiny_step0, backbone="resnet18", structure=None), ())):
            runs = {}
            for dev in ("cpu", "cuda"):
                module, call = build(dev)
                before = {k: v.detach().cpu().clone() for k, v in
                          module.state_dict().items()}
                loss = float(call()["loss"])
                runs[dev] = (loss, {k: v.detach().cpu() for k, v in
                                    module.state_dict().items()},
                             {k for k, _ in module.named_parameters()},
                             before)
            (l_cpu, sd_cpu, params, before), (l_card, sd_card, _, _) = \
                runs["cpu"], runs["cuda"]
            err = {"loss (relative)": abs(l_card - l_cpu) / abs(l_cpu)}
            worst = {}
            largest = max(float((t - before[k]).norm()) for k, t in
                          sd_cpu.items() if k in params)
            for k, t in sd_cpu.items():
                if k in params and k.startswith(dead):
                    kind = "dead branch updates (of the largest)"
                    e = max(float((u - before[k]).norm())
                            for u in (t, sd_card[k])) / largest
                elif k in params:
                    kind = "parameter updates (relative)"
                    e = update_reading(before[k], t, sd_card[k])
                else:
                    kind = ("head.red_bn statistics" if ".head.red_bn." in
                            "." + k else "BN statistics")
                    e = float((sd_card[k].float() - t.float()).abs().max())
                if e >= err.get(kind, -1.0):
                    err[kind], worst[kind] = e, k
            log(f"card against CPU, {what} (SGD at {TINY_LR}): loss "
                f"{l_cpu:.8f} (CPU) / {l_card:.8f} (card); " + "; ".join(
                    f"{k} {v:.3e} (tolerance {CPU_TOL[k]:.0e}"
                    f"{', ' + worst[k] if k in worst else ''})"
                    for k, v in err.items()))
            over = [k for k, v in err.items() if not v <= CPU_TOL[k]]
            if over:
                raise AssertionError(f"card against CPU, {what}: {over} above "
                                     f"the tolerance")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------- multi-step protocols

# scripts/run_10-5.sh's runs under one --name: step 0, then phase 1 ->
# phase 2 for steps 1 and 2, each phase 2 reading its phase 1's checkpoint
# and writing over it (phase 1 with --pseudo_ep 0, so that its one epoch
# runs the use_pseudo program, as CHAIN_RUNS does)
MS_STEP0 = ["--step", "0", "--bce", "--optim", "adam", "--lr", "5e-5",
            "--weight_decay", "0"]
MS_PHASE1 = ["--weakly", "--phase", "1", "--alpha", "0.5", "--lr", "1e-3",
             "--loss_de", "1", "--lr_policy", "warmup", "--affinity",
             "--optim", "sgd", "--pseudo_ep", "0"]
MS_PHASE2 = ["--weakly", "--phase", "2", "--alpha", "0.5", "--lr", "5e-5",
             "--loss_de", "1", "--lr_policy", "warmup", "--affinity",
             "--optim", "adam", "--weight_decay", "0"]


def ms_classes_of(i):
    """The 10-5 mini-VOC's classes of image `i`."""
    return (1 + i % 10, 11 + i % 10)


# the 10-5 mini-VOC: each image paints a base class (1-10) and one of
# 11-20, so that at batch 16 step 0 trains on 7 batches and steps 1 and 2
# on 3 each (57 and 55 images; the step-2 runs' step 2 is traced); 15-5's
# mini-VOC leaves step 1 15 images, no batch
MS_N_TRAIN = 112
SAMPLE_NUM = 2
TTA_SCALES = (0.75, 1.0, 1.25)
# the fused TTA logits, card (float32, TF32 off) against the CPU: the
# relative L2 error (float32 convolutions summed in other orders)
TTA_RTOL = 1e-4
DEVICE_TIME_RTOL = 0.02


def multistep_runs(task_dir):
    """(run, kind, argv) of the recipe's five runs."""
    runs = [("step 0", "step 0", MS_STEP0)]
    for s in (1, 2):
        runs += [(f"step {s} phase 1", "phase 1", ["--step", str(s)] +
                  MS_PHASE1),
                 (f"step {s} phase 2", "phase 2", ["--step", str(s)] +
                  MS_PHASE2 + ["--seg_ckpt",
                               os.path.join(task_dir, f"ms_{s}")])]
    return runs


# batches an epoch of the CLI's --synthetic data
SYNTHETIC_BATCHES = inspect.signature(
    cli.SyntheticLoader).parameters["n_batches"].default


def factory_surgery(rec, picked, pause):
    """`on_trainer` for a phase-2 run: `rec` records the trainer; then,
    before its epoch, choose_pseudo_thresh's surgery goes onto the loaded
    models over the epoch's batches, inside `pause` (first_step_checked's):
    each batch's image labels name every new class, the pseudolabeler's
    new channels are lifted (`lift`), the seg is biased toward the chosen
    class and the epoch's step is built with the chosen pseudo
    threshold. `picked` gets (threshold, (images, class), the surgery's
    own kernel launches)."""
    def on_trainer(trainer):
        rec(trainer)
        real_epoch = trainer.train_epoch

        def train_epoch(epoch, batches, logger=None):
            new = trainer.classes[-1]
            batches = [dict(b) for b in batches]
            for b in batches:
                l1h = np.array(b["l1h"], np.float32)
                l1h[:, -new:] = 1.0
                b["l1h"] = l1h
            for m in (trainer.model, trainer.pseudolabeler,
                      trainer.peakgenerator):
                m.eval()
            before = dict(kernels.LAUNCHES)
            with pause():
                thresh, pick = choose_pseudo_thresh(
                    trainer.model, trainer.pseudolabeler,
                    trainer.peakgenerator,
                    [trainer._device_batch(b) for b in batches],
                    old=trainer.old_classes, lift=True)
            trainer.cfg.pseudo_thresh = thresh
            picked.append((thresh, pick, {k: kernels.LAUNCHES[k] - before[k]
                                          for k in before}))
            return real_epoch(epoch, batches, logger)
        trainer.train_epoch = train_epoch
    return on_trainer


def multistep_chain(root, task, common, what, real, surgery=False):
    """The recipe's five runs of VOC `task` with `common` (with `real`, a
    data root: loader workers, validation after each run and --sample_num
    at step 2's phase 2, whose validation runs with the center heads'
    biases raised by 0.3): each run's launches held to its steps, its
    validation and its sample forwards; its checkpoint, finite losses;
    step 2's phase-2 step's own kernel inputs bit-equal through the plain
    versions (with `surgery`, on --synthetic data: factory_surgery on
    that run, every step's inputs held so and its pseudo stamp given a
    valid slot); at step 2 the old model equal to step 1's phase-2
    checkpoint, phase 2's body and seg to its phase 1's, bit for bit.
    Returns the launches of each run, the step-2 phase-2 trainer, the
    kept kernel inputs and the validation set (or None)."""
    ck = os.path.join(root, "ck")
    task_dir = os.path.join(ck, "step", f"voc-{task}-ov")
    logdir = os.path.join(root, "logs")
    launches, kept, sampled = {}, {}, []
    valid, picked = [], []
    n_checked = SYNTHETIC_BATCHES if surgery else 1
    rec, watch = ChainRecorder(), LoaderWatch()
    real_forward = cli.make_instance_forward

    def sampling_forward(trainer):
        # the validation after training, with the center heads' biases
        # raised by 0.3 (as in phase 9), so that the random weights give
        # instances to draw; the checkpoint is already written
        with torch.no_grad():
            for conv in trainer.model.instance_head.classifier.center.cls:
                conv.bias += 0.3
        fwd = real_forward(trainer)

        def run(image, size):
            out = fwd(image, size)
            if len(sampled) < SAMPLE_NUM:
                sampled.append(out["ins_map"].cpu().numpy())
            return out
        return run

    if real:
        cli.build_data = watch
    p1_frozen = None
    try:
        for run, kind, argv in multistep_runs(task_dir):
            last = run == "step 2 phase 2"
            n_samples = SAMPLE_NUM if last and real else 0
            argv = common + ["--task", task, "--name", "ms"] + argv + [
                "--checkpoint", ck, "--logdir", logdir, "--visualize",
                "false", "--profile_dir",
                os.path.join(root, "trace", run.replace(" ", "_"))]
            if n_samples:
                argv += ["--sample_num", str(n_samples)]
                cli.make_instance_forward = sampling_forward
            torch.cuda.synchronize()
            kernels.reset_launches()
            t = time.perf_counter()
            checked = first_step_checked(
                f"{what} {run}", {k: v * n_checked for k, v in
                                  PER_STEP.items()}, kept, valid)
            with checked if last else contextlib.nullcontext() as pause:
                on_trainer = factory_surgery(rec, picked, pause) \
                    if last and surgery else rec
                if cli.main(argv, on_trainer=on_trainer) != 0:
                    raise AssertionError(f"{what} {run}: main() failed")
            cli.make_instance_forward = real_forward
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            tr = rec.made[-1]
            m = tr.epochs[0]
            n = m["n_batches"]
            n_val = len(watch.val) if real else 0
            # the surgery's peak extraction launches top-k once a batch and
            # nothing else; those launches are the smoke's, not the path's
            own = picked[0][2] if last and surgery else {}
            if own and own != {k: n if k == "topk" else 0 for k in own}:
                raise AssertionError(f"{what} {run}: the surgery launched "
                                     f"{own}, expected top-k {n} times")
            launches[run] = {k: v - own.get(k, 0)
                             for k, v in kernels.LAUNCHES.items()}
            want = {k: v * n + PER_REQUEST[k] * n_samples +
                    (VOC_PER_VAL[kind][k] * n_val if real else 0)
                    for k, v in CHAIN_PER_STEP[kind].items()}
            if launches[run] != want:
                raise AssertionError(f"{what} {run}: launches "
                                     f"{launches[run]}, expected {want}")
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"{what} {run}: {m}")
            path = tr.default_ckpt_path()
            if not os.path.exists(path):
                raise AssertionError(f"{what} {run}: no checkpoint {path}")
            steps = [round(v * 1e3, 3) for v in tr.step_timer.times]
            median = float(np.median(steps[1:] or steps))
            log(f"{what} {run}: classes {list(tr.classes)}, main() "
                f"{wall:.3f} s, epoch {n} batches, loss {m['loss']:.6f}, "
                f"step median {median:.3f} ms (steps after the first; "
                f"step times ms {steps}, steps 2-4 under torch.profiler), "
                + (f"{n_val} images validated, " if real else "") +
                f"launches {launches[run]}")
            if run == "step 2 phase 1":
                p1_frozen = {k: v for k, v in load_checkpoint(path)[
                    "model"].items() if schedule.default_group_fn(k) in
                    ("body", "seg")}
            if not last:
                rec.made.clear()
                gc.collect()
                torch.cuda.empty_cache()
            if real:
                no_workers_left(f"{what} {run}")
    finally:
        cli.build_data, cli.make_instance_forward = watch.real, real_forward
    t2 = rec.made[-1]
    rec.made.clear()
    if surgery:
        # the stamps of a step: its pseudo stamp, then its refined one
        pseudo = valid[0::2]
        (thresh, (hits, c), own), = picked
        # the seg bias the surgery added, on phase 1's weights
        key = f"cls.{len(t2.classes) - 1}.bias"
        p1_frozen[key] = p1_frozen[key].clone()
        p1_frozen[key][c - (t2.old_classes - 1)] += 10.0
        log(f"{what} step 2 phase 2 with the factory surgery (pseudo_thresh "
            f"{thresh:.6f}: class {c} has exactly one peak above it in {hits}"
            f" images of the {len(pseudo)} batches; seg bias +10; the "
            f"surgery's own launches {own}): valid "
            f"step-2 slots pseudo/refined a step "
            f"{list(zip(pseudo, valid[1::2]))}, {sum(pseudo)} pseudo in all; "
            f"the four kernels bit-equal to the plain versions on every step")
        if len(pseudo) != SYNTHETIC_BATCHES or not all(v > 0 for v in pseudo):
            raise AssertionError(f"{what}: a step-2 pseudo stamp had no "
                                 f"valid slot: {valid}")

    # the checkpoint identities at step 2
    m1 = load_checkpoint(os.path.join(task_dir, "ms_1"))["model"]
    old = t2.model_old.state_dict()
    sd = t2.model.state_dict()
    bad = [k for k in old if not torch.equal(old[k].cpu(), m1[k])]
    bad += [k for k, v in p1_frozen.items() if not torch.equal(sd[k].cpu(), v)]
    groups = len(t2.model.classes), len(t2.model_old.classes)
    if bad or set(old) != set(m1) or len(p1_frozen) < 100 or groups != (3, 2):
        raise AssertionError(f"{what}: {len(bad)} tensors differ from their "
                             f"checkpoint ({bad[:4]}), groups {groups}")
    log(f"{what} checks: 5 checkpoints, the step-2 model of {groups[0]} "
        f"classifier groups, its old model's {len(old)} tensors ({groups[1]} "
        f"groups) equal step 1's phase-2 checkpoint, phase 2's "
        f"{len(p1_frozen)} body and seg tensors equal its phase 1's, bit "
        f"for bit")
    if real:
        images = os.path.join(logdir, f"voc-{task}-ov", "ms", "images")
        if sorted(os.listdir(images)) != [f"test_sample_{i}.png"
                                          for i in range(SAMPLE_NUM)]:
            raise AssertionError(f"{what}: sample images {os.listdir(images)}")
        from PIL import Image
        for i, ins in enumerate(sampled):
            png = np.asarray(Image.open(os.path.join(
                images, f"test_sample_{i}.png")))
            h, w = ins.shape
            same = np.array_equal(png, sample_image(watch.val[i]["image"][0],
                                                    ins))
            coloured = np.array_equal(png[:, w:].max(-1) > 0, ins >= 0)
            log(f"{what} --sample_num image {i}: {png.shape} {png.dtype}, "
                f"{int((ins >= 0).sum())} instance pixels in "
                f"{len(np.unique(ins[ins >= 0]))} instances; equal to "
                f"sample_image of the forward: {same}; coloured pixels "
                f"those of ins_map >= 0: {coloured}")
            if png.shape != (h, 2 * w, 3) or not same or not coloured:
                raise AssertionError(f"{what}: sample image {i} is wrong")
    return launches, t2, kept, watch.val if real else None


def step2_kernel_rows(kept, C, rs):
    """The kernel rows at the one-new-class step's own inputs: top-k over
    the CAM rows (with torch.topk beside it), CC and run totals as the
    step gave them; the stamp at its pseudo stamp's shape on step_slots'
    pseudo slots (1-3 valid an image: under random weights the step's own
    may hold none), and on the step's own slots ("step_own")."""
    (cam, k), _ = kept["topk"]
    rows = cam.reshape(-1, cam.shape[-1]).contiguous()
    (cls_map,), ckw = kept["cc_multilabel"]
    conn = ckw.get("connectivity", 8)
    rt_args, _ = kept["run_totals"]
    own, _ = kept["stamp"]
    Cs, sigma, hw = own[4], own[5], own[6]
    Bs, K = own[0].shape
    st_args = [torch.from_numpy(a).to(own[0].device) for a in step_slots(
        "pseudo", rs, Bs, K, hw[0], hw[1], Cs)] + [Cs, sigma, hw]
    e = max_abs_err(labelgen.stamp_centers_cuda(*st_args),
                    labelgen.stamp_centers(*st_args))
    if e != 0.0:
        raise AssertionError(f"stamp at ({Bs}, {K}) -> {Cs} channels: {e}")

    def stamp_row(args, what):
        valid = args[0]
        return dict(
            shape=f"({Bs}, {K}) slots, {int(valid.sum())} valid ({what}) -> "
                  f"({Bs}, {Cs}, {hw[0]}, {hw[1]}) float32, sigma {sigma}",
            bound_ms=bound_ms(Bs * Cs * hw[0] * hw[1] * 4 + K * Bs * 13),
            **timings(lambda: labelgen.stamp_centers_cuda(*args),
                      lambda: labelgen.stamp_centers(*args)))
    cls_map = cls_map.to(torch.int32).contiguous()
    out = {
        "topk": dict(
            shape=f"{tuple(rows.shape)} float32, k {k}, the 15-1 step-2 "
                  f"CAM rows (one new class)",
            bound_ms=bound_ms(rows.numel() * 4 + rows.shape[0] * k * 8),
            **timings(lambda: topk.topk_cuda(rows, k),
                      lambda: topk.topk_plain(rows, k),
                      lambda: torch.topk(rows, k))),
        "cc_multilabel": dict(
            shape=f"{tuple(cls_map.shape)} int32, connectivity {conn}, the "
                  f"15-1 step-2 class map",
            bound_ms=bound_ms(2 * cls_map.numel() * 4),
            **timings(lambda: cc.cc_multilabel_cuda(cls_map, conn),
                      lambda: cc.cc_multilabel_plain(cls_map, conn),
                      plain_iters=2)),
        "run_totals": dict(
            shape=f"{tuple(rt_args[0].shape)} int32 x 4 in, x 4 out, the "
                  f"15-1 step-2 refinement keys",
            bound_ms=bound_ms(8 * rt_args[0].numel() * 4),
            **timings(lambda: segsort.run_totals_cuda(*rt_args),
                      lambda: segsort.run_totals_plain(*rt_args))),
        "stamp": dict(stamp_row(st_args, "step_slots' pseudo slots at the "
                                          "15-1 step-2 pseudo stamp's shape"),
                      max_abs_err=e,
                      step_own=stamp_row(own, "the 15-1 step-2 pseudo stamp's "
                                              "own slots")),
    }
    if Cs != C:
        raise AssertionError(f"the step-2 stamp has {Cs} channels, not {C}")
    for r in [*out.values(), out["stamp"]["step_own"]]:
        log(f"at {r['shape']}: {r['ms']} ms events, {r['device_ms']} ms "
            f"device, plain {r['plain_ms']} ms, library {r['library_ms']} ms "
            f"({r['library_device_ms']} ms device), bound "
            f"{r['bound_ms']:.6f} ms")
    return out


def tta_check(model, dev):
    """test_augmentation of the model's semantic logits on an S^2 request
    at TTA_SCALES with flip, in float32 on the card `dev` (TF32 off)
    against the port on the CPU, and its time on the card in float32 and
    bf16."""
    from cl4wsis_tpu_torch.models import tta
    rs = np.random.RandomState(5)
    img = request_image(S, S, rs).astype(np.float32) / 255.0
    img = (img - phase1.IMAGENET_MEAN) / phase1.IMAGENET_STD
    x = torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)[None]
    model.eval()

    def apply(m, bf16=False):
        @torch.no_grad()
        def run(batch):
            where = next(m.parameters()).device
            with torch.autocast(where.type, dtype=torch.bfloat16,
                                enabled=bf16):
                return m.forward_seg(batch, interpolate=False)[0]["seg"]
        return run

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xd = x.to(dev)
        card, pred = tta.test_augmentation(apply(model), xd, TTA_SCALES)
        t32 = time_ms(lambda: tta.test_augmentation(apply(model), xd,
                                                    TTA_SCALES),
                      iters=3, warmup=1)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    t16 = time_ms(lambda: tta.test_augmentation(apply(model, bf16=True), xd,
                                                TTA_SCALES),
                  iters=3, warmup=1)
    cpu_model = copy.deepcopy(model).cpu().float().eval()
    t = time.perf_counter()
    ref, ref_pred = tta.test_augmentation(apply(cpu_model), x, TTA_SCALES)
    cpu_s = time.perf_counter() - t
    card, pred = card.cpu(), pred.cpu()
    rel = float((card - ref).norm() / ref.norm())
    agree = float((pred == ref_pred).float().mean())
    log(f"TTA, the step-2 model's seg logits ({tuple(card.shape)}) on a "
        f"{S}x{S} request, scales {TTA_SCALES} with flip, mean fusion: card "
        f"(float32, TF32 off) against CPU relative L2 error {rel:.3e} "
        f"(tolerance {TTA_RTOL:.0e}), max abs "
        f"{float((card - ref).abs().max()):.3e}, argmax agreement {agree:.6f}; card {t32:.3f} ms float32, "
        f"{t16:.3f} ms bf16 autocast (CUDA events), CPU {cpu_s:.3f} s")
    if not rel <= TTA_RTOL or card.shape != (1, model.tot_classes, S, S):
        raise AssertionError(f"TTA: card and CPU differ ({rel})")
    del cpu_model


def chain_device_time(trace_dir, what):
    """utils/device_time on a chain run's --profile_dir traces: busy time,
    the per-step device times and the top 10 kernels; each traced step's
    device time within the trace's busy time and above 0. Returns the
    traced steps' device ms."""
    rep = device_time.device_time_report(trace_dir)
    steps = device_time.module_step_times(trace_dir)
    ops = device_time.op_breakdown(trace_dir, top=10)
    per_step = steps.get("train_step", [])
    log(f"{what} trace through utils/device_time: busy "
        f"{rep['device_busy_s'] * 1e3:.3f} ms over a span of "
        f"{rep['span_s'] * 1e3:.3f} ms, planes {sorted(rep['planes'])}, "
        f"device ms of each traced step "
        f"{[round(v * 1e3, 3) for v in per_step]}, main_module_times {len(device_time.main_module_times(trace_dir))}"
        f" steps")
    for name, total, count in ops:
        log(f"  {total * 1e3:9.3f} ms  x{count:<5d} {name[:90]}")
    if not per_step or min(per_step) <= 0 or \
            sum(per_step) > rep["device_busy_s"] * (1 + 1e-6):
        raise AssertionError(f"{what}: device_time steps {per_step} against "
                             f"busy {rep['device_busy_s']}")
    return [round(v * 1e3, 3) for v in per_step]


def multistep(rs):
    """Phase 14: the multi-step protocols at full width: VOC 10-5 through
    step 2 on the painted mini-VOC (loader workers, validation after each
    run, --sample_num 2 at step 2's phase 2), its step-2 model validated
    through the kernels and the plain versions, TTA on it, the traces read
    by utils/device_time; VOC 15-1 through step 2 on --synthetic (one new
    class a step), its step-2 phase-2 step's own kernel inputs timed.
    Returns the launches of each chain's runs and the kernel rows at the
    one-new-class shapes."""
    out = {}
    with tempfile.TemporaryDirectory() as root:
        write_mini_voc(os.path.join(root, "data"), ms_classes_of, MS_N_TRAIN)
        common = [a for a in CHAIN_COMMON if a != "--synthetic"] + [
            "--data_root", os.path.join(root, "data"), "--crop_size_val",
            str(S), "--num_workers", str(LOADER_WORKERS), "--pretrained",
            "false"]
        t = time.perf_counter()
        out["10-5"], t2, _, val = multistep_chain(root, "10-5", common,
                                                  "10-5 chain", real=True)
        log(f"10-5 chain: {time.perf_counter() - t:.1f} s")
        validate_voc(t2, [val[i] for i in range(len(val))],
                     "10-5 step 2, center bias +0.3")
        tta_check(t2.model, t2.device)
        chain_device_time(os.path.join(root, "trace", "step_2_phase_2"),
                          "10-5 step 2 phase 2")
        del t2
        gc.collect()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        out["15-1"], t2, kept, _ = multistep_chain(root, "15-1", CHAIN_COMMON,
                                                   "15-1 chain", real=False,
                                                   surgery=True)
        log(f"15-1 chain: {time.perf_counter() - t:.1f} s")
        chain_device_time(os.path.join(root, "trace", "step_2_phase_2"),
                          "15-1 step 2 phase 2")
        rows = step2_kernel_rows(kept, t2.tot_classes - 1, rs)
        del t2, kept
        gc.collect()
        torch.cuda.empty_cache()
    return out, rows


# ------------------------------------------------------- fixture accuracy

REPO = os.path.dirname(os.path.abspath(__file__))
# the painted-fixture protocol of docs/verification.md (seed 42): step 0
# in full, 250 epochs of 12 batches, from torch's init as the protocol
# starts (--torch_init); phase 1 and phase 2 cut to 10 epochs, so that
# the process, the run's longest, ends inside FIXTURE_TIMEOUT_S on a slow
# host and the whole run inside 1000 s
FIXTURE_ARGS = ["--paint", "--wrap", "--images", "48", "--size", "64",
                "--batch", "4", "--epochs", "250", "--cl_epochs", "10",
                "--lr0", "3e-4", "--seed", "42", "--torch_init"]
FIXTURE_RUNS = {"step0": "step 0", "phase1": "phase 1", "phase2": "phase 2"}
FIXTURE_TIMEOUT_S = 1100                   # from the process's start
EXAMPLE_STEPS = 300


def load_script(rel, name):
    """A script of the checkout (scripts/, examples/) as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO,
                                                                     rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fixture_accuracy(args=None):
    """The painted-fixture protocol through the stages of
    scripts/run_rebuild_fixture_torch.py and the CLI on the card, at the
    runner's flags `args` or FIXTURE_ARGS (48 painted images at 64^2,
    batch 4, float32, ResNet-101 at OS16 from torch's init, 4 loader
    workers): step 0 for 250 epochs (Adam 3e-4, validation at e99, e199
    and e249), then phase 1 and phase 2 for 10 epochs each from its
    checkpoints. Every run rc 0 with finite losses and its launches held
    to its steps and validations; step 0's last epoch loss under a tenth
    of its first, its final mAP@.5 above 0; every phase-2 step's kernel
    inputs (the trained models' own) bit-equal through the plain
    versions, with the valid slots its factory stamped; one traced step a
    run read by utils/device_time. Returns the launches of each run and
    the `fixture` line's object."""
    t_phase = time.perf_counter()
    runner = load_script("scripts/run_rebuild_fixture_torch.py",
                         "fixture_runner")
    a = runner.get_parser().parse_args(args or FIXTURE_ARGS)
    tf32 = {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}
    # every phase-2 step through the plain versions: 12 batches an epoch
    n_p2 = (a.cl_epochs or a.epochs) * (a.images // a.batch)
    p2_checked = {k: v * n_p2 for k, v in PER_STEP.items()}
    launches, runs, valid = {}, {}, []
    rec, watch = ChainRecorder(), LoaderWatch()
    cli.build_data = watch
    try:
        with tempfile.TemporaryDirectory() as root:
            for stage, run in FIXTURE_RUNS.items():
                a.stage = stage
                trace = os.path.join(root, "trace", stage)
                torch.cuda.synchronize()
                kernels.reset_launches()
                checked = first_step_checked(
                    f"fixture phase 2, {n_p2} steps; each", p2_checked,
                    valid=valid)
                with (checked if stage == "phase2"
                      else contextlib.nullcontext()):
                    (r,) = runner.run_seed(a, root, on_trainer=rec, extra={
                        stage: ["--profile_dir", trace]})
                torch.cuda.synchronize()
                launches[run] = dict(kernels.LAUNCHES)
                tr = rec.made.pop()
                n_steps = sum(m["n_batches"] for m in tr.epochs)
                n_val = len(watch.val)
                want = {k: v * n_steps + VOC_PER_VAL[run][k] * n_val *
                        len(r["vals"]) for k, v in CHAIN_PER_STEP[run].items()}
                losses = [m["loss"] for m in tr.epochs]
                if r["rc"] != 0 or launches[run] != want or \
                        len(r["loss"]) != tr.cfg.epochs or \
                        not np.all(np.isfinite(losses)):
                    raise AssertionError(f"fixture {run}: rc {r['rc']}, "
                                         f"launches {launches[run]} (expected "
                                         f"{want}), losses {losses[-5:]}")
                r["traced_step_device_ms"] = chain_device_time(
                    trace, f"fixture {run}")
                r["val_epochs"] = [e for e in range(99, len(losses) - 1, 100)
                                   ] + [len(losses) - 1]
                r["n_train"], r["n_val"] = len(watch.train), n_val
                runs[stage] = r
                log(f"fixture {run}: {len(losses)} epochs of "
                    f"{tr.epochs[0]['n_batches']} batches in {r['wall_s']} s"
                    f", loss e0 {losses[0]:.4f} -> e{len(losses) - 1} "
                    f"{losses[-1]:.4f}, validations {r['vals']}, step median "
                    f"{r['step_ms']:.3f} ms (an epoch's host seconds a batch)"
                    f", launches {launches[run]}")
                del tr
                gc.collect()
                torch.cuda.empty_cache()
                no_workers_left(f"fixture {run}")
    finally:
        cli.build_data = watch.real
    s0 = runs["step0"]
    if not s0["loss"][-1] < s0["loss"][0] / 10 or \
            not s0["final"]["map50"] > 0:
        raise AssertionError(f"fixture step 0 did not learn: loss "
                             f"{s0['loss'][0]} -> {s0['loss'][-1]}, final "
                             f"{s0['final']}")
    stamped = {"calls": len(valid), "calls_with_valid": sum(v > 0 for v in
                                                            valid),
               "valid_slots": sum(valid), "first_step": valid[:2]}
    log(f"fixture: the trained phase-2 factory's stamps over {n_p2} steps "
        f"(kernels bit-equal to the plain versions on every step): "
        f"{stamped}")
    line = {"seed": a.seed, "tf32": tf32, "runs": {
        stage: {k: r[k] for k in ("loss", "val_epochs", "vals", "final",
                                  "step_ms", "traced_step_device_ms",
                                  "wall_s", "n_train", "n_val")}
        for stage, r in runs.items()},
        "phase1_miou": runs["phase1"]["final"]["Mean IoU"],
        "phase2_stamped": stamped,
        "wall_s": round(time.perf_counter() - t_phase, 1)}
    return launches, line


def fixture_worker(out_path, *args):
    """The fixture process's entry point: fixture_accuracy on the card
    (at the runner's flags `args`, where given), its launches and line
    saved to `out_path` (JSON). Alone, with phase 1 and phase 2 at the
    runner's 100 epochs:

        python3 chip_smoke.py fixture out.json --paint --wrap --images 48 \
            --epochs 250 --cl_epochs 100 --lr0 3e-4 --seed 43
    """
    kernels.lib()
    launches, line = fixture_accuracy(list(args))
    with open(out_path, "w") as f:
        json.dump({"launches": launches, "line": line}, f)


def kit_worker():
    """Phase 17 alone on the card, in a temporary directory, then the
    step-0 body check of the main process:

        python3 chip_smoke.py kit
    """
    kernels.lib()
    with tempfile.TemporaryDirectory() as root:
        line = realdata_kit(os.path.join(root, "kit"))
        line["body_tensors_equal_on_card"] = kit_body_on_card(line)
    log(json.dumps({"realdata_kit": line}))


def beside_worker(out_path):
    """The process fixture_process starts: phase 15, then phase 17 under
    the directory of `out_path` at a lower CPU priority; both results
    saved to `out_path`."""
    kernels.lib()
    launches, line = fixture_accuracy()
    # the kit overlaps the main process's last phases, which bind the
    # host: its processes (this one's children) yield the cores to them
    os.nice(10)
    kit_line = realdata_kit(os.path.join(os.path.dirname(out_path), "kit"))
    with open(out_path, "w") as f:
        json.dump({"launches": launches, "line": line, "kit": kit_line}, f)


@contextlib.contextmanager
def fixture_process(root):
    """Phase 15 runs in a process of its own beside the other phases, from
    its start to `result()`: its 3000 step-0 steps are bound by the host
    (a traced step keeps the card busy ~20 ms of ~150-220), so it
    overlaps the others rather than adding ~14 minutes after them. The
    process, in a session of its own with its loader workers, is killed
    on leaving. Yields `result()`, which waits for it, prints its log
    without the per-epoch lines and returns fixture_accuracy's result."""
    out_path = os.path.join(root, "fixture.json")
    log_path = os.path.join(root, "fixture.log")
    with open(log_path, "w") as out:
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "beside", out_path], stdout=out,
                             stderr=subprocess.STDOUT, start_new_session=True)
    t = time.perf_counter()

    def result():
        rc = p.wait(timeout=max(1.0, FIXTURE_TIMEOUT_S -
                                (time.perf_counter() - t)))
        with open(log_path) as f:
            lines = [ln for ln in f if not ln.startswith(("[epoch", "Epoch"))]
        log("--- the fixture process's log (per-epoch lines left out) ---")
        log("".join(lines).rstrip())
        log(f"--- fixture process: rc {rc}, {time.perf_counter() - t:.1f} s "
            f"---")
        if rc != 0:
            raise AssertionError(f"the fixture process failed ({rc})")
        with open(out_path) as f:
            got = json.load(f)
        return got["launches"], got["line"], got["kit"]
    try:
        yield result
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def synthetic_example():
    """examples/train_synthetic_torch.py for its EXAMPLE_STEPS steps on the
    card: the stamp once a step, validation through the other kernels;
    returns the launches and the example's result."""
    example = load_script("examples/train_synthetic_torch.py",
                          "train_synthetic_torch")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    res = example.main(EXAMPLE_STEPS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    n_req = launches["topk"]
    if launches != {k: PER_STEP0[k] * EXAMPLE_STEPS + PER_REQUEST[k] * n_req
                    for k in PER_STEP0} or n_req < 1 or \
            not np.isfinite(res["map50"]):
        raise AssertionError(f"the synthetic example: launches {launches}, "
                             f"{res}")
    log(f"examples/train_synthetic_torch.py, {EXAMPLE_STEPS} steps: mAP@.5 "
        f"{res['map50']:.4f}, mAP {res['map']:.4f}, {wall:.1f} s, "
        f"launches {launches}")
    return launches, {"steps": EXAMPLE_STEPS, "map50": res["map50"],
                      "map": res["map"], "wall_s": round(wall, 1)}


# ---------------------------------------------------------- real-data kit

KIT_SCRIPT = "scripts/run_realdata_parity_torch.py"
KIT_TASK = "15-5"
KIT_SEED = 7                                # the ImageNet file's draw
KIT_DROPPED = "mod4.block23.convs.conv2.weight"   # the copy without a key
KIT_CHECK_TIMEOUT_S = 180
# the kit stops a stage (its whole session) at its own timeout; three of
# them end inside the --run port process's, so no stage outlives the kit
KIT_STAGE_TIMEOUT_S = 180
KIT_TIMEOUT_S = 3 * KIT_STAGE_TIMEOUT_S + 60


def kit_argv(root, pretrained="pretrained"):
    """The kit's flags for the mini-VOC and the ImageNet files under
    `root`; everything else at the kit's defaults (the recipe's seed 42,
    4 loader workers)."""
    return ["--task", KIT_TASK, "--data_root", os.path.join(root, "data"),
            "--pretrained_dir", os.path.join(root, pretrained),
            "--workdir", os.path.join(root, "work"),
            "--out", os.path.join(root, "kit.json"),
            "--timeout", str(KIT_STAGE_TIMEOUT_S)]


def kit_rows(out):
    """The readiness rows the kit printed, as (status, needed by), and the
    coverage of its ImageNet file where it opened one."""
    rows, cov = [], None
    for ln in out.splitlines():
        m = re.fullmatch(r"  \[(\w+)\] .* \((\w+)\)", ln)
        if m:
            rows.append((m.group(1), m.group(2)))
        elif "coverage of the" in ln:
            cov = json.loads(ln.split("body: ", 1)[1])
    return rows, cov


def realdata_kit(root):
    """Phase 17 under `root`: the kit's three readiness checks, run at
    once, then its --run port at --epochs_scale 0.01, each the kit's own
    process, its CLI stages processes of their own with wandb kept out of
    them (as the fixture protocol keeps it out), so that they write only
    under `root`. Returns the `realdata_kit` line's object."""
    t_phase = time.perf_counter()
    kit = load_script(KIT_SCRIPT, "realdata_kit")
    run_argv = kit_argv(root) + ["--run", "port", "--epochs_scale", "0.01"]
    a = kit.get_parser().parse_args(run_argv)
    write_mini_voc(a.data_root)
    cfg = kit.step0_config(a)
    shapes = kit.body_shapes(cfg)
    good = kit.requirements(KIT_TASK, a.data_root, a.pretrained_dir,
                            cfg.backbone)[-1][1]
    write_fake_iabn(good, shapes, seed=KIT_SEED)
    blob = torch.load(good, weights_only=False)
    del blob["state_dict"]["module." + KIT_DROPPED]
    missing = os.path.join(root, "pretrained_missing",
                           os.path.basename(good))
    os.makedirs(os.path.dirname(missing))
    torch.save(blob, missing)
    del blob
    os.makedirs(os.path.join(root, "pretrained_misnamed"))
    os.link(good, os.path.join(root, "pretrained_misnamed",
                               "resnet101_iabn.pth.tar"))
    no_wandb = os.path.join(root, "no_wandb")
    os.makedirs(no_wandb)
    with open(os.path.join(no_wandb, "wandb.py"), "w") as f:
        f.write('raise ImportError("wandb is kept out of these runs")\n')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        no_wandb, REPO, os.environ.get("PYTHONPATH")])))
    log(f"kit: mini-VOC ({N_TRAIN} + {N_VAL} images) and the ImageNet file "
        f"({len(shapes)} body tensors, "
        f"{os.path.getsize(good) / 2**20:.1f} MiB) written in "
        f"{time.perf_counter() - t_phase:.1f} s")

    t = time.perf_counter()
    procs = {what: subprocess.Popen(
        [sys.executable, os.path.join(REPO, KIT_SCRIPT),
         *kit_argv(root, pre)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for what, pre in (("ready", "pretrained"),
                          ("missing_key", "pretrained_missing"),
                          ("misnamed", "pretrained_misnamed"))}
    try:
        outs = {w: p.communicate(timeout=KIT_CHECK_TIMEOUT_S)[0]
                for w, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    checks = {}
    for what, p in procs.items():
        rows, cov = kit_rows(outs[what])
        checks[what] = {"rc": p.returncode, "image_net": rows[-1][0],
                        "rows_ok": sum(r == ("OK", "both") for r in rows),
                        "coverage": cov}
    want_rows = sum(r[2] == "both" for r in kit.requirements(
        KIT_TASK, a.data_root, a.pretrained_dir))
    ready, miss, named = (checks[w] for w in ("ready", "missing_key",
                                               "misnamed"))
    cov = ready["coverage"] or {}
    if not (ready["rc"] == 0 and ready["rows_ok"] == want_rows and
            cov.get("covered") == cov.get("body") == len(shapes) and
            cov.get("n_missing") == cov.get("n_wrong_shape") == 0 and
            miss["rc"] == 1 and miss["image_net"] == "MISMATCH" and
            (miss["coverage"] or {}).get("missing") == ["body." + KIT_DROPPED]
            and named["rc"] == 1 and named["image_net"] == "MISSING"):
        raise AssertionError(f"kit readiness checks: {checks}\n" +
                             "\n".join(outs.values()))
    check_s = time.perf_counter() - t
    log(f"kit readiness (3 checks at once, {check_s:.1f} s): ready rc 0, "
        f"{ready['rows_ok']} rows the port reads OK, coverage "
        f"{json.dumps({k: v for k, v in cov.items() if k.startswith(('covered', 'body', 'n_'))})}"
        f"; without {KIT_DROPPED}: rc {miss['rc']}, MISMATCH; under a wrong "
        f"name: rc {named['rc']}, MISSING")

    t = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.join(REPO, KIT_SCRIPT),
                        *run_argv], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=KIT_TIMEOUT_S)
    run_s = time.perf_counter() - t
    with open(a.out) as f:
        res = json.load(f)
    stages, logged = res["port"], res["port_logged"]
    cmds = kit.port_cmds(a)
    hand_off = [cmds[1][cmds[1].index("--step_ckpt") + 1],
                cmds[2][cmds[2].index("--seg_ckpt") + 1]]
    bad = [] if p.returncode == 0 and len(stages) == len(logged) == 3 \
        else ["rc or stage count"]
    for st, lg in zip(stages, logged):
        fin = lg["final"] or {}
        if st["rc"] != 0:
            bad.append(f"stage {st['stage']} rc {st['rc']}")
        elif lg["phase"] == 1:
            if st["map50"] is not None or "Mean IoU" not in fin:
                bad.append(f"stage {st['stage']}: {st}, {fin}")
        elif not ("map50" in fin and
                  st["map50"] == float(f"{fin['map50']:.4f}") and
                  st["map"] == float(f"{fin['map']:.4f}")):
            bad.append(f"stage {st['stage']}: parsed {st}, JSONL {fin}")
    bad += [f"no {path}" for path in hand_off if not os.path.exists(path)]
    if bad:
        tails = [st.get("tail", "") for st in stages]
        raise AssertionError(f"kit --run port: {bad}\n{p.stdout[-3000:]}\n"
                             f"{p.stderr[-3000:]}\n" + "\n".join(tails))
    for st, lg in zip(stages, logged):
        fin = lg["final"]
        with open(os.path.join(a.workdir, f"rb_stage{st['stage']}.log")) as f:
            said = [ln.rstrip() for ln in f
                    if ln.startswith(("[epoch", "[test]", "[ckpt]"))]
        log(f"kit stage {st['stage']} (step {lg['step']}, phase "
            f"{lg['phase']}): rc 0 in {st['wall_s']} s, map50 {st['map50']}"
            f", map {st['map']} (JSONL {fin.get('map50')}, "
            f"{fin.get('map')}; mIoU {fin.get('Mean IoU')}); it said "
            f"{said}")
    log(f"kit --run port: {run_s:.1f} s; {hand_off[0]} and {hand_off[1]} "
        f"written where the next stage reads them")
    return {"task": KIT_TASK, "epochs_scale": 0.01,
            "checks": checks, "check_s": round(check_s, 1),
            "stages": [{"stage": st["stage"], "step": lg["step"],
                        "phase": lg["phase"], "rc": st["rc"],
                        "wall_s": st["wall_s"], "map": st["map"],
                        "map50": st["map50"],
                        "jsonl_map50": lg["final"].get("map50"),
                        "jsonl_miou": lg["final"].get("Mean IoU")}
                       for st, lg in zip(stages, logged)],
            "run_s": round(run_s, 1), "step0_argv": cmds[0],
            "wall_s": round(time.perf_counter() - t_phase, 1),
            "card": card_line()}


def kit_body_on_card(kit_line):
    """The step-0 Trainer of the kit's own step-0 argv (the card, the
    default device) before any step: every body tensor equal, bit for
    bit, to what the port's loader converts from the ImageNet file.
    Returns the count of tensors held."""
    argv = kit_line["step0_argv"]
    cfg = cli.parse_config(argv[argv.index("cl4wsis_tpu_torch.cli.main")
                                + 1:])
    t = time.perf_counter()
    trainer = cli.Trainer(cfg, iters_per_epoch=N_TRAIN // B)
    path = os.path.join(trainer.cfg.pretrained_path,
                        pretrained_name(trainer.cfg.backbone))
    want = load_torch_pretrained(path)
    body = {k: v for k, v in trainer.model.state_dict().items()
            if k.startswith("body.")}
    raw = torch.load(path, weights_only=False)["state_dict"]
    unequal = [k for k in want if not torch.equal(body[k].cpu(), want[k])]
    if trainer.device.type != "cuda" or body.keys() != want.keys() or \
            unequal or not (raw["module.mod1.bn1.weight"] < 0).any():
        raise AssertionError(f"the kit's step-0 body on the card: device "
                             f"{trainer.device}, {len(body)} body tensors "
                             f"against {len(want)} in the file, unequal "
                             f"{unequal[:5]}")
    log(f"kit: the step-0 Trainer of the kit's own argv on "
        f"{trainer.device} ({time.perf_counter() - t:.1f} s): its "
        f"{len(body)} body tensors equal the file's converted tensors bit "
        f"for bit before any step (BN weights as |weight|)")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return len(body)


# ------------------------------------------------------------- dist phase

DIST_RANKS = 2
B_RANK = B // DIST_RANKS
DIST_STEPS = 3
DIST_LR = 1e-4
# 2 ranks x 8 against one process at 16, both on the card, SGD (an update
# linear in the gradient): the first step's loss and update, from the same
# weights (the later steps run on, but SGD at this rate diverges from
# random weights, 75 -> 1249 -> 41606 in phase 2, so they are not held).
# In bf16 the loss is held (limit fixed before the first run); the updates
# are printed beside one process's own with its ABN sums taken in two
# halves, not held: an ABN statistic summed in another order differs in
# its last float32 bits, which flips the bf16 rounding of some outputs, and
# at random weights that moves a tensor's update by as much as itself
# (PERF.md section 6). The float32 run below holds the updates.
DIST_BF16_TOL = {"loss (relative)": 2e-2}
# the same at card_vs_cpu's tiny depth, 64^2, batch 4, float32, TF32 off,
# at card_vs_cpu's limits: at batch 4 the tiny step 0 is ill-conditioned
# (BN over 2 pooled values a rank), and one process's own first update
# moves by up to 1.0e-2 (median 1.3e-3) when only its ABN sums are taken
# in two halves (CPU, float32)
DIST_F32_TOL = {"loss (relative)": 1e-4, "parameter updates (relative)": 0.05}
# world 1 under torchrun and NCCL against the chain phase on the same seed:
# bf16 cuDNN backward kernels are not bitwise deterministic run to run
DIST_CHAIN_RTOL = 2e-2


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sgd_state(model, group_scale, group_fn=None):
    kw = {} if group_fn is None else {"group_fn": group_fn}
    opt = schedule.make_optimizer(model, "sgd", group_scale=group_scale, **kw)
    return TrainState(model, opt, schedule.make_schedule("poly", DIST_LR,
                                                         10000))


def dist_steps(what, step, state, batches, dev, per_step, seed=3):
    """DIST_STEPS steps on this rank's rows of the global `batches` (every
    rank draws from a generator seeded alike): each step's metrics (this
    rank's shares), times (ms), the kernel launches, the all-reduces a step
    makes and the ABN layers whose statistics were summed, and the
    parameters before, after the first step and after the last (on the
    CPU)."""
    from cl4wsis_tpu_torch.core import dist
    params = dict(state.model.named_parameters())
    before = {k: v.detach().cpu().clone() for k, v in params.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    counts = {"all_reduce": 0, "abn": 0}
    real_ar, real_stats = torch.distributed.all_reduce, abn.batch_stats

    def counting_ar(*a, **kw):
        counts["all_reduce"] += 1
        return real_ar(*a, **kw)

    def counting_stats(*a):
        counts["abn"] += 1
        return real_stats(*a)
    metrics, times, per = [], [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.distributed.all_reduce, abn.batch_stats = counting_ar, counting_stats
    try:
        for i in range(DIST_STEPS):
            mine = {k: dist.rows_of(v)
                    for k, v in batches[i % len(batches)].items()}
            counts.update(all_reduce=0, abn=0)
            t = time.perf_counter()
            m = step(state, mine, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            per.append(dict(counts))
            if i == 0:
                first = {k: v.detach().cpu().clone()
                         for k, v in params.items()}
    finally:
        torch.distributed.all_reduce, abn.batch_stats = real_ar, real_stats
    launches = dict(kernels.LAUNCHES)
    want = {k: v * DIST_STEPS for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{what}: rank {dist.rank()} launches "
                             f"{launches}, expected {want}")
    after = {k: v.detach().cpu().clone() for k, v in params.items()}
    return {"metrics": metrics, "times_ms": times, "launches": launches,
            "collectives": per, "before": before, "first": first,
            "after": after}


def dist_phase2(dev, surgery=None):
    """The phase-2 step of the chip phase 5 set-up (batch 16 global) with
    SGD; `surgery` (pseudo_thresh, class) as the one process chose it, so
    that every rank applies the same."""
    model, model_old, pl, pg, _, batches = build_training(dev)
    if surgery is None:
        thresh, pick = choose_pseudo_thresh(model, pl, pg, batches)
        surgery = (thresh, pick[1])
    else:
        with torch.no_grad():
            model.cls[1].bias[surgery[1] - (OLD - 1)] += 10.0
    step = phase2.make_phase2_train_step(model, model_old, pl, pg, OLD,
                                         pseudo_thresh=surgery[0],
                                         device=dev, dtype="bfloat16")
    state = sgd_state(model, {"body": 0.0, "seg": 0.0, "instance": 10.0,
                              "pseudo": 0.0})
    return dist_steps("phase 2", step, state, batches, dev, PER_STEP), surgery


def dist_step0(dev):
    torch.manual_seed(0)
    model = make_model((OLD,), "resnet101", 16, S)
    step = step0.make_step0_train_step(model, sigma=6, max_inst=MAX_INST,
                                       device=dev, dtype="bfloat16")
    state = sgd_state(model, None)
    return dist_steps("step 0", step, state, step0_batches(dev, 2), dev,
                      PER_STEP0)


def dist_tiny(dev):
    """Step 0 and phase 2 of the tiny model at batch 4, 64^2, float32 with
    TF32 off, dropout from the step's generator (so at the global shape)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.manual_seed(0)
        m0 = make_model((3,), "resnet101", 16, 64, backbone_structure=TINY)
        st0 = step0.make_step0_train_step(m0, device=dev)
        b = next(synthetic_batches(4, 64, 2, seed=4))
        out = {"step 0": dist_steps(
            "tiny step 0", st0, sgd_state(m0, None),
            [{k: torch.from_numpy(b[k]).to(dev) for k in ("image", "seg",
                                                          "inst")}],
            dev, PER_STEP0)}
        torch.manual_seed(0)
        model = make_model((3, 2), "resnet101", 16, 64,
                           backbone_structure=TINY).to(dev)
        model_old = make_model((3,), "resnet101", 16, 64,
                               backbone_structure=TINY)
        pl, pg = PseudoLabeler(5).to(dev), PeakGenerator(4, 2).to(dev)
        rs = np.random.RandomState(3)
        images = torch.from_numpy(
            (rs.randn(4, 64, 64, 3) * 0.5).astype(np.float32)).to(dev)
        l1h = torch.ones((4, 4), device=dev)
        l1h[:, 1] = 0.0
        with torch.no_grad():     # tests/test_torch_dist_steps.py's surgery
            pg.extra_conv4.bias += 0.5
            for m in (model, pl, pg):
                m.eval()
            _, feats = model.forward_seg(images.permute(0, 3, 1, 2),
                                         interpolate=False)
            _, cam = pg(pl(feats["body"]), label=l1h)
            cam = resize_bilinear(smoothing(cam)[:, 2:], (64, 64))
            conf = peak_extract_nchw(cam, kernel=15, k=2)[0].cpu().numpy()
            gaps = conf[:, :, 0] - conf[:, :, 1]
            bi, c = np.unravel_index(int(np.argmax(gaps)), gaps.shape)
            thresh = float((conf[bi, c, 0] + conf[bi, c, 1]) / 2)
            model.cls[1].bias[c] += 10.0
            model.instance_head.classifier.center.cls[1].bias += 0.5
        st2 = phase2.make_phase2_train_step(model, model_old, pl, pg, 3,
                                            pseudo_thresh=thresh,
                                            nms_kernel=15, device=dev)
        out["phase 2"] = dist_steps(
            "tiny phase 2", st2, sgd_state(model, {
                "body": 0.0, "seg": 0.0, "instance": 10.0, "pseudo": 0.0}),
            [{"image": images, "l1h": l1h}], dev, PER_STEP)
        return out
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def lift_centers(path, lifted_path):
    """A copy of a checkpoint with the center heads' biases raised by 0.3,
    so that validation of random weights finds instances."""
    from cl4wsis_tpu_torch.cl.ckpt import save_checkpoint
    blob = load_checkpoint(path)
    for k, v in blob["model"].items():
        if k.startswith("instance_head.classifier.center.cls.") and \
                k.endswith(".bias"):
            v += 0.3
    save_checkpoint(lifted_path, blob)


def dist_cli(root, runs, val, recorder, common=CHAIN_COMMON):
    """cli.main for each (name, argv) of `runs` on synthetic batches with
    `val` (or None) as the validation set; per run the process group its
    trainer saw (world, backend, device) and whether one is left after
    main, its epochs, step times (ms), save and load times (s), the
    launches and the validation results."""
    from cl4wsis_tpu_torch.core import dist
    real_build, real_val = cli.build_data, cli.validate_instances
    results = []

    def keeping(*a):
        results.append(real_val(*a))
        return results[-1]
    cli.build_data = lambda cfg: (cli.SyntheticLoader(cfg), val)
    cli.validate_instances = keeping
    out = {}
    try:
        for name, argv in runs:
            results.clear()
            torch.cuda.synchronize()
            kernels.reset_launches()
            n = len(recorder.made)
            group = []

            def watch(trainer):
                recorder(trainer)
                group.extend([dist.world(), torch.distributed.get_backend()
                              if torch.distributed.is_initialized() else None,
                              str(trainer.device)])
            if cli.main(common + argv + [
                    "--checkpoint", os.path.join(root, "ck"), "--visualize",
                    "false", "--profile_dir", os.path.join(root, "trace")],
                    on_trainer=watch) != 0:
                raise AssertionError(f"{name}: main() failed")
            torch.cuda.synchronize()
            tr = recorder.made[n]
            out[name] = {"group": group,
                         "group_left": torch.distributed.is_initialized(),
                         "epochs": tr.epochs, "times": dict(tr.times),
                         "steps_ms": [v * 1e3 for v in
                                      (tr.step_timer.times if tr.step_timer
                                       else [])],
                         "launches": dict(kernels.LAUNCHES),
                         "val": list(results)}
            recorder.made[n] = None       # the models go
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        cli.build_data, cli.validate_instances = real_build, real_val
    return out


def dist_world1(root, val_path, out_path):
    """Under torchrun at world 1 with CL4WSIS_MULTIHOST=1: step 0, phase 1,
    phase 2 and phase 2 resumed (--epochs 2 --continue_ckpt), then --test
    of the phase-2 checkpoint with raised center biases on 8 painted
    images. Each cli.main makes the NCCL group and destroys it (at world 1
    no other rank can meet a former group's keys in torchrun's store)."""
    ck = os.path.join(root, "ck", "step", "voc-15-5-ov")
    s0, p1, p2 = (os.path.join(ck, n) for n in ("exp_0", "exp_p1_1",
                                                "exp_p2_1"))
    extra = {"step 0": [], "phase 1": ["--step_ckpt", s0],
             "phase 2": ["--step_ckpt", s0, "--seg_ckpt", p1]}
    runs = [(r, CHAIN_RUNS[r] + extra[r]) for r in extra]
    runs.append(("phase 2 resumed", CHAIN_RUNS["phase 2"] + extra[
        "phase 2"] + ["--epochs", "2", "--continue_ckpt", "true"]))
    out = dist_cli(root, runs, None, ChainRecorder())
    lift_centers(p2, os.path.join(ck, "lifted"))
    out.update(dist_cli(root, [("test", CHAIN_RUNS["phase 2"] + [
        "--step_ckpt", s0, "--test", "--ckpt", os.path.join(ck, "lifted")])],
        torch.load(val_path, weights_only=False), ChainRecorder()))
    torch.save(out, out_path)


def dist_rank(spec_path, out_prefix):
    """One of DIST_RANKS ranks sharing the card: the gloo group made here
    (NCCL takes one rank a card), LOCAL_RANK 0 for every rank."""
    from cl4wsis_tpu_torch.core import dist
    torch.distributed.init_process_group(
        "gloo", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    try:
        if dist.init_from_env("cuda"):
            raise AssertionError("init_from_env made a second group")
        spec = torch.load(spec_path, weights_only=False)
        dev = dist.local_device("cuda")
        kernels.lib()
        res = {}
        t = time.perf_counter()
        res["phase 2"], _ = dist_phase2(dev, spec["surgery"])
        res["step 0"] = dist_step0(dev)
        res["tiny"] = dist_tiny(dev)
        res["steps_s"] = time.perf_counter() - t
        t = time.perf_counter()
        root = spec["root"]
        s0 = os.path.join(root, "ck", "step", "voc-15-5-ov", "exp_0")
        p1 = os.path.join(root, "ck", "step", "voc-15-5-ov", "exp_p1_1")
        runs = [("step 0", CHAIN_RUNS["step 0"]),
                ("phase 1", CHAIN_RUNS["phase 1"] + ["--step_ckpt", s0]),
                ("phase 2", CHAIN_RUNS["phase 2"] + ["--step_ckpt", s0,
                                                     "--seg_ckpt", p1])]
        common = CHAIN_COMMON + ["--batch_size", str(B_RANK), "--tiny",
                                 "true"]
        val = torch.load(spec["val"], weights_only=False)
        res["chain"] = dist_cli(root, runs, None, ChainRecorder(), common)
        res["chain"].update(dist_cli(root, [("test", CHAIN_RUNS["phase 2"] + [
            "--step_ckpt", spec["step0_ckpt"], "--test", "--ckpt",
            spec["lifted"], "--tiny", "false"])], val, ChainRecorder(),
            common))
        res["chain_s"] = time.perf_counter() - t
        torch.save(res, f"{out_prefix}{dist.rank()}.pt")
    finally:
        torch.distributed.destroy_process_group()


WORKERS = {"dist-world1": dist_world1, "dist-rank": dist_rank,
           "fixture": fixture_worker, "beside": beside_worker,
           "kit": kit_worker}


def first_update_readings(one, other):
    """update_reading of `other`'s first update against `one`'s, for each
    tensor `one`'s first step moved."""
    return {k: update_reading(one["before"][k], t, other["first"][k])
            for k, t in one["first"].items()
            if not torch.equal(t, one["before"][k])}


@contextlib.contextmanager
def abn_sums_in_halves():
    """In one process, ABN's float32 batch sums taken over the two halves
    of the batch and added, as 2 ranks take them: the order of the sums is
    all that changes."""
    real = abn.batch_stats

    def halves(xf):
        C, dims, h = xf.shape[1], (0, 2, 3), xf.shape[0] // 2
        sums = sum(torch.cat([p.sum(dims), torch.square(p).sum(dims),
                              p.new_full((1,), p.numel() // C)])
                   for p in (xf[:h], xf[h:]))
        mean = sums[:C] / sums[-1]
        return mean, sums[C:2 * C] / sums[-1] - torch.square(mean), sums[-1]
    abn.batch_stats = halves
    try:
        with abn.summed_stats():
            yield
    finally:
        abn.batch_stats = real


def compare_steps(what, one, ranks, tol, floor=None):
    """The ranks' summed first-step loss and rank 0's first update against
    the one process's (update_reading per tensor); both ranks must end
    equal after every step. `tol` names what is held; with `floor` (one
    process with abn_sums_in_halves) its readings against `one` are
    printed beside the ranks'."""
    m = one["metrics"][0]
    got = sum(r["metrics"][0]["loss"] for r in ranks)
    err = {"loss (relative)": abs(got - m["loss"]) / abs(m["loss"])}
    for k, t in ranks[0]["after"].items():
        if not torch.equal(t, ranks[1]["after"][k]):
            raise AssertionError(f"{what}: the ranks' {k} differ")
    rd = first_update_readings(one, ranks[0])
    if not rd:
        raise AssertionError(f"{what}: no parameter moved")
    worst = max(rd, key=rd.get)
    err["parameter updates (relative)"] = rd[worst]
    text = (f"2 ranks against one process, {what}: step losses "
            f"{[round(x['loss'], 6) for x in one['metrics']]} (one) / "
            f"{[round(sum(r['metrics'][i]['loss'] for r in ranks), 6) for i in range(len(one['metrics']))]}"
            f" (ranks); first step: {len(rd)} parameter tensors moved, "
            f"update reading median {float(np.median(list(rd.values()))):.3e}"
            f", largest {rd[worst]:.3e} ({worst}); loss (relative) "
            f"{err['loss (relative)']:.3e}")
    if floor is not None:
        fl = first_update_readings(one, floor)
        text += (f"; one process with its ABN sums in two halves against "
                 f"one process: loss (relative) "
                 f"{abs(floor['metrics'][0]['loss'] - m['loss']) / abs(m['loss']):.3e}, update reading median "
                 f"{float(np.median(list(fl.values()))):.3e}, largest "
                 f"{max(fl.values()):.3e}")
    log(text + "; held: " + ", ".join(f"{k} <= {v:.0e}"
                                      for k, v in tol.items()))
    over = [k for k, v in tol.items() if not err[k] <= v]
    if over:
        raise AssertionError(f"2 ranks against one process, {what}: {over} "
                             f"above the tolerance")


def dist_phase(chain_seen, rs):
    """Phase 15: data-parallel runs. (a) The CLI chain under torchrun at
    world 1 and NCCL (step 0, phase 1, phase 2, a resumed phase 2) and
    --test of the lifted phase-2 checkpoint on 8 painted images; held
    against the chain phase. (b) DIST_RANKS gloo ranks sharing the card at batch 8
    each: 3 phase-2 and 3 step-0 steps at full width in bf16 and tiny
    steps in float32, held against one process at batch 16 (4) on the
    card; the tiny chain at 2 ranks and --test of the same checkpoint,
    held against (a). Returns each kernel's per-rank launches."""
    me = os.path.abspath(__file__)
    env = dict(os.environ, CL4WSIS_MULTIHOST="1",
               PYTHONPATH=os.pathsep.join(filter(None, [
                   os.path.dirname(me),
                   os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as root:
        val_path = os.path.join(root, "val.pt")
        torch.save(painted_samples(rs), val_path)
        a_root = os.path.join(root, "a")
        # (a) world 1, NCCL, through torchrun
        t = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
             "1", "--master_addr", "127.0.0.1", "--master_port",
             str(free_port()), me, "dist-world1", a_root, val_path,
             os.path.join(root, "a.pt")],
            env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        if p.returncode != 0:
            raise AssertionError(f"the world-1 chain failed ({p.returncode}):"
                                 f"\n{p.stdout[-4000:]}\n{p.stderr[-6000:]}")
        a = torch.load(os.path.join(root, "a.pt"), weights_only=False)
        log(f"world 1 under torchrun, NCCL: step 0, phase 1, phase 2, phase 2"
            f" resumed and --test in {wall:.1f} s (one process)")
        for run in ("step 0", "phase 1", "phase 2", "phase 2 resumed",
                    "test"):
            if a[run]["group"] != [1, "nccl", "cuda:0"] or \
                    a[run]["group_left"]:
                raise AssertionError(f"world-1 {run}: group "
                                     f"{a[run]['group']}, left after main "
                                     f"{a[run]['group_left']}")
        for run in ("step 0", "phase 1", "phase 2"):
            got, want = a[run]["epochs"][0], chain_seen[run]["epoch"]
            err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                      for k in want
                      if k.startswith("l") and k != "loader_wait_s")
            med = float(np.median(a[run]["steps_ms"][1:]))
            ref = float(np.median(chain_seen[run]["steps_ms"][1:]))
            log(f"world-1 {run}: loss {got['loss']:.6f} against the chain "
                f"phase's {want['loss']:.6f} (largest relative difference "
                f"of the losses {err:.3e}, tolerance {DIST_CHAIN_RTOL:.0e}); "
                f"step median {med:.3f} ms against {ref:.3f} ms (steps 2-n,"
                f" steps 2-3 profiled); launches {a[run]['launches']}; "
                f"save {a[run]['times'].get('save', 0.0):.3f} s")
            if not err <= DIST_CHAIN_RTOL:
                raise AssertionError(f"world-1 {run} differs from the chain")
        res = a["phase 2 resumed"]["epochs"]
        if len(res) != 1 or res[0]["n_batches"] != 4:
            raise AssertionError("the resumed phase 2 did not train epoch 1 "
                                 "alone")
        test_a = a["test"]["val"][0]
        log(f"world-1 --test of the lifted phase-2 checkpoint: map "
            f"{test_a['map']:.6f}, map50 {test_a['map50']:.6f}, truncated "
            f"{test_a['truncated_centers']}; launches {a['test']['launches']}")

        # (b) the one-process references on the card, then the ranks
        dev = torch.device("cuda")
        t = time.perf_counter()
        # ABN's statistics from the sums, as the ranks take them: one
        # process otherwise takes them in the fused batch norm
        with abn.summed_stats():
            one_p2, surgery = dist_phase2(dev)
            one_s0 = dist_step0(dev)
            one_tiny = dist_tiny(dev)
        with abn_sums_in_halves():
            floor_p2, _ = dist_phase2(dev, surgery)
            floor_s0 = dist_step0(dev)
            floor_tiny = dist_tiny(dev)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"one-process references (3 + 3 full-width steps at batch {B}, "
            f"tiny steps, the full-width steps again with the ABN sums in "
            f"halves): {time.perf_counter() - t:.1f} s")
        spec_path = os.path.join(root, "spec.pt")
        ck = os.path.join(a_root, "ck", "step", "voc-15-5-ov")
        torch.save({"surgery": surgery, "root": os.path.join(root, "b"),
                    "val": val_path, "step0_ckpt": os.path.join(ck, "exp_0"),
                    "lifted": os.path.join(ck, "lifted")}, spec_path)
        port = free_port()
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, me, "dist-rank", spec_path,
             os.path.join(root, "rank")],
            env=dict(env, RANK=str(r), WORLD_SIZE=str(DIST_RANKS),
                     LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DIST_RANKS)]
        try:
            logs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, out) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} failed ({p.returncode}):\n"
                                     f"{out[-6000:]}")
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                            weights_only=False) for r in range(DIST_RANKS)]
        log(f"{DIST_RANKS} gloo ranks on one card: {time.perf_counter() - t:.1f}"
            f" s (steps {ranks[0]['steps_s']:.1f} s, chain and --test "
            f"{ranks[0]['chain_s']:.1f} s a rank)")
        for what, one, key, floor in (
                ("phase-2 steps, bf16", one_p2, "phase 2", floor_p2),
                ("step-0 steps, bf16", one_s0, "step 0", floor_s0)):
            rr = [r[key] for r in ranks]
            compare_steps(what, one, rr, DIST_BF16_TOL, floor)
            log(f"  {what}: step ms per rank "
                f"{[[round(v, 3) for v in r['times_ms']] for r in rr]}, "
                f"median (steps 2-3) "
                f"{[float(np.median(r['times_ms'][1:])) for r in rr]} against"
                f" one process at {B} "
                f"{float(np.median(one['times_ms'][1:])):.3f}; launches per "
                f"rank {[r['launches'] for r in rr]}; all-reduces a step "
                f"{rr[0]['collectives']} (ABN layers summed: 'abn')")
        for key in ("step 0", "phase 2"):
            compare_steps(f"tiny {key}, float32 (TF32 off)", one_tiny[key],
                          [r["tiny"][key] for r in ranks], DIST_F32_TOL,
                          floor_tiny[key])
        # the tiny chain at 2 ranks: the same epochs on both ranks, rank 1's
        # save is its wait at the barrier; --test against world 1's
        c0, c1 = ranks[0]["chain"], ranks[1]["chain"]
        for run in ("step 0", "phase 1", "phase 2", "test"):
            for c in (c0, c1):      # main kept the ranks' own group
                if c[run]["group"] != [2, "gloo", "cuda:0"] or \
                        not c[run]["group_left"]:
                    raise AssertionError(f"2-rank {run}: group "
                                         f"{c[run]['group']}")
        for run in ("step 0", "phase 1", "phase 2"):
            e0, e1 = c0[run]["epochs"][0], c1[run]["epochs"][0]
            if {k: v for k, v in e0.items() if not k.startswith(
                    ("epoch_time", "step_"))} != {
                    k: v for k, v in e1.items() if not k.startswith(
                        ("epoch_time", "step_"))}:
                raise AssertionError(f"2-rank chain {run}: the ranks log "
                                     f"different epochs")
            want = {k: v * e0["n_batches"] for k, v in
                    CHAIN_PER_STEP[run].items()}
            if c0[run]["launches"] != want or c1[run]["launches"] != want:
                raise AssertionError(f"2-rank chain {run}: launches "
                                     f"{c0[run]['launches']} / "
                                     f"{c1[run]['launches']}, expected {want}")
            log(f"2-rank tiny chain {run}: loss {e0['loss']:.6f} on both "
                f"ranks; steps ms rank 0 "
                f"{[round(v, 3) for v in c0[run]['steps_ms']]}; save "
                f"{c0[run]['times']['save']:.3f} s on rank 0, barrier wait "
                f"{c1[run]['times']['save']:.3f} s on rank 1; launches per "
                f"rank {c0[run]['launches']}")
        t0, t1 = c0["test"]["val"][0], c1["test"]["val"][0]
        if not (same_results(t0, t1) and same_results(t0, test_a)):
            raise AssertionError(f"--test at 2 ranks {t0} / {t1} differs "
                                 f"from world 1's {test_a}")
        log(f"--test of the lifted checkpoint at 2 ranks (4 + 4 images): "
            f"map {t0['map']:.6f}, equal to world 1's on both ranks; "
            f"launches per rank {c0['test']['launches']} / "
            f"{c1['test']['launches']}")
    launches = {}
    for name in kernels.LAUNCHES:
        launches[name] = {
            "phase 2": [r["phase 2"]["launches"][name] for r in ranks],
            "step 0": [r["step 0"]["launches"][name] for r in ranks]}
        if PER_STEP[name] and min(launches[name]["phase 2"]) < 1 or \
                PER_STEP0[name] and min(launches[name]["step 0"]) < 1:
            raise AssertionError(f"kernel {name} was not launched on a rank")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
        f"{kernels.library_path().name}")

    rs = np.random.RandomState(0)
    t_phases = time.perf_counter()
    res = check_kernels(dev, rs)
    check_launches = dict(kernels.LAUNCHES)
    with tempfile.TemporaryDirectory() as fixture_root, \
            fixture_process(fixture_root) as fixture_result:
        return phases(dev, rs, res, check_launches, fixture_result,
                      t_phases)


def phases(dev, rs, res, check_launches, fixture_result, t_phases) -> int:
    """Phases 3-17, the fixture process running beside them."""
    serve_launches = serve(dev, rs)
    painted(dev, rs)
    painted_factory(dev, rs)
    train_launches = train(dev)
    step0_launches = train_step0(dev)
    phase1_launches = train_phase1(dev)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        chain_launches, trainer, chain_seen = chain(root)
    log(f"chain phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    validate_launches = validate(trainer, rs)
    del trainer
    log(f"validate phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        voc_launches, ckpt_serve_launches = voc_chain(root)
    log(f"real-data chain phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        cv_launches, cv_serve_launches = coco_voc_chain(root)
    log(f"coco-voc chain phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    wrn_step0(dev)
    log(f"WideResNet-38 step-0 remat phase: {time.perf_counter() - t:.1f} s")
    card_vs_cpu()
    t = time.perf_counter()
    ms_launches, ms_rows = multistep(rs)
    log(f"multi-step phase: {time.perf_counter() - t:.1f} s")
    example_launches, example = synthetic_example()
    t = time.perf_counter()
    dist_launches = dist_phase(chain_seen, rs)
    log(f"dist phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    fixture_launches, fixture_line, kit_line = fixture_result()
    fixture_launches["example"] = example_launches
    log(f"fixture-accuracy phase: waited {time.perf_counter() - t:.1f} s for "
        f"its process, which ran {fixture_line['wall_s']} s and the kit "
        f"phase {kit_line['wall_s']} s")
    kit_line["body_tensors_equal_on_card"] = kit_body_on_card(kit_line)
    log(f"all phases passed in {time.perf_counter() - t_phases:.1f} s after "
        f"the kernel build")

    line = []
    for name, r in res.items():
        src, rep = KERNEL_INFO[name]
        if name == "cc_binary":
            path, launches = None, check_launches[name]
        else:
            path, launches = "phase-2 train step", train_launches[name]
            if launches < 1 or (PER_REQUEST[name] and serve_launches[name] < 1
                                ) or (PER_STEP0[name] and
                                      step0_launches[name] < 1):
                raise AssertionError(f"kernel {name} was not launched on its "
                                     f"path")
            if PER_STEP0[name]:
                path += ", step-0 train step"
            path += (", CLI chain (synthetic, VOC and COCO-to-VOC), "
                     "validation, serving from a checkpoint, VOC 10-5 and "
                     "15-1 through step 2, the painted-fixture protocol")
            # every chain launches each kernel in phase 2 and the stamp at
            # step 0; step 0's validation and serving launch the others
            ms_phase2 = [ln[f"step {s} phase 2"][name] for s in (1, 2)
                         for ln in ms_launches.values()]
            if min(ms_phase2) < 1 or any(ln["phase 2"][name] < 1 or (
                    PER_STEP0[name] and ln["step 0"][name] < 1)
                   for ln in (chain_launches, voc_launches, cv_launches,
                              fixture_launches)) or (
                    PER_REQUEST[name] and min(
                        validate_launches[name], ckpt_serve_launches[name],
                        voc_launches["step 0"][name],
                        cv_launches["step 0"][name],
                        cv_serve_launches[name]) < 1):
                raise AssertionError(f"kernel {name} was not launched in "
                                     f"a chain, in validation or in "
                                     f"serving from a checkpoint")
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "path": path, "launches": launches,
                     "launches_serving": serve_launches[name],
                     "launches_step0": step0_launches[name],
                     "launches_phase1": phase1_launches[name],
                     "launches_chain": {run: ln[name] for run, ln in
                                        chain_launches.items()},
                     "launches_validate": validate_launches[name],
                     "launches_chain_voc": {run: ln[name] for run, ln in
                                            voc_launches.items()},
                     "launches_from_checkpoint": ckpt_serve_launches[name],
                     "launches_chain_coco_voc": (
                         {run: ln[name] for run, ln in cv_launches.items()}),
                     "launches_from_checkpoint_coco_voc":
                         cv_serve_launches[name],
                     "launches_dist": dist_launches[name],
                     "launches_chain_10_5": {run: ln[name] for run, ln in
                                             ms_launches["10-5"].items()},
                     "launches_chain_15_1": {run: ln[name] for run, ln in
                                             ms_launches["15-1"].items()},
                     "launches_fixture": {run: ln[name] for run, ln in
                                          fixture_launches.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": "bytes",
                     "library_ms": r["library_ms"],
                     "library_device_ms": r["library_device_ms"],
                     "shape": r["shape"], "serving": r.get("serving"),
                     "cases": r.get("cases"), "step0": r.get("step0"),
                     "connectivity_4": r.get("connectivity_4"),
                     "coco_voc": r.get("coco_voc"),
                     "one_new_class": ms_rows.get(name)})
    log(json.dumps({"fixture": fixture_line | {"example": example}}))
    log(json.dumps({"realdata_kit": kit_line}))
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:       # a process the dist or fixture phase starts
        WORKERS[sys.argv[1]](*sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
