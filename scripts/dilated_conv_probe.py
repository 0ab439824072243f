#!/usr/bin/env python3
"""Time the DeepLab-v3 head's dilated 3x3 convolutions of the COCO-to-VOC
model (WideResNet-38 at output stride 8: 4096 -> 256 channels, dilation
12, 24 and 32, batch 1) at the feature maps of validation images, on one
card. Each shape and dilation is timed five ways, by CUDA events (mean of
3 calls after one):

  cl        bf16 channels-last, as the port's eval forward runs it
  nchw      bf16 contiguous
  f32       float32 channels-last (TF32 as torch's default leaves it)
  shifted   bf16 channels-last as nine shifted 1x1 convolutions, summed
  cl_bench  bf16 channels-last with torch.backends.cudnn.benchmark

    python3 scripts/dilated_conv_probe.py       # one card

Prints the card's name and power limit, one line per case, then one JSON
line with every time (ms).
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

# feature maps at 1/8 of 512x682, 682x512, 512x768, 768x512 validation
# images, the 704^2 and 768^2 serving buckets, and the 448^2 train crop
SHAPES = ((64, 86), (86, 64), (64, 96), (96, 64), (88, 88), (96, 96),
          (56, 56))
DILATIONS = (12, 24, 32)


def time_ms(fn, n=3):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def shifted(x, w, d):
    """The dilated 3x3 convolution (zero padding d) as nine 1x1 ones over
    shifted windows of the padded input."""
    H, W = x.shape[2:]
    xp = F.pad(x, (d, d, d, d))
    out = 0
    for ky in range(3):
        for kx in range(3):
            out = out + F.conv2d(xp[:, :, ky * d:ky * d + H,
                                    kx * d:kx * d + W],
                                 w[:, :, ky:ky + 1, kx:kx + 1])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("dilated_conv_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = 0.01 * torch.randn(256, 4096, 3, 3, device="cuda", generator=gen)
    w_cl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w_nchw = w.to(torch.bfloat16)
    w_f32 = w.contiguous(memory_format=torch.channels_last)
    rows = []
    for H, W in SHAPES:
        x = torch.randn(1, 4096, H, W, device="cuda", generator=gen)
        x_cl = x.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        x_nchw = x.to(torch.bfloat16)
        x_f32 = x.contiguous(memory_format=torch.channels_last)
        for d in DILATIONS:
            conv = dict(padding=d, dilation=d)
            torch.backends.cudnn.benchmark = False
            r = {"shape": [H, W], "dilation": d,
                 "cl": time_ms(lambda: F.conv2d(x_cl, w_cl, **conv)),
                 "nchw": time_ms(lambda: F.conv2d(x_nchw, w_nchw, **conv)),
                 "f32": time_ms(lambda: F.conv2d(x_f32, w_f32, **conv)),
                 "shifted": time_ms(lambda: shifted(x_cl, w_cl, d))}
            torch.backends.cudnn.benchmark = True
            r["cl_bench"] = time_ms(lambda: F.conv2d(x_cl, w_cl, **conv))
            torch.backends.cudnn.benchmark = False
            rows.append(r)
            print(f"{H}x{W} dilation {d}: " + ", ".join(
                f"{k} {r[k]:.3f} ms" for k in ("cl", "nchw", "f32", "shifted",
                                               "cl_bench")), flush=True)
    print(json.dumps({"dilated_conv_probe": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
