# Frozen plain copy of cl4wsis_tpu_torch/ops/resize.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Bilinear resize with explicit align_corners (counterpart of
``cl4wsis_tpu/ops/resize.py::resize_bilinear_nchw``).

Separable two-tap interpolation with the JAX package's sampling: with
align_corners=False the source coordinate is clipped to [0, in - 1], so a
border output that samples past the last row reads that row exactly.
(``F.interpolate`` blends the last row with itself there, which is off by
an ulp; NMS compares heatmap values for equality, so the port cannot use
it.) The resize runs in float32 and returns the input's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _axis_taps(in_size: int, out_size: int, align_corners: bool,
               device: torch.device):
    if align_corners and out_size > 1:
        src = torch.linspace(0.0, in_size - 1.0, out_size, device=device)
    elif align_corners:
        src = torch.zeros(out_size, device=device)
    else:
        src = ((torch.arange(out_size, dtype=torch.float32, device=device)
                + 0.5) * (in_size / out_size) - 0.5)
        src = torch.clamp(src, 0.0, in_size - 1.0)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    return lo, hi, src - lo


def _resize_axis(x: torch.Tensor, dim: int, out_size: int,
                 align_corners: bool) -> torch.Tensor:
    lo, hi, w = _axis_taps(x.shape[dim], out_size, align_corners, x.device)
    shape = [1] * x.dim()
    shape[dim] = out_size
    w = w.view(shape)
    return (torch.index_select(x, dim, lo) * (1.0 - w) +
            torch.index_select(x, dim, hi) * w)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Resize NCHW `x` to spatial `size`."""
    H, W = x.shape[-2:]
    h, w = size
    if (H, W) == (h, w):
        return x
    out = x.float()
    if h != H:
        out = _resize_axis(out, -2, h, align_corners)
    if w != W:
        out = _resize_axis(out, -1, w, align_corners)
    return out.to(x.dtype)
