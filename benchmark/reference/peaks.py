# Frozen plain copy of cl4wsis_tpu_torch/ops/peaks.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Pooling and peak extraction (counterpart of ``cl4wsis_tpu/ops/peaks.py``),
over the port's NCHW maps (the JAX functions take NHWC)."""

from __future__ import annotations

from functools import partial
from typing import Tuple

import torch
import torch.nn.functional as F

from . import topk


def max_pool_same(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Max pool, stride 1, same padding with -inf, over NCHW `x`. The
    kernel must be odd.

    Separable, as in the JAX function: a (k, 1) pass then a (1, k) pass
    read 2k values per output instead of k^2 (1681 at the NMS kernel 41),
    with the same result, since a max can be taken in any order."""
    if kernel % 2 == 0:
        raise ValueError(f"max_pool_same needs an odd kernel, got {kernel}")
    pad = kernel // 2
    y = F.max_pool2d(x, (kernel, 1), stride=1, padding=(pad, 0))
    return F.max_pool2d(y, (1, kernel), stride=1, padding=(0, pad))


def avg_pool_same(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Average pool, stride 1, zero padding, over NCHW `x`; borders divide
    by kernel^2 too (torch's count_include_pad, as the JAX function)."""
    return F.avg_pool2d(x, kernel, stride=1, padding=(kernel - 1) // 2,
                        count_include_pad=True)


smoothing = partial(avg_pool_same, kernel=3)


def peak_extract_nchw(heat: torch.Tensor, kernel: int = 5, k: int = 25
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Max-pool NMS, then the top `k` survivors of every (B, C) plane.
    heat: (B, C, H, W). Returns (scores float32, ys int32, xs int32), each
    (B, C, k); top-k runs once over the B*C rows."""
    B, C, H, W = heat.shape
    keep = (max_pool_same(heat, kernel) == heat).to(heat.dtype)
    scores, inds = topk.topk_hier((heat * keep).reshape(B, C, H * W), k)
    return scores.float(), inds // W, inds % W
