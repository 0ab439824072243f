"""Max pooling for NMS (counterpart of ``cl4wsis_tpu/ops/peaks.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_same(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Max pool, stride 1, same padding with -inf, over NHWC `x` (the
    layout of the JAX function). The kernel must be odd.

    Separable, as in the JAX function: a (k, 1) pass then a (1, k) pass
    read 2k values per output instead of k^2 (1681 at the NMS kernel 41),
    with the same result, since a max can be taken in any order."""
    if kernel % 2 == 0:
        raise ValueError(f"max_pool_same needs an odd kernel, got {kernel}")
    pad = kernel // 2
    y = F.max_pool2d(x.permute(0, 3, 1, 2), (kernel, 1), stride=1,
                     padding=(pad, 0))
    y = F.max_pool2d(y, (1, kernel), stride=1, padding=(0, pad))
    return y.permute(0, 2, 3, 1)
