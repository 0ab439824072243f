"""Component statistics for slot queries (counterpart of
``cl4wsis_tpu/ops/pseudo_labels.py``; the pseudo-label factory itself comes
with the training path)."""

from __future__ import annotations

from typing import Tuple

import torch

MINIMUM_MASK_SIZE = 20  # modules/utils.py:14 of the upstream code


def component_stats(roots: torch.Tensor, qroots: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact (area, sum_y, sum_x) of each query root's component, int32.

    Same contract as the JAX lane form: a query of the background root or
    beyond (>= H*W) returns zeros. The JAX function compares the (HW, S)
    pairs in fused lanes; eagerly that plane would be materialised, so here
    the per-root sums are integer scatter-adds over the root plane (exact
    and independent of order) read back at the queries.
    """
    H, W = roots.shape
    HW = H * W
    flat = roots.reshape(-1).to(torch.int64)
    idx = torch.arange(HW, dtype=torch.int64, device=roots.device)
    tables = torch.zeros((3, HW + 1), dtype=torch.int64, device=roots.device)
    tables[0].index_add_(0, flat, torch.ones_like(idx))
    tables[1].index_add_(0, flat, idx // W)
    tables[2].index_add_(0, flat, idx % W)
    q = qroots.to(torch.int64)
    hit = (q >= 0) & (q < HW)
    vals = tables[:, torch.where(hit, q, HW)]
    vals = torch.where(hit[None], vals, 0).to(torch.int32)
    return vals[0], vals[1], vals[2]
