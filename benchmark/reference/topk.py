# Frozen plain copy of cl4wsis_tpu_torch/ops/topk.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Exact top-k along the last axis (counterpart of cl4wsis_tpu/ops/topk.py).

The order is that of ``jax.lax.top_k``: descending, the lower index first
among equal values, and floats in their total order (+0.0 above -0.0, -inf
allowed). ``torch.topk`` documents no tie order, so the port never calls it.

On a CUDA tensor :func:`topk_hier` launches the kernel of ``csrc/topk.cu``
(it raises on what the kernel does not take); on a CPU tensor it runs
:func:`topk_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

from typing import Tuple

import torch



def sortable_int(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is the total order of float32 `x`."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topk_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable descending sort of the sortable keys, first `k` kept."""
    _, idx = torch.sort(sortable_int(x.float()), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def topk_hier(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (values, int32 indices) top-k along the last axis of `x`."""
    return topk_plain(x, k)
