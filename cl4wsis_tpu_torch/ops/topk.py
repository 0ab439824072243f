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

from cl4wsis_tpu_torch.ops import kernels


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


def topk_cuda(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) float32 on the card -> (values, int32 indices), each (B, k)."""
    kernels.require_cuda(x, torch.float32, 2, "topk")
    B, N = x.shape
    lib = kernels.lib()
    seg, max_k = lib.cl4_topk_segment(), lib.cl4_topk_max_k()
    if not 1 <= k <= min(N, max_k):
        raise ValueError(f"topk: need 1 <= k <= min(N, {max_k}), "
                         f"got k={k}, N={N}")
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=x.device)
    n_scratch = B * (-(-N // seg)) * k if N > seg else 1
    scratch = torch.empty((2, n_scratch), dtype=torch.int64, device=x.device)
    err = lib.cl4_topk_f32(kernels.ptr(x), B, N, k, kernels.ptr(vals),
                           kernels.ptr(idx), kernels.ptr(scratch[0]),
                           kernels.ptr(scratch[1]), kernels.stream_of(x))
    kernels.check(err, "topk")
    return vals, idx


def topk_hier(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (values, int32 indices) top-k along the last axis of `x`."""
    if not x.is_cuda:
        return topk_plain(x, k)
    lead = x.shape[:-1]
    vals, idx = topk_cuda(x.reshape(-1, x.shape[-1]).contiguous(), k)
    return vals.reshape(lead + (k,)), idx.reshape(lead + (k,))
