"""The collectives of the port's ``core/dist`` (a frozen copy of the parts
the frozen modules call), over torch.distributed's default group; at one
process every one is an identity."""

from __future__ import annotations

import torch
import torch.distributed as tdist


def _group() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if _group() else 0


def world() -> int:
    return tdist.get_world_size() if _group() else 1


def active() -> bool:
    return world() > 1


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over ranks; the gradient of every rank's input
    is the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        tdist.all_reduce(g)
        return g


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over ranks, differentiable."""
    return _SumOverRanks.apply(x) if active() else x


def global_shape(shape) -> tuple:
    return (shape[0] * world(),) + tuple(shape[1:])


def rows_of(t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a leading global batch axis."""
    if not active():
        return t
    n = t.shape[0] // world()
    return t[rank() * n:(rank() + 1) * n]


def sum_grads(params) -> None:
    """Sum the `.grad` of `params` over ranks in place."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    tdist.all_reduce(flat)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view(g.shape))
        i += g.numel()
