"""Data-parallel runs over several processes, one card each (counterpart of
``cl4wsis_tpu/core/mesh.py``).

The JAX package shards each batch over a mesh of devices and lets XLA put
in the collectives. The port runs one process per card, as upstream's DDP
does, started by ``torchrun`` with ``CL4WSIS_MULTIHOST=1``; it computes
what the JAX package computes on a mesh over the same global batch:

* ``--batch_size`` is per process. The global batch is the ranks' batches
  in rank order, every rank holding the same number of rows.
* The batch statistics of the norms are sums over ranks (:func:`all_sum`,
  whose backward sums the gradient over ranks as well).
* A step's loss on a rank is its share of the global loss: its own
  numerator over the global denominator. So the shares sum to the global
  loss, and the gradients are summed over ranks (:func:`sum_grads`), not
  averaged. Every metric a step returns is such a share: summed over ranks
  it is the global value.
* A draw with a batch axis is taken at the global batch's shape
  (:func:`global_shape`) from a generator in the same state on every rank,
  and each rank keeps its own rows (:func:`rows_of`).

Every function here is the identity, or does nothing, without a process
group or at world 1.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _group() else 0


def world() -> int:
    return dist.get_world_size() if _group() else 1


def is_main() -> bool:
    return rank() == 0


def active() -> bool:
    """A process group of more than one rank exists."""
    return world() > 1


def init_from_env(device) -> bool:
    """Join the process group that ``torchrun`` describes when
    ``CL4WSIS_MULTIHOST=1``; returns whether this call created it (its
    caller then destroys it with :func:`destroy`).

    For a CUDA `device` the card is ``cuda:$LOCAL_RANK``, made current;
    the backend is NCCL there and gloo on the CPU. A group that exists
    already (one a caller set up, e.g. gloo for several ranks on one card)
    is kept. Without torchrun's variables, or with a ``LOCAL_RANK`` that
    has no card, this raises: it never falls back to one process."""
    if not int(os.environ.get("CL4WSIS_MULTIHOST", "0")):
        return False
    missing = [k for k in TORCHRUN_VARS if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"CL4WSIS_MULTIHOST=1 but {missing} are not set: start the run "
            "with python -m torch.distributed.run --nproc_per_node N")
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        local = int(os.environ["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card: this machine has "
                f"{torch.cuda.device_count()}")
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if _group():
        return False
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return True


def destroy() -> None:
    if _group():
        dist.destroy_process_group()


def local_device(device) -> torch.device:
    """`device` as this rank uses it: a bare "cuda" is the card made
    current by :func:`init_from_env`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and \
            torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def barrier() -> None:
    if active():
        dist.barrier()


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over ranks; the gradient of every rank's input
    is the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over ranks, differentiable."""
    return _SumOverRanks.apply(x) if active() else x


def global_shape(shape) -> tuple:
    """The shape of a draw over the global batch whose rows this rank's
    `shape` holds."""
    return (shape[0] * world(),) + tuple(shape[1:])


def rows_of(t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a leading global batch axis."""
    if not active():
        return t
    if t.shape[0] % world():
        raise ValueError(f"a global batch of {t.shape[0]} rows does not "
                         f"split over {world()} ranks")
    n = t.shape[0] // world()
    return t[rank() * n:(rank() + 1) * n]


def sum_grads(params) -> None:
    """Sum the `.grad` of `params` over ranks in place: one all-reduce of
    one flat float32 buffer. Every rank holds gradients for the same
    parameters, as every rank runs the same graph."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view(g.shape))
        i += g.numel()


def sum_array(a: np.ndarray) -> np.ndarray:
    """A host array summed over ranks, through the card under NCCL and the
    CPU under gloo."""
    if not active():
        return a
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    dist.all_reduce(t)
    return t.cpu().numpy()


def gather_objects(obj) -> List:
    """Every rank's picklable `obj`, in rank order."""
    if not active():
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def check_same(tensors: Dict[str, torch.Tensor], what: str) -> None:
    """Raise unless every rank holds the same bytes in `tensors`: the
    replicas agree because every rank seeds and builds the same, and a
    divergence must show, not be overwritten by a broadcast."""
    if not active():
        return
    h = hashlib.sha256()
    for k, t in tensors.items():
        h.update(k.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    digests = gather_objects(h.hexdigest())
    if len(set(digests)) != 1:
        differ = [r for r, d in enumerate(digests) if d != digests[0]]
        raise RuntimeError(f"{what}: ranks {differ} differ from rank 0")
