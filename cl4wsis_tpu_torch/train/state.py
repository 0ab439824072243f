"""What the train step carries from one step to the next (counterpart of
``cl4wsis_tpu/train/state.py``): a small dataclass. PyTorch keeps the
parameters and BN statistics in the model and the optimizer state in the
optimizer, so the state is those two objects, the schedule and the step
count. Also the set-up every function that makes a train step shares.

Over several ranks (``core/dist``) a step's loss on a rank is its share of
the global batch's loss, so the gradients are SUMMED over ranks before
the update, not averaged as DDP averages them: :meth:`TrainState.
apply_gradients` does that with one all-reduce of the trainable
gradients. DDP is not used: the steps call the models' ``forward_seg``,
``forward_instance`` and ``forward_features``, whose gradients DDP's
reducer, prepared in ``forward``, would not see."""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from cl4wsis_tpu_torch.core import dist
from cl4wsis_tpu_torch.train.schedule import Schedule, set_lr


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Schedule
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update at the learning rate of the current step
        (gradients already in .grad, summed over ranks here), then the
        next step."""
        dist.sum_grads(p for g in self.optimizer.param_groups
                       for p in g["params"])
        set_lr(self.optimizer, self.lr_schedule, self.step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def prepare(modules: Iterable[torch.nn.Module], device: str, dtype: str):
    """Move `modules` to `device` (channels-last on a card) and return
    (device, memory format, autocast factory). Without a card, asking for
    "cuda" raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train step: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    bf16 = DTYPES[dtype] == torch.bfloat16
    fmt = (torch.channels_last if device.type == "cuda"
           else torch.contiguous_format)
    for m in modules:
        m.to(device=device, memory_format=fmt)

    def autocast():
        return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)
    return device, fmt, autocast
