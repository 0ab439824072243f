"""What the train step carries from one step to the next (counterpart of
``cl4wsis_tpu/train/state.py``): a small dataclass. PyTorch keeps the
parameters and BN statistics in the model and the optimizer state in the
optimizer, so the state is those two objects, the schedule and the step
count."""

from __future__ import annotations

import dataclasses

import torch

from cl4wsis_tpu_torch.train.schedule import Schedule, set_lr


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Schedule
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update at the learning rate of the current step
        (gradients already in .grad), then the next step."""
        set_lr(self.optimizer, self.lr_schedule, self.step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
