# Frozen plain copy of cl4wsis_tpu_torch/train/schedule.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Learning-rate schedules and the grouped optimizer (counterpart of
``cl4wsis_tpu/train/schedule.py``).

The JAX package scales every parameter's update by its group's multiplier
inside one optax chain; here each group with a nonzero multiplier is a
``torch.optim`` param group whose learning rate is multiplier x schedule.
A group with multiplier 0 is frozen: its parameters get
``requires_grad=False`` and sit in no group. That equals optax's x0 for the
parameters that train, since Adam and SGD update every parameter from its
own gradient and state alone; and a frozen parameter's x0 update leaves it
as it was (its gradient is zero, so Adam's update is 0 / (0 + eps) = 0).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

Schedule = Callable[[int], float]


def poly_schedule(base_lr: float, max_iters: int,
                  power: float = 0.9) -> Schedule:
    def fn(step: int) -> float:
        frac = min(max(step / max_iters, 0.0), 1.0)
        return base_lr * (1.0 - frac) ** power
    return fn


def warmup_poly_schedule(base_lr: float, max_iters: int, start_decay: int,
                         power: float = 0.9) -> Schedule:
    """Constant until `start_decay`, then poly of the global step."""
    poly = poly_schedule(base_lr, max_iters, power)
    return lambda step: poly(step) if step >= start_decay else base_lr


def step_schedule(base_lr: float, decay_step: int,
                  decay_factor: float) -> Schedule:
    return lambda step: base_lr * decay_factor ** (step // decay_step)


def make_schedule(policy: str, base_lr: float, max_iters: int,
                  start_decay: int = 0, power: float = 0.9,
                  decay_step: int = 5000,
                  decay_factor: float = 0.1) -> Schedule:
    if policy == "poly":
        return poly_schedule(base_lr, max_iters, power)
    if policy == "warmup":
        return warmup_poly_schedule(base_lr, max_iters, start_decay, power)
    if policy == "step":
        return step_schedule(base_lr, decay_step, decay_factor)
    if policy == "none":
        return lambda step: base_lr
    raise NotImplementedError(policy)


def default_group_fn(name: str) -> str:
    """A parameter's learning-rate group from its state-dict name (the
    upstream keys; the JAX function reads the flax paths)."""
    if name.startswith("body."):
        return "body"
    if name.startswith(("head.", "cls.")):
        return "seg"
    if name.startswith(("decoder.", "instance_head.")):
        return "instance"
    if name.startswith(("pseudolabeler.", "peakgenerator.")):
        return "pseudo"
    return "seg"


def make_optimizer(module: torch.nn.Module, optim: str,
                   weight_decay: float = 0.0,
                   group_scale: Optional[Dict[str, float]] = None,
                   group_fn: Callable[[str], str] = default_group_fn,
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    """SGD (momentum 0.9, Nesterov) or Adam over the groups of `module`'s
    parameters. Each param group carries its multiplier as "scale"; the
    caller sets the learning rates of a step with :func:`set_lr`. Weight
    decay is L2 added to the gradient for both, as torch.optim does."""
    groups: Dict[str, List[torch.nn.Parameter]] = {}
    for name, p in module.named_parameters():
        g = group_fn(name)
        scale = 1.0 if group_scale is None else group_scale[g]
        if scale == 0.0:
            p.requires_grad_(False)
        else:
            groups.setdefault(g, []).append(p)
    scale_of = (lambda g: 1.0) if group_scale is None else group_scale.get
    params = [{"params": ps, "name": g, "scale": scale_of(g), "lr": 0.0}
              for g, ps in groups.items()]
    if optim == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               nesterov=True, weight_decay=weight_decay)
    if optim == "adam":
        return torch.optim.Adam(params, lr=0.0, weight_decay=weight_decay)
    raise NotImplementedError(optim)


def set_lr(optimizer: torch.optim.Optimizer, lr_schedule: Schedule,
           step: int) -> None:
    """Learning rate of every group at `step`: its scale x the schedule."""
    lr = lr_schedule(step)
    for g in optimizer.param_groups:
        g["lr"] = g["scale"] * lr
