# Frozen plain copy of cl4wsis_tpu_torch/core/abn.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""ABN: batch norm + activation (counterpart of ``cl4wsis_tpu/core/abn.py``).

Eval: ``(x - running_mean) * rsqrt(running_var + eps) * weight + bias`` in
float32 with the output in the input's dtype, then the activation.

Train: the statistics of the batch over (N, H, W), in float32. On one
rank they come from ``F.batch_norm`` in training mode: one fused launch
forward and one backward, where the JAX module's formula (mean and
E[x^2] - mean^2, not Welford) takes ~55 launches a layer; the two differ
by float32 rounding. Over several ranks the batch is the global one,
taken by that formula: the sums of x and x^2 and the count go over ranks
in one all-reduce a layer, whose backward carries the cross-rank terms
(``core/dist.all_sum``). :func:`summed_stats` takes one rank's statistics
so too, to hold the ranks against one process. The running stats move by
flax momentum 0.9 (torch's 0.1), the running var unbiased by n / (n - 1),
n the global count. The weight is used as stored (no abs). Parameter and
buffer names follow torch BN, so a state dict carries the upstream keys.
While a ``--remat`` block is recomputed (``core/remat.recomputing``) the
running stats stay where the forward left them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from . import dist

ACTIVATIONS = ("leaky_relu", "elu", "identity", "relu")
MOMENTUM = 0.9   # flax convention: running = 0.9 * running + 0.1 * batch
def activate(y: torch.Tensor, activation: str, param: float,
             inplace: bool = False) -> torch.Tensor:
    """The norms' activation: leaky-ReLU (slope `param`), ELU (alpha
    `param`), ReLU or identity."""
    if activation == "leaky_relu":
        return F.leaky_relu_(y, param) if inplace else F.leaky_relu(y, param)
    if activation == "elu":
        return F.elu_(y, param) if inplace else F.elu(y, param)
    if activation == "relu":
        return F.relu_(y) if inplace else F.relu(y)
    return y


def batch_stats(xf: torch.Tensor):
    """(mean, biased var, count) per channel of float32 NCHW `xf` over
    (N, H, W) of the global batch: one all-reduce of the sums of x and
    x^2 and of the count."""
    C = xf.shape[1]
    dims = (0, 2, 3)
    sums = dist.all_sum(torch.cat([
        xf.sum(dims), torch.square(xf).sum(dims),
        xf.new_full((1,), xf.numel() // C)]))
    n = sums[-1]
    mean = sums[:C] / n
    return mean, sums[C:2 * C] / n - torch.square(mean), n


def unbiased(var: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """var * n / (n - 1), n / 1 at n = 1."""
    return var * (n / torch.clamp(n - 1, min=1))


def update_running(module: nn.Module, mean: torch.Tensor,
                   var_unbiased: torch.Tensor, momentum: float) -> None:
    """running = momentum * running + (1 - momentum) * batch, for the
    module's running_mean and running_var; skipped while a checkpointed
    block is recomputed."""
    with torch.no_grad():
        module.running_mean.mul_(momentum).add_((1 - momentum) * mean)
        module.running_var.mul_(momentum).add_((1 - momentum) * var_unbiased)


class ABN(nn.Module):

    def __init__(self, features: int, activation: str = "leaky_relu",
                 activation_param: float = 0.01, eps: float = 1e-5):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.activation_param = activation_param
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            # activation in float32, then the input's dtype, as in JAX
            y = activate(self._train_norm(x), self.activation,
                         self.activation_param)
            return y.to(x.dtype)
        # one fused normalisation (float32 arithmetic, output in x's dtype)
        # and one in-place activation: two launches per norm layer
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                         self.bias, False, 0.0, self.eps)
        return activate(y, self.activation, self.activation_param,
                        inplace=True)

    def _train_norm(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not dist.active() and xf.numel() > xf.shape[1]:
            # one rank (and more than one value a channel, which the fused
            # norm needs): the fused batch norm, momentum in torch's sense;
            # momentum 0 while recomputing leaves the running stats as they
            # are and saves what the forward saved
            return F.batch_norm(
                xf, self.running_mean, self.running_var, self.weight,
                self.bias, True, 1.0 - MOMENTUM,
                self.eps)
        mean, var, n = batch_stats(xf)
        update_running(self, mean, unbiased(var, n), MOMENTUM)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean[:, None, None]) * inv[:, None, None] + \
            self.bias[:, None, None]
