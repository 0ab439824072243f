"""ABN: batch norm + activation (counterpart of ``cl4wsis_tpu/core/abn.py``).

Eval: ``(x - running_mean) * rsqrt(running_var + eps) * weight + bias`` in
float32 with the output in the input's dtype, then the activation.

Train: the statistics of the batch over (N, H, W), in float32, as the JAX
module takes them: mean and E[x^2] - mean^2 (not Welford). The running
stats move by flax momentum 0.9 (torch's 0.1), the running var unbiased by
n / (n - 1). The weight is used as stored (no abs). Parameter and buffer
names follow torch BN, so a state dict carries the upstream keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = ("leaky_relu", "identity", "relu")
MOMENTUM = 0.9   # flax convention: running = 0.9 * running + 0.1 * batch


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
            y = self._activate(self._train_norm(x), inplace=False)
            return y.to(x.dtype)
        # one fused normalisation (float32 arithmetic, output in x's dtype)
        # and one in-place activation: two launches per norm layer
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                         self.bias, False, 0.0, self.eps)
        return self._activate(y, inplace=True)

    def _train_norm(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        dims = (0, 2, 3)
        mean = xf.mean(dim=dims)
        var = torch.square(xf).mean(dim=dims) - torch.square(mean)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_((1 - MOMENTUM) * mean)
            self.running_var.mul_(MOMENTUM).add_(
                (1 - MOMENTUM) * (var * (n / max(n - 1, 1))))
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean[:, None, None]) * inv[:, None, None] + \
            self.bias[:, None, None]

    def _activate(self, y: torch.Tensor, inplace: bool) -> torch.Tensor:
        if self.activation == "leaky_relu":
            return (F.leaky_relu_(y, self.activation_param) if inplace
                    else F.leaky_relu(y, self.activation_param))
        if self.activation == "relu":
            return F.relu_(y) if inplace else F.relu(y)
        return y
