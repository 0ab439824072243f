"""ABN: batch norm + activation, eval mode (counterpart of
``cl4wsis_tpu/core/abn.py``).

``(x - running_mean) * rsqrt(running_var + eps) * weight + bias`` in
float32 with the output in the input's dtype, then the activation. The weight is
used as stored (no abs). Parameter and buffer names follow torch BN, so a
state dict carries the upstream keys. Train-mode statistics come with the
training path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = ("leaky_relu", "identity", "relu")


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
            raise NotImplementedError("ABN is ported for eval mode only")
        # one fused normalisation (float32 arithmetic, output in x's dtype)
        # and one in-place activation: two launches per norm layer
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                         self.bias, False, 0.0, self.eps)
        if self.activation == "leaky_relu":
            y = F.leaky_relu_(y, self.activation_param)
        elif self.activation == "relu":
            y = F.relu_(y)
        return y
