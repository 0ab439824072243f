"""Bottleneck ResNet backbones with dilated output stride (counterpart of
``cl4wsis_tpu/models/resnet.py``), NCHW.

Module names give the upstream state-dict keys:
``mod1.conv1``, ``mod1.bn1``, ``mod{i}.block{j}.convs.{conv,bn}{k}`` and
``mod{i}.block{j}.proj_{conv,bn}``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cl4wsis_tpu_torch.core.abn import ABN


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, dilation=dilation,
                     padding=dilation * (k - 1) // 2, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1, each followed by an ABN (the
    last with identity activation); residual add, then leaky-ReLU 0.01."""

    def __init__(self, cin: int, channels: Sequence[int], stride: int = 1,
                 dilation: int = 1, norm: Callable[..., nn.Module] = ABN):
        super().__init__()
        c0, c1, c2 = channels
        self.convs = nn.Sequential(OrderedDict([
            ("conv1", _conv(cin, c0, 1)),
            ("bn1", norm(c0)),
            ("conv2", _conv(c0, c1, 3, stride, dilation)),
            ("bn2", norm(c1)),
            ("conv3", _conv(c1, c2, 1)),
            ("bn3", norm(c2, activation="identity")),
        ]))
        if stride != 1 or cin != c2:
            self.proj_conv = _conv(cin, c2, 1, stride)
            self.proj_bn = norm(c2, activation="identity")
        else:
            self.proj_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convs(x)
        sc = x if self.proj_conv is None else self.proj_bn(self.proj_conv(x))
        return F.leaky_relu(y + sc, 0.01)


class ResNet(nn.Module):
    """ResNet body returning dict(res1..res5)."""

    def __init__(self, structure: Sequence[int] = (3, 4, 23, 3),
                 output_stride: int = 16,
                 norm: Callable[..., nn.Module] = ABN):
        super().__init__()
        if output_stride == 16:
            dilation = [1, 1, 1, 2]
        elif output_stride == 8:
            dilation = [1, 1, 2, 4]
        else:
            raise ValueError("output_stride must be 8 or 16")
        self.mod1 = nn.Sequential(OrderedDict([
            ("conv1", nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)),
            ("bn1", norm(64)),
        ]))
        channels = [64, 64, 256]
        cin = 64
        for mod_id, num in enumerate(structure):
            d = dilation[mod_id]
            blocks = OrderedDict()
            for block_id in range(num):
                stride = 2 if d == 1 and block_id == 0 and mod_id > 0 else 1
                blocks[f"block{block_id + 1}"] = Bottleneck(
                    cin, channels, stride, d, norm)
                cin = channels[-1]
            self.add_module(f"mod{mod_id + 2}", nn.Sequential(blocks))
            channels = [c * 2 for c in channels]
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = self.mod1(x)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outs = {"res1": y}
        for i in range(2, 6):
            y = getattr(self, f"mod{i}")(y)
            outs[f"res{i}"] = y
        return outs
