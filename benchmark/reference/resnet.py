# Frozen plain copy of cl4wsis_tpu_torch/models/resnet.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""ResNet backbones with dilated output stride (counterpart of
``cl4wsis_tpu/models/resnet.py``), NCHW: bottleneck blocks (ResNet-50,
101, 152) or basic blocks (ResNet-18, 34).

Module names give the upstream state-dict keys:
``mod1.conv1``, ``mod1.bn1``, ``mod{i}.block{j}.convs.{conv,bn}{k}`` and
``mod{i}.block{j}.proj_{conv,bn}``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .abn import ABN


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, dilation=dilation,
                     padding=dilation * (k - 1) // 2, bias=False)


class _Residual(nn.Module):
    """convs(x) + the shortcut (x, or proj_bn(proj_conv(x)) where the
    stride or the width changes), then leaky-ReLU 0.01."""

    def _add_shortcut(self, cin: int, cout: int, stride: int,
                      norm: Callable[..., nn.Module]) -> None:
        if stride != 1 or cin != cout:
            self.proj_conv = _conv(cin, cout, 1, stride)
            self.proj_bn = norm(cout, activation="identity")
        else:
            self.proj_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convs(x)
        sc = x if self.proj_conv is None else self.proj_bn(self.proj_conv(x))
        return F.leaky_relu(y + sc, 0.01)


class Bottleneck(_Residual):
    """1x1 -> 3x3 (stride, dilation) -> 1x1, each followed by a norm (the
    last with identity activation)."""

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
        self._add_shortcut(cin, c2, stride, norm)


class BasicBlock(_Residual):
    """3x3 (stride, dilation) -> 3x3 (dilation), each followed by a norm
    (the second with identity activation)."""

    def __init__(self, cin: int, channels: Sequence[int], stride: int = 1,
                 dilation: int = 1, norm: Callable[..., nn.Module] = ABN):
        super().__init__()
        c0, c1 = channels
        self.convs = nn.Sequential(OrderedDict([
            ("conv1", _conv(cin, c0, 3, stride, dilation)),
            ("bn1", norm(c0)),
            ("conv2", _conv(c0, c1, 3, 1, dilation)),
            ("bn2", norm(c1, activation="identity")),
        ]))
        self._add_shortcut(cin, c1, stride, norm)


class ResNet(nn.Module):
    """ResNet body returning dict(res1..res5); `feature_channels` gives
    each one's channels. With `remat`, each block's activations are
    recomputed in the backward."""

    def __init__(self, structure: Sequence[int] = (3, 4, 23, 3),
                 output_stride: int = 16,
                 norm: Callable[..., nn.Module] = ABN,
                 bottleneck: bool = True, remat: bool = False):
        super().__init__()
        if output_stride == 16:
            dilation = [1, 1, 1, 2]
        elif output_stride == 8:
            dilation = [1, 1, 2, 4]
        else:
            raise ValueError("output_stride must be 8 or 16")
        if len(structure) != 4:
            raise ValueError(f"structure needs four block counts: {structure}")
        self.remat = remat
        self.mod1 = nn.Sequential(OrderedDict([
            ("conv1", nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)),
            ("bn1", norm(64)),
        ]))
        channels = [64, 64, 256] if bottleneck else [64, 64]
        block_cls = Bottleneck if bottleneck else BasicBlock
        cin = 64
        self.feature_channels = {"res1": cin}
        for mod_id, num in enumerate(structure):
            d = dilation[mod_id]
            blocks = OrderedDict()
            for block_id in range(num):
                stride = 2 if d == 1 and block_id == 0 and mod_id > 0 else 1
                blocks[f"block{block_id + 1}"] = block_cls(
                    cin, channels, stride, d, norm)
                cin = channels[-1]
            self.add_module(f"mod{mod_id + 2}", nn.Sequential(blocks))
            self.feature_channels[f"res{mod_id + 2}"] = cin
            channels = [c * 2 for c in channels]
        self.out_channels = cin

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """`generator` is accepted for the bodies' common signature: no
        ResNet layer draws."""
        y = self.mod1(x)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outs = {"res1": y}
        for i in range(2, 6):
            for block in getattr(self, f"mod{i}"):
                y = block(y)
            outs[f"res{i}"] = y
        return outs
