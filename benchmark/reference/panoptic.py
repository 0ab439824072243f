# Frozen plain copy of cl4wsis_tpu_torch/models/panoptic.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Panoptic-DeepLab instance decoder and incremental center/offset head
(counterpart of ``cl4wsis_tpu/models/panoptic.py``), NCHW.

Module names give the upstream keys (``modules/panoptic_deeplab.py`` of the
upstream code): ``aspp.convs.{0-3}.{0,1}``, ``aspp.convs.4.aspp_pooling.1``,
``aspp.project.{0,1}``, ``project.{i}.{0,1}``, ``fuse.{i}.0.0.{0,1}`` /
``.0.1`` / ``.0.2``, and ``classifier.{center,offset}.{fuse,cls}``.
Norms here are BN + ReLU. In train mode the ASPP projection's dropout draws
its mask from the ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from . import dist
from .abn import ABN
from .resize import resize_bilinear


def conv_bn_relu(cin: int, cout: int, kernel: int = 1, dilation: int = 1,
                 groups: int = 1) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, dilation=dilation,
                  padding=dilation * (kernel - 1) // 2, groups=groups,
                  bias=False),
        ABN(cout, activation="relu"))


def depthwise_separable_conv(cin: int, cout: int,
                             kernel: int = 5) -> nn.Sequential:
    """5x5 depthwise conv + BN + ReLU, then 1x1 pointwise + BN + ReLU."""
    return nn.Sequential(
        conv_bn_relu(cin, cin, kernel, groups=cin),
        nn.Conv2d(cin, cout, 1, bias=False),
        ABN(cout, activation="relu"))


class _ASPPPooling(nn.Module):
    """Image pooling branch: global average -> 1x1 conv -> ReLU (no BN)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.aspp_pooling = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(cin, cout, 1, bias=False),
            nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.aspp_pooling(x).expand(-1, -1, *x.shape[2:])


class Dropout(nn.Module):
    """Dropout as flax computes it: keep with probability 1 - p, kept values
    divided by 1 - p; the mask comes from `generator` (torch's default one
    if None), drawn at the global batch's shape, of which this rank keeps
    its rows (``core/dist``). A no-op at eval."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = dist.rows_of(torch.rand(dist.global_shape(x.shape),
                                       generator=generator,
                                       device=x.device)) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


class ASPP(nn.Module):
    """Plain-BN ASPP: 1x1 + three atrous 3x3 + image pooling, projected,
    then dropout 0.5."""

    def __init__(self, cin: int, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (3, 6, 9)):
        super().__init__()
        self.convs = nn.ModuleList(
            [conv_bn_relu(cin, out_channels, 1)] +
            [conv_bn_relu(cin, out_channels, 3, r) for r in atrous_rates] +
            [_ASPPPooling(cin, out_channels)])
        self.project = nn.Sequential(
            nn.Conv2d(out_channels * (len(atrous_rates) + 2), out_channels,
                      1, bias=False),
            ABN(out_channels, activation="relu"))
        self.project_drop = Dropout(0.5)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.project(torch.cat([m(x) for m in self.convs], dim=1))
        return self.project_drop(y, generator)


class PanopticDecoder(nn.Module):
    """Top-down decoder: ASPP(res5), then fuse res4, res3, res2."""

    def __init__(self, in_channels: Dict[str, int],
                 decoder_channels: int = 128, aspp_channels: int = 256,
                 low_level_project: Sequence[int] = (64, 32, 16),
                 atrous_rates: Sequence[int] = (3, 6, 9)):
        super().__init__()
        self.aspp = ASPP(in_channels["res5"], aspp_channels, atrous_rates)
        self.project = nn.ModuleList()
        self.fuse = nn.ModuleList()
        cin = aspp_channels
        for key, proj in zip(("res4", "res3", "res2"), low_level_project):
            self.project.append(conv_bn_relu(in_channels[key], proj, 1))
            self.fuse.append(nn.Sequential(
                depthwise_separable_conv(cin + proj, decoder_channels)))
            cin = decoder_channels

    def forward(self, features: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.aspp(features["res5"], generator)
        for i, key in enumerate(("res4", "res3", "res2")):
            low = self.project[i](features[key])
            x = resize_bilinear(x, low.shape[2:], align_corners=True)
            x = self.fuse[i](torch.cat([x, low], dim=1))
        return x


class _HeadBranch(nn.Module):
    def __init__(self, cin: int, mid: int, outs: Sequence[int]):
        super().__init__()
        self.fuse = nn.Sequential(depthwise_separable_conv(cin, mid))
        self.cls = nn.ModuleList([nn.Conv2d(mid, n, 1) for n in outs])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fuse(x)
        return torch.cat([m(y) for m in self.cls], dim=1)


class IncrementalInstanceHead(nn.Module):
    """Center head with per-step thing-class classifiers (step 0 has no
    background channel) and a 2-channel offset head."""

    def __init__(self, cin: int, center_classes: Sequence[int],
                 center_channels: int = 128, offset_channels: int = 32):
        super().__init__()
        self.classifier = nn.Module()
        self.classifier.center = _HeadBranch(cin, center_channels,
                                             center_classes)
        self.classifier.offset = _HeadBranch(cin, offset_channels, (2,))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"center": self.classifier.center(x),
                "offset": self.classifier.offset(x)}
