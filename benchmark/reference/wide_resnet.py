# Frozen plain copy of cl4wsis_tpu_torch/models/wide_resnet.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""WideResNet-38 A2 backbone with pre-activation identity blocks
(counterpart of ``cl4wsis_tpu/models/wide_resnet.py``), NCHW.

The A2 variant always runs at output stride 8: /2 max-pools before mod2
and mod3, stride 2 at mod4.block1, dilation 2 in mod5 and 4 in mod6 and
mod7; dropout 0.3 in mod6 and 0.5 in mod7, elementwise as the JAX module
draws it, from the generator the caller passes, at the global batch's
shape over several ranks (``models/panoptic.Dropout``).

The low-level features are the pre-activation ``bn1`` outputs of the first
block of mod4..mod7:

  res1 = bn1(mod4.block1 in)  256ch /4      res2 = bn1(mod5...) 512ch /8
  res3 = bn1(mod6...) 1024ch /8             res4 = bn1(mod7...) 2048ch /8
  res5 = bn_out(mod7 out) 4096ch /8

Module names give the upstream keys: ``mod1.conv1`` (no norm),
``mod{i}.block{j}.bn1``, ``mod{i}.block{j}.convs.{conv1,bn2,conv2,bn3,
conv3}``, ``mod{i}.block{j}.proj_conv`` and ``bn_out``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .abn import ABN
from .panoptic import Dropout
from .resnet import _conv

_CHANNELS: Tuple[Tuple[int, ...], ...] = (
    (128, 128), (256, 256), (512, 512), (512, 1024),
    (512, 1024, 2048), (1024, 2048, 4096))
WRN38_STRUCTURE = (3, 3, 6, 3, 1, 1)


class IdentityResidualBlock(nn.Module):
    """bn1 (pre-activation) -> convs, plus the shortcut: the input, or
    proj_conv(bn1(x)) where the stride or the width changes. Two 3x3 convs
    for two channel counts, 1x1 -> 3x3 -> 1x1 for three; the dropout, if
    any, before the last conv. No activation after the sum. Returns (out,
    bn1(x))."""

    def __init__(self, cin: int, channels: Sequence[int], stride: int = 1,
                 dilation: int = 1, dropout: Optional[float] = None,
                 norm: Callable[..., nn.Module] = ABN):
        super().__init__()
        self.bn1 = norm(cin)
        if len(channels) == 2:
            c0, c1 = channels
            layers = [("conv1", _conv(cin, c0, 3, stride, dilation)),
                      ("bn2", norm(c0)),
                      ("conv2", _conv(c0, c1, 3, 1, dilation))]
        else:
            c0, c1, c2 = channels
            layers = [("conv1", _conv(cin, c0, 1, stride)),
                      ("bn2", norm(c0)),
                      ("conv2", _conv(c0, c1, 3, 1, dilation)),
                      ("bn3", norm(c1)),
                      ("conv3", _conv(c1, c2, 1))]
        self.convs = nn.Sequential(OrderedDict(layers))
        self.drop = None if dropout is None else Dropout(dropout)
        if stride != 1 or cin != channels[-1]:
            self.proj_conv = _conv(cin, channels[-1], 1, stride)
        else:
            self.proj_conv = None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        bn1 = self.bn1(x)
        shortcut = x if self.proj_conv is None else self.proj_conv(bn1)
        y = bn1
        *head, last = self.convs
        for layer in head:
            y = layer(y)
        if self.drop is not None:
            y = self.drop(y, generator)
        return last(y) + shortcut, bn1


class WiderResNet38A2(nn.Module):
    """Returns dict(res1..res5) (see the module docstring);
    `feature_channels` gives each one's channels. `structure`: the blocks
    of mod2..mod7. With `remat`, each block's activations are recomputed
    in the backward."""

    def __init__(self, structure: Sequence[int] = WRN38_STRUCTURE,
                 norm: Callable[..., nn.Module] = ABN, remat: bool = False):
        super().__init__()
        if len(structure) != 6:
            raise ValueError(f"structure needs six block counts: {structure}")
        self.remat = remat
        self.mod1 = nn.Sequential(OrderedDict([
            ("conv1", nn.Conv2d(3, 64, 3, padding=1, bias=False))]))
        cin = 64
        self.feature_channels = {}
        for mod_id, num in enumerate(structure):
            if mod_id >= 2:
                self.feature_channels[f"res{mod_id - 1}"] = cin
            blocks = OrderedDict()
            for block_id in range(num):
                dil = 2 if mod_id == 3 else (4 if mod_id > 3 else 1)
                stride = 2 if block_id == 0 and mod_id == 2 else 1
                drop = 0.3 if mod_id == 4 else (0.5 if mod_id == 5 else None)
                blocks[f"block{block_id + 1}"] = IdentityResidualBlock(
                    cin, _CHANNELS[mod_id], stride, dil, drop, norm)
                cin = _CHANNELS[mod_id][-1]
            self.add_module(f"mod{mod_id + 2}", nn.Sequential(blocks))
        self.bn_out = norm(cin)
        self.out_channels = cin
        self.feature_channels["res5"] = cin

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """In train mode the dropout of mod6 and mod7 draws from
        `generator`."""
        y = self.mod1(x)
        outs = {}
        for mod_id in range(6):
            if mod_id < 2:
                y = F.max_pool2d(y, 3, stride=2, padding=1)
            for block_id, block in enumerate(getattr(self, f"mod{mod_id + 2}")):
                def run(inp, block=block):
                    return block(inp, generator)
                y, prev = run(y)
                if mod_id >= 2 and block_id == 0:
                    outs[f"res{mod_id - 1}"] = prev
        outs["res5"] = self.bn_out(y)
        return dict(sorted(outs.items()))


def wider_resnet16_a2(**kw) -> WiderResNet38A2:
    return WiderResNet38A2(structure=(1, 1, 1, 1, 1, 1), **kw)


def wider_resnet20_a2(**kw) -> WiderResNet38A2:
    return WiderResNet38A2(structure=(1, 1, 1, 3, 1, 1), **kw)


def wider_resnet38_a2(**kw) -> WiderResNet38A2:
    return WiderResNet38A2(structure=WRN38_STRUCTURE, **kw)
