# Frozen plain copy of cl4wsis_tpu_torch/models/deeplab.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""DeepLab-v3 ASPP head and the incremental classifier (counterpart of
``cl4wsis_tpu/models/deeplab.py``), NCHW.

Module names give the upstream keys: ``map_convs.{0-3}``, ``map_bn``,
``global_pooling_conv``, ``global_pooling_bn``, ``red_conv``,
``pool_red_conv``, ``red_bn``; the classifier's ``{i}``.

The head's convolutions take upstream's explicit init, xavier-normal with
the leaky-ReLU(0.01) gain, as the JAX head does; the classifier is built
in torch's default family, which the trainer re-draws in flax's unless
``--torch_init`` (``models/flax_init``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .abn import ABN

_XAVIER_LRELU_GAIN = (2.0 / (1.0 + 0.01 ** 2)) ** 0.5  # calculate_gain('leaky_relu', .01)


def _conv(cin: int, cout: int, k: int, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, dilation=dilation,
                     padding=dilation * (k - 1) // 2, bias=False)


class DeepLabV3Head(nn.Module):
    """Four parallel atrous convs plus a pooled branch -> out_channels."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 hidden_channels: int = 256, out_stride: int = 16,
                 pooling_size: Optional[int] = None,
                 norm: Callable[..., nn.Module] = ABN):
        super().__init__()
        self.pooling_size = pooling_size
        dil = [6, 12, 18] if out_stride == 16 else [12, 24, 32]
        self.map_convs = nn.ModuleList(
            [_conv(in_channels, hidden_channels, 1)] +
            [_conv(in_channels, hidden_channels, 3, d) for d in dil])
        self.map_bn = norm(hidden_channels * 4)
        self.global_pooling_conv = _conv(in_channels, hidden_channels, 1)
        self.global_pooling_bn = norm(hidden_channels)
        self.red_conv = _conv(hidden_channels * 4, out_channels, 1)
        self.pool_red_conv = _conv(hidden_channels, out_channels, 1)
        self.red_bn = norm(out_channels)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_normal_(m.weight, _XAVIER_LRELU_GAIN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([m(x) for m in self.map_convs], dim=1)
        out = self.red_conv(self.map_bn(out))
        pool = self.global_pooling_bn(self.global_pooling_conv(self._pool(x)))
        out = out + self.pool_red_conv(pool)
        return self.red_bn(out)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        """Train pooling: the global mean. Eval pooling: a pooling_size
        window average, stride 1, padded back to H x W by edge replication
        with the extra pixel after."""
        if self.training or self.pooling_size is None:
            return x.mean(dim=(2, 3), keepdim=True)
        H, W = x.shape[2:]
        kh, kw = min(self.pooling_size, H), min(self.pooling_size, W)
        pool = F.avg_pool2d(x, (kh, kw), stride=1)
        pt, pb = (kh - 1) // 2, (kh - 1) // 2 + (0 if kh % 2 == 1 else 1)
        pl, pr = (kw - 1) // 2, (kw - 1) // 2 + (0 if kw % 2 == 1 else 1)
        return F.pad(pool, (pl, pr, pt, pb), mode="replicate")


class IncrementalClassifier(nn.ModuleList):
    """Per-step 1x1 classifiers; their outputs are concatenated along the
    channel axis, so old steps' logits depend only on old parameters."""

    def __init__(self, in_channels: int, classes: Sequence[int]):
        super().__init__([nn.Conv2d(in_channels, c, 1) for c in classes])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([m(x) for m in self], dim=1)
