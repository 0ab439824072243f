"""Weak-supervision modules: PseudoLabeler, PAM, nGWP and PeakGenerator
(counterpart of ``cl4wsis_tpu/wss/modules.py``), NCHW.

Module names give the JAX module's parameter names, so
``cl/ckpt.convert_jax_variables`` carries their variables across.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cl4wsis_tpu_torch.core.abn import ABN
from cl4wsis_tpu_torch.ops.resize import resize_bilinear


class PseudoLabeler(nn.Module):
    """2x (3x3 conv + ABN) + 1x1 classifier over backbone body features."""

    def __init__(self, num_classes: int, in_channels: int = 2048,
                 hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, hidden, 3, padding=1, bias=False)
        self.norm1 = ABN(hidden)
        self.conv2 = nn.Conv2d(hidden, hidden, 3, padding=1, bias=False)
        self.norm2 = ABN(hidden)
        self.cls = nn.Conv2d(hidden, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(self.conv1(x))
        return self.cls(self.norm2(self.conv2(y)))


def pam(x: torch.Tensor, alpha: float = 0.7) -> torch.Tensor:
    """Peak-attention masking: zero activations below alpha * channel max."""
    x = F.relu(x)
    peak = torch.amax(x, dim=(2, 3), keepdim=True)
    return torch.where(x < peak * alpha, 0.0, x)


def ngwp(x: torch.Tensor) -> torch.Tensor:
    """Normalised global weighted pooling logits, (B, C, H, W) -> (B, C)."""
    B, C = x.shape[:2]
    xf = x.float().reshape(B, C, -1)
    masks = torch.softmax(xf, dim=1)
    return (xf * masks).sum(-1) / (1.0 + masks.sum(-1))


class PeakGenerator(nn.Module):
    """PAM + 1x1 conv on the new-class CAM channels; nGWP image logits.

    num_classes: all thing classes (tot - 1); old_classes: old thing
    classes (old - 1). Logits and maps are zero-padded over the old
    channels. In train mode it returns (logits, map); in eval mode (logits,
    cam), the label-masked CAM resized to `size` (align_corners=False) and
    divided by its spatial max.
    """

    def __init__(self, num_classes: int, old_classes: int,
                 alpha: float = 0.7):
        super().__init__()
        self.num_classes = num_classes
        self.old_classes = old_classes
        self.alpha = alpha
        new = num_classes - old_classes
        self.extra_conv4 = nn.Conv2d(new, new, 1)
        # upstream's explicit init, as the JAX module's
        nn.init.normal_(self.extra_conv4.weight, 0.0, (2.0 / new) ** 0.5)
        nn.init.zeros_(self.extra_conv4.bias)

    def forward(self, x: torch.Tensor, label: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        new = self.num_classes - self.old_classes
        y = self.extra_conv4(pam(x[:, -new:], self.alpha))
        logit = ngwp(y)
        if self.old_classes > 0:
            logit = F.pad(logit, (self.old_classes, 0))
            y = F.pad(y, (0, 0, 0, 0, self.old_classes, 0))
        if self.training:
            return logit, y
        return logit, self._cam_normalize(y.detach(), size or y.shape[2:],
                                          label)

    @staticmethod
    def _cam_normalize(cam: torch.Tensor, size,
                       label: Optional[torch.Tensor]) -> torch.Tensor:
        cam = F.relu(cam)
        if label is not None:
            cam = cam * label[:, :, None, None]
        cam = resize_bilinear(cam, tuple(size), align_corners=False)
        return cam / (torch.amax(cam, dim=(2, 3), keepdim=True) + 1e-5)
