"""Weighted center and offset losses (counterpart of ``weighted_mse`` and
``weighted_l1`` in ``cl4wsis_tpu/train/losses.py``)."""

from __future__ import annotations

import torch


def _weighted(err: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """sum(err * weight) / count(weight > 0), 0 when nothing is weighted.
    `weight` broadcasts over the channels of `err`; the count is of the
    weight's own entries, as upstream normalises."""
    n = (weight > 0).sum().float()
    return torch.where(n > 0, (err * weight).sum() / torch.clamp(n, min=1.0),
                       0.0)


def weighted_mse(out: torch.Tensor, target: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """Center loss: sum(w * (out - target)^2) / count(w > 0), in float32."""
    return _weighted(torch.square(out.float() - target.float()), weight)


def weighted_l1(out: torch.Tensor, target: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """Offset loss: sum(w * |out - target|) / count(w > 0), in float32."""
    return _weighted(torch.abs(out.float() - target.float()), weight)
