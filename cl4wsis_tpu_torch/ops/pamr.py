"""PAMR, pixel-adaptive mask refinement (counterpart of
``cl4wsis_tpu/ops/pamr.py``), NCHW, plain PyTorch.

The affinity of a pixel to each of its 8 neighbours at every dilation is
-|x - shift(x)| over 0.1 x the local standard deviation, averaged over RGB
and softmaxed over all 8 x D shifts; then `num_iter` rounds move the mask
to the affinity-weighted sum of its shifted copies. A shift pads by
replicating the border, as the JAX function's pad + slice does, in the
same neighbour order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from cl4wsis_tpu_torch.ops.resize import resize_bilinear

# (dy, dx) of the 8 neighbours, in the JAX function's order
_OFFSETS: Tuple[Tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def _neighbors(x: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H, W, 8 D): the value at (y + dy d, x + dx d),
    the border replicated."""
    H, W = x.shape[2:]
    outs = []
    for d in dilations:
        xp = F.pad(x, (d, d, d, d), mode="replicate")
        outs += [xp[:, :, d + dy * d:d + dy * d + H, d + dx * d:d + dx * d + W]
                 for dy, dx in _OFFSETS]
    return torch.stack(outs, dim=-1)


def _local_std(x: torch.Tensor, neigh: torch.Tensor,
               n_dil: int) -> torch.Tensor:
    """The unbiased std over all 9 D taps jointly (8 neighbours per
    dilation, and the center once per dilation), (B, C, H, W, 1)."""
    taps = torch.cat([neigh, x[..., None].expand(*x.shape, n_dil)], dim=-1)
    mean = taps.mean(-1, keepdim=True)
    var = torch.square(taps - mean).sum(-1, keepdim=True) / (
        taps.shape[-1] - 1)
    return torch.sqrt(var)


def pamr(image: torch.Tensor, mask: torch.Tensor, num_iter: int = 10,
         dilations: Sequence[int] = (1, 2, 4, 8, 12)) -> torch.Tensor:
    """Refine `mask` (B, C, h, w) probabilities with the affinities of
    `image` (B, 3, H, W) denormalised RGB. The mask is first resized to
    the image's size (align_corners=True). Float32 throughout."""
    mask = resize_bilinear(mask.float(), tuple(image.shape[2:]),
                           align_corners=True)
    image = image.float()
    neigh = _neighbors(image, dilations)                      # B,3,H,W,8D
    x_std = _local_std(image, neigh, len(dilations))
    aff = -torch.abs(neigh - image[..., None]) / (1e-8 + 0.1 * x_std)
    aff = torch.softmax(aff.mean(1), dim=-1)[:, None]         # B,1,H,W,8D
    for _ in range(num_iter):
        mask = (_neighbors(mask, dilations) * aff).sum(-1)
    return mask
