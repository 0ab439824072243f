"""Painted validation images, drawn on the device from a seed: a dim noise
background and a fixed number of coloured rectangles and ellipses, then
normalised as the port's data pipeline normalises (ImageNet mean and
std). Every image gets the same number of objects, so seeds change the
content and not the amount of work."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def painted_image(h: int, w: int, n_objects: int, gen: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """(1, h, w, 3) float32 normalised image on `device`."""
    img = torch.rand(h, w, 3, generator=gen, device=device) * 0.2
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    for p in torch.rand(n_objects, 8, generator=gen, device=device).tolist():
        oh, ow = (1 / 8 + p[0] * 5 / 24) * h, (1 / 8 + p[1] * 5 / 24) * w
        y0, x0 = p[2] * (h - oh), p[3] * (w - ow)
        if p[4] < 0.5:
            mask = (yy >= y0) & (yy < y0 + oh) & (xx >= x0) & (xx < x0 + ow)
        else:
            cy, cx = y0 + oh / 2, x0 + ow / 2
            mask = ((yy - cy) / (oh / 2)) ** 2 + \
                ((xx - cx) / (ow / 2)) ** 2 <= 1.0
        img[mask] = torch.tensor(p[5:8], device=device) * 0.7 + 0.3
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return ((img.clamp(0, 1) - mean) / std)[None]


def resized_hw(w: int, h: int, short: int):
    """(H, W) after the port's ``data/transforms.Resize(short)``: the short
    side to `short`, the long side int(short * long / short_side)."""
    if w < h:
        return int(short * h / w), short
    return short, int(short * w / h)
