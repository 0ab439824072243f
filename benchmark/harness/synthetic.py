"""Synthetic training batches: a frozen copy of the port's
``cl4wsis_tpu_torch/data/synthetic.py`` (numpy only, the same samples from
the same seed; the coordinate grids are made once a size)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def make_sample(rng: np.random.RandomState, size: int, n_classes: int,
                grid, max_objects: int = 4) -> Dict[str, np.ndarray]:
    yy, xx = grid
    img = rng.rand(size, size, 3).astype(np.float32) * 0.2
    seg = np.zeros((size, size), np.int32)
    inst = np.zeros((size, size), np.int32)
    n_obj = rng.randint(1, max_objects + 1)
    l1h = np.zeros((n_classes + 1,), np.float32)
    for k in range(1, n_obj + 1):
        cls = rng.randint(1, n_classes + 1)
        h = rng.randint(size // 8, size // 3)
        w = rng.randint(size // 8, size // 3)
        y = rng.randint(0, size - h)
        x = rng.randint(0, size - w)
        if rng.rand() < 0.5:
            mask = (yy >= y) & (yy < y + h) & (xx >= x) & (xx < x + w)
        else:
            cy, cx = y + h / 2, x + w / 2
            mask = ((yy - cy) / (h / 2)) ** 2 + ((xx - cx) / (w / 2)) ** 2 <= 1.0
        seg[mask] = cls
        inst[mask] = k
        color = np.array([0.3 + 0.7 * (cls % 3 == 0), 0.3 + 0.7 * (cls % 3 == 1),
                          0.3 + 0.7 * (cls % 3 == 2)], np.float32)
        img[mask] = color + rng.randn(3).astype(np.float32) * 0.05
        l1h[cls] = 1.0
    img = (np.clip(img, 0, 1) - IMAGENET_MEAN) / IMAGENET_STD
    return {"image": img, "seg": seg, "inst": inst, "l1h": l1h}


def synthetic_batches(batch_size: int, size: int, n_classes: int, seed: int,
                      n_batches: int) -> List[Dict[str, np.ndarray]]:
    """`n_batches` batches: image (B, S, S, 3) normalised, seg, inst (B, S,
    S) and l1h (B, C + 1)."""
    rng = np.random.RandomState(seed % 2 ** 32)
    grid = np.mgrid[0:size, 0:size]
    out = []
    for _ in range(n_batches):
        samples = [make_sample(rng, size, n_classes, grid)
                   for _ in range(batch_size)]
        out.append({k: np.stack([s[k] for s in samples]) for k in samples[0]})
    return out
