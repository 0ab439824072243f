"""Multi-scale and flip test-time augmentation (counterpart of
``cl4wsis_tpu/models/tta.py``; upstream ``segmentation_module.py:203-235``,
TestAugmentation with mean or sum fusion).

`apply_fn` maps an NCHW image batch to NCHW class logits; the image runs
at each scale, and with `do_flip` beside its horizontal flip in one batch;
every result is resized back to the input's size (the flip undone) and
fused.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from cl4wsis_tpu_torch.ops.resize import resize_bilinear


def test_augmentation(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor,
                      scales: Sequence[float] = (1.0,),
                      do_flip: bool = True,
                      fusion: str = "mean"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, 3, H, W) -> (fused logits (B, C, H, W), their argmax over the
    channels (B, H, W)). A scale s resizes to (round(H s), round(W s))."""
    if fusion not in ("mean", "sum"):
        raise ValueError(f"fusion must be 'mean' or 'sum', not {fusion!r}")
    H, W = x.shape[2:]
    b = x.shape[0]
    total = None
    count = 0
    for scale in scales:
        xs = x if scale == 1.0 else resize_bilinear(
            x, (round(H * scale), round(W * scale)))
        batch = torch.cat([xs, torch.flip(xs, dims=[3])]) if do_flip else xs
        logits = resize_bilinear(apply_fn(batch), (H, W))
        parts = ([logits[:b], torch.flip(logits[b:], dims=[3])] if do_flip
                 else [logits])
        for p in parts:
            total = p if total is None else total + p
            count += 1
    fused = total / count if fusion == "mean" else total
    return fused, fused.argmax(dim=1)
