"""Bucketed eval forward (counterpart of ``make_eval_forward``,
``pick_bucket`` and ``mask_pad_region`` in ``cl4wsis_tpu/train/eval.py``).

An image at its target size is zero-padded to a square bucket, max(H, W)
rounded up to the bucket multiple; the pad region is masked to pure
background before instance extraction, and the slot-id map is cropped back.
The JAX package pads so that one compiled program serves a bucket; the port
keeps the same padding so that both give the same answers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from cl4wsis_tpu_torch.ops.instance_postproc import get_ins_map
from cl4wsis_tpu_torch.ops.resize import resize_bilinear


def pick_bucket(m: int, multiple: int) -> int:
    """Round up to the next multiple (the bucket size for dimension m)."""
    return -(-m // multiple) * multiple


def mask_pad_region(seg_prob: torch.Tensor, center: torch.Tensor,
                    offset: torch.Tensor, valid_hw: Tuple[int, int]):
    """Force the pad region of (H, W, *) maps to pure background."""
    H, W = seg_prob.shape[:2]
    dev = seg_prob.device
    m = ((torch.arange(H, device=dev)[:, None] < valid_hw[0]) &
         (torch.arange(W, device=dev)[None, :] < valid_hw[1]))[..., None]
    bg = torch.zeros_like(seg_prob)
    bg[..., 0] = 1.0
    return (torch.where(m, seg_prob, bg), center * m, offset * m)


def make_eval_forward(model: torch.nn.Module, num_classes: int, *,
                      device: torch.device, dtype: torch.dtype,
                      val_thresh: float = 0.1, val_kernel: int = 41,
                      beta: float = 3.0, bucket_multiple: Optional[int] = 64,
                      max_ctr: int = 32, max_cluster: int = 8) -> Callable:
    """image (1, H, W, 3) float32 tensor, target_size -> instance slots at
    target_size (see get_ins_map). The model runs under autocast when
    `dtype` is bfloat16; post-processing runs in float32 and int32.
    ``bucket_multiple=None`` takes the exact per-size path. Flip
    test-time augmentation (the JAX ``val_flip``) comes with eval metrics."""
    device = torch.device(device)

    def _apply(image: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = image.permute(0, 3, 1, 2).to(device)
        if device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        with torch.autocast(device.type, dtype=torch.bfloat16,
                            enabled=dtype == torch.bfloat16):
            return model(x, interpolate=False)

    def _postproc(pred, out_hw, valid_hw):
        pred = {k: resize_bilinear(v, out_hw, align_corners=False)[0]
                for k, v in pred.items()}
        seg_prob = torch.softmax(pred["seg"].float(), dim=0)
        seg_prob, center, offset = (
            t.float().permute(1, 2, 0).contiguous()
            for t in (seg_prob, pred["center"], pred["offset"]))
        if valid_hw is not None:
            seg_prob, center, offset = mask_pad_region(seg_prob, center,
                                                       offset, valid_hw)
        return get_ins_map(seg_prob, center, offset, num_classes=num_classes,
                           val_thresh=val_thresh, val_kernel=val_kernel,
                           beta=beta, max_ctr=max_ctr,
                           max_cluster=max_cluster)

    @torch.no_grad()
    def fwd(image: torch.Tensor, target_size: Tuple[int, int]):
        h, w = int(image.shape[1]), int(image.shape[2])
        if bucket_multiple is None or (h, w) != tuple(target_size):
            return _postproc(_apply(image), tuple(target_size), None)
        b = pick_bucket(max(h, w), bucket_multiple)
        padded = image.new_zeros((1, b, b, image.shape[3]))
        padded[:, :h, :w] = image
        out = dict(_postproc(_apply(padded), (b, b), (h, w)))
        out["ins_map"] = out["ins_map"][:h, :w]
        return out

    return fwd
