"""Validation (counterpart of ``cl4wsis_tpu/train/eval.py``): the bucketed
eval forward, instance mAP and semantic mIoU.

An image at its target size is zero-padded to a square bucket, max(H, W)
rounded up to the bucket multiple; the pad region is masked to pure
background before instance extraction, and the slot-id map is cropped back.
The JAX package pads so that one compiled program serves a bucket; the port
keeps the same padding so that both give the same answers. The per-image
post-processing runs on the device and only the slot arrays cross to the
host; matching and AP run in numpy (``metrics/voc_ap.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from cl4wsis_tpu_torch.metrics.stream import StreamSegMetrics
from cl4wsis_tpu_torch.metrics.voc_ap import InstanceAPAccumulator, ins_map_iou
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
                      val_flip: bool = False, val_thresh: float = 0.1,
                      val_kernel: int = 41, beta: float = 3.0,
                      bucket_multiple: Optional[int] = 64,
                      max_ctr: int = 32, max_cluster: int = 8) -> Callable:
    """image (1, H, W, 3) float32 tensor, target_size -> instance slots at
    target_size (see get_ins_map). Every call puts the model in eval mode
    (the JAX forward's ``train=False``). The model runs under autocast when
    `dtype` is bfloat16; post-processing runs in float32 and int32.
    With `val_flip` the image and its W-flip run as one batch of 2, and the
    seg probabilities and centers are averaged with the flip undone.
    ``bucket_multiple=None`` takes the exact per-size path."""
    device = torch.device(device)

    def _apply(image: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = image.permute(0, 3, 1, 2).to(device)
        if val_flip:
            x = torch.cat([x, torch.flip(x, dims=[3])])
        if device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        with torch.autocast(device.type, dtype=torch.bfloat16,
                            enabled=dtype == torch.bfloat16):
            return model(x, interpolate=False)

    def _postproc(pred, out_hw, valid_hw):
        pred = {k: resize_bilinear(v, out_hw, align_corners=False)
                for k, v in pred.items()}
        seg_prob = torch.softmax(pred["seg"].float(), dim=1)
        center = pred["center"].float()
        if val_flip:    # (C, H, W): the flip undone along W
            seg_prob = (seg_prob[0] + torch.flip(seg_prob[1], dims=[2])) / 2.0
            center = (center[0] + torch.flip(center[1], dims=[2])) / 2.0
        else:
            seg_prob, center = seg_prob[0], center[0]
        seg_prob, center, offset = (
            t.float().permute(1, 2, 0).contiguous()
            for t in (seg_prob, center, pred["offset"][0]))
        if valid_hw is not None:
            seg_prob, center, offset = mask_pad_region(seg_prob, center,
                                                       offset, valid_hw)
        return get_ins_map(seg_prob, center, offset, num_classes=num_classes,
                           val_thresh=val_thresh, val_kernel=val_kernel,
                           beta=beta, max_ctr=max_ctr,
                           max_cluster=max_cluster)

    @torch.no_grad()
    def fwd(image: torch.Tensor, target_size: Tuple[int, int]):
        model.eval()
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


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def validate_instances(forward: Callable,
                       samples: Iterable[Dict[str, np.ndarray]]) -> Dict:
    """samples yield dicts: image (1, H, W, 3), gt_masks (K, H, W) bool,
    gt_labels (K,) 0-based thing classes. Returns the AP results dict and
    "truncated_centers", the NMS candidates the slot cap dropped."""
    acc = InstanceAPAccumulator()
    truncated = 0
    for s in samples:
        target_size = s["gt_masks"].shape[1:]
        out = forward(torch.as_tensor(np.asarray(s["image"], np.float32)),
                      target_size)
        ins_map = _numpy(out["ins_map"])
        truncated += int(out.get("truncated", 0))
        valid = _numpy(out["valid"])
        labels = _numpy(out["label"])[valid]
        scores = _numpy(out["score"])[valid]
        slot_ids = np.nonzero(valid)[0]
        if len(slot_ids) == 0:
            labels = np.array([0])
            scores = np.array([0.0])
            iou = np.zeros((1, len(s["gt_masks"])))
        else:
            iou = ins_map_iou(ins_map, slot_ids, s["gt_masks"])
        acc.add_image(s["gt_labels"], s["gt_masks"], labels, scores, iou)
    acc.synch()
    res = acc.results()
    res["truncated_centers"] = truncated
    return res


def validate_semseg(classify: Callable,
                    samples: Iterable[Dict[str, np.ndarray]],
                    n_classes: int,
                    old_classes: Optional[int] = None) -> Dict:
    """classify: image (B, H, W, 3) tensor -> class probabilities (B, H, W,
    C), whose argmax is taken where they lie (on the device for a tensor
    there). When `old_classes` is given (phase-1 CAM eval), ground-truth
    labels below it are zeroed."""
    metrics = StreamSegMetrics(n_classes)
    for s in samples:
        probs = classify(torch.as_tensor(np.asarray(s["image"], np.float32)))
        pred = _numpy(probs.argmax(-1))
        labels = np.asarray(s["seg"]).copy()
        if labels.ndim == pred.ndim - 1:
            labels = labels[None]
        if old_classes is not None:
            labels[labels < old_classes] = 0
        metrics.update(labels, pred)
    metrics.synch()
    return metrics.get_results()
