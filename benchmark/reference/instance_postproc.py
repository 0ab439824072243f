# Frozen plain copy of cl4wsis_tpu_torch/ops/instance_postproc.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Eval-time instance extraction (counterpart of
``cl4wsis_tpu/ops/instance_postproc.py::get_ins_map``).

softmax seg argmax -> per-class connected components -> Panoptic-DeepLab
grouping with the offset-cluster extension -> per-instance (label, score)
slots and one (H, W) slot-id map. The score is center_score * seg_score,
and a cluster-spiked center (>= 1) falls back to seg_score. The JAX
function's runtime switches are not ported: this is its default path, the
class-banked assignment and the sorted slot statistics.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import cc
from .grouping import assign_pixels_classbanks
from .refine import (_global_center_slots,
                                          _slot_stats_sorted)


def get_ins_map(seg_prob: torch.Tensor, center_map: torch.Tensor,
                offset_map: torch.Tensor, *, num_classes: int,
                val_thresh: float = 0.1, val_kernel: int = 41,
                beta: float = 3.0, max_ctr: int = 16,
                max_cluster: int = 8) -> Dict[str, torch.Tensor]:
    """One sample.

    Args:
      seg_prob: (H, W, C+1) softmax seg probabilities.
      center_map: (H, W, C) center heatmap.
      offset_map: (H, W, 2) offsets (y, x).

    Returns dict: ins_map (H, W) int32 slot id or -1; label (S,) int32
    0-based thing class; score (S,) float32; valid (S,) bool; truncated ()
    int32, the NMS candidates dropped by the slot cap. S = C*(max_ctr +
    max_cluster).
    """
    C = num_classes
    n_slots = C * (max_ctr + max_cluster)
    seg_map = torch.argmax(seg_prob, dim=-1).to(torch.int32)
    roots = cc.connected_components_multilabel(seg_map, connectivity=8)
    # the slot search is batched and NCHW: one image here
    slots, ch_spiked, truncated = _global_center_slots(
        seg_map[None], roots[None], center_map.permute(2, 0, 1)[None],
        offset_map.permute(2, 0, 1)[None], val_thresh, val_kernel, beta,
        max_ctr, max_cluster, C)
    slots = {k: v[0] for k, v in slots.items()}
    assign = assign_pixels_classbanks(
        slots["ys"], slots["xs"], slots["valid"], slots["root"], offset_map,
        roots, torch.clamp(seg_map - 1, min=0), num_classes=C,
        max_ctr=max_ctr, max_cluster=max_cluster)
    npix, seg_score, vmax, _, _ = _slot_stats_sorted(
        assign, seg_map, ch_spiked[0], seg_prob[..., 1:].permute(2, 0, 1),
        n_slots)

    center_score = vmax[:n_slots]
    seg_score = seg_score[:n_slots]
    slot_ok = slots["valid"] & (npix[:n_slots] > 0)
    center_score = torch.where(slot_ok, center_score, 0.0)
    center_score = torch.where(center_score >= 1.0, seg_score, center_score)
    score = center_score * seg_score
    ins_map = torch.where(assign < n_slots, assign, -1).to(torch.int32)
    return {"ins_map": ins_map, "label": slots["cls"], "score": score,
            "valid": slot_ok, "truncated": truncated[0]}
