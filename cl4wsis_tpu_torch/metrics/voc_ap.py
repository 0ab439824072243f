"""VOC/FCIS-protocol instance-segmentation AP (chainercv replacement), a
copy of ``cl4wsis_tpu/metrics/voc_ap.py`` (numpy only). `synch` is a no-op
in one process; the cross-rank merge comes with multi-GPU runs (ROADMAP
queue 1, item 10).

Re-implements ``metrics/voc_evaluation.py`` plus the chainercv helpers it
imports (mask_iou, calc_detection_voc_ap) in numpy — chainercv is not a
dependency here. Matching follows the reference Trainer.eval_detection_voc
(``train.py:653-693``): per class, predictions sorted by score, greedy
argmax-IoU matching, each GT matched at most once.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix between (N, H, W) and (K, H, W) boolean masks."""
    a = a.reshape(a.shape[0], -1).astype(np.float64)
    b = b.reshape(b.shape[0], -1).astype(np.float64)
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def ins_map_iou(ins_map: np.ndarray, slot_ids: np.ndarray,
                gt_masks: np.ndarray) -> np.ndarray:
    """IoU between slot-id-map instances and GT masks without materializing
    prediction masks: (len(slot_ids), len(gt_masks)).

    Histogram formulation: ONE bincount of the map gives every slot area
    and one bincount per GT (over only its own pixels) every intersection
    row — the per-slot equality scans + dict loops this replaces were
    O(n_slots * HW) per image, which drags at COCO scale (5k images x
    up-to-100 slots)."""
    slot_ids = np.asarray(slot_ids)
    n_slots, n_gt = len(slot_ids), len(gt_masks)
    if n_slots == 0 or n_gt == 0:
        return np.zeros((n_slots, n_gt), np.float64)
    flat = ins_map.reshape(-1).astype(np.int64)
    shift = min(int(flat.min()), int(slot_ids.min()), 0)  # bg is -1
    flat -= shift
    sids = slot_ids.astype(np.int64) - shift
    nbins = int(max(flat.max(), sids.max())) + 1
    areas = np.bincount(flat, minlength=nbins)[sids].astype(np.float64)
    g = np.asarray(gt_masks).reshape(n_gt, -1).astype(bool)
    g_areas = g.sum(1).astype(np.float64)
    inter = np.stack(
        [np.bincount(flat[gi], minlength=nbins)[sids] for gi in g],
        axis=1).astype(np.float64)
    union = areas[:, None] + g_areas[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


class InstanceAPAccumulator:
    """Accumulates (n_pos, score, match) per class per IoU threshold
    (``train.py:590-593``)."""

    def __init__(self, iou_thresholds: Sequence[float] | None = None):
        self.thresholds = (list(iou_thresholds) if iou_thresholds is not None
                           else np.arange(0.5, 0.95, 0.05).tolist())
        self.n_pos = [defaultdict(int) for _ in self.thresholds]
        self.score = [defaultdict(list) for _ in self.thresholds]
        self.match = [defaultdict(list) for _ in self.thresholds]

    def add_image(self, gt_label: np.ndarray, gt_mask: np.ndarray,
                  pred_label: np.ndarray, pred_score: np.ndarray,
                  iou: np.ndarray):
        """`iou` is the (n_pred, n_gt) IoU matrix for this image."""
        for idx, thresh in enumerate(self.thresholds):
            self._add(self.n_pos[idx], self.score[idx], self.match[idx],
                      gt_label, gt_mask, pred_label, pred_score, iou, thresh)

    @staticmethod
    def _add(n_pos, score, match, gt_label, gt_mask, pred_label, pred_score,
             iou, thresh):
        for lab in np.unique(np.concatenate([pred_label, gt_label]).astype(int)):
            keep_p = pred_label == lab
            order = pred_score[keep_p].argsort()[::-1]
            iou_l = iou[keep_p][order]
            score_l = pred_score[keep_p][order]
            keep_g = gt_label == lab
            iou_l = iou_l[:, keep_g]

            n_pos[lab] += int(keep_g.sum())
            score[lab].extend(score_l.tolist())
            if keep_p.sum() == 0:
                continue
            if keep_g.sum() == 0:
                match[lab].extend([0] * int(keep_p.sum()))
                continue
            gt_index = iou_l.argmax(axis=1)
            gt_index[iou_l.max(axis=1) < thresh] = -1
            selec = np.zeros(int(keep_g.sum()), bool)
            for gi in gt_index:
                if gi >= 0:
                    match[lab].append(0 if selec[gi] else 1)
                    selec[gi] = True
                else:
                    match[lab].append(0)

    def merge(self, other: "InstanceAPAccumulator") -> None:
        """Fold another accumulator's (n_pos, score, match) into this one —
        order-independent, so shard-and-merge equals sequential accumulation."""
        assert self.thresholds == other.thresholds
        for idx in range(len(self.thresholds)):
            for lab, v in other.n_pos[idx].items():
                self.n_pos[idx][lab] += v
            for lab, v in other.score[idx].items():
                self.score[idx][lab].extend(v)
            for lab, v in other.match[idx].items():
                self.match[idx][lab].extend(v)

    def synch(self) -> None:
        """Merge accumulators across ranks: one process, nothing to do."""

    def results(self, use_07_metric: bool = False) -> Dict[str, np.ndarray]:
        """mAP@[.5:.05:.95] per class + map (``train.py:633-643``)."""
        n_classes = max((max(d.keys(), default=-1) for d in self.n_pos),
                        default=-1) + 1
        ap_all = np.zeros((len(self.thresholds), n_classes))
        for idx in range(len(self.thresholds)):
            prec, rec = _prec_rec(self.n_pos[idx], self.score[idx],
                                  self.match[idx], n_classes)
            ap_all[idx] = _voc_ap(prec, rec, use_07_metric)
        ap = np.nanmean(ap_all, axis=0)
        return {"ap": ap, "map": float(np.nanmean(ap)),
                "ap50": ap_all[0], "map50": float(np.nanmean(ap_all[0]))}


def _prec_rec(n_pos, score, match, n_classes) -> tuple[List, List]:
    """``metrics/voc_evaluation.py:68-140``."""
    prec: List = [None] * n_classes
    rec: List = [None] * n_classes
    for lab in n_pos.keys():
        score_l = np.asarray(score[lab])
        match_l = np.asarray(match[lab], np.int8)
        order = score_l.argsort()[::-1]
        match_l = match_l[order]
        tp = np.cumsum(match_l == 1)
        fp = np.cumsum(match_l == 0)
        prec[lab] = tp / np.maximum(tp + fp, 1e-12)
        rec[lab] = tp / n_pos[lab] if n_pos[lab] > 0 else None
    return prec, rec


def _voc_ap(prec, rec, use_07_metric=False) -> np.ndarray:
    """chainercv calc_detection_voc_ap re-implementation."""
    n_classes = len(prec)
    ap = np.empty(n_classes)
    for lab in range(n_classes):
        if prec[lab] is None or rec[lab] is None:
            ap[lab] = np.nan
            continue
        if use_07_metric:
            ap[lab] = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[lab] >= t) == 0:
                    p = 0.0
                else:
                    p = np.max(np.nan_to_num(prec[lab])[rec[lab] >= t])
                ap[lab] += p / 11
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[lab]), [0]))
            mrec = np.concatenate(([0], rec[lab], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            i = np.where(mrec[1:] != mrec[:-1])[0]
            ap[lab] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap
