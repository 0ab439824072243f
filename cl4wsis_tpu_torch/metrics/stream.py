"""Streaming semantic-segmentation metrics (confusion matrix), a copy of
``cl4wsis_tpu/metrics/stream.py`` (numpy only).

Re-design of reference ``metrics/stream_metrics.py:34-144``: incremental
int64 confusion matrix via bincount; results Overall/Mean Acc, Mean
Precision, Mean IoU, per-class dicts. `synch` is a no-op: the port runs in
one process until multi-GPU runs are ported (ROADMAP queue 1, item 10),
which will sum the matrices across ranks there. ``confusion_figure`` needs
matplotlib and comes with ``utils/visualize`` (item 9).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class StreamSegMetrics:
    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.confusion_matrix = np.zeros((n_classes, n_classes), np.int64)
        self.total_samples = 0

    def update(self, label_trues: np.ndarray, label_preds: np.ndarray):
        for lt, lp in zip(label_trues, label_preds):
            self.confusion_matrix += self._fast_hist(lt.flatten(), lp.flatten())
        self.total_samples += len(label_trues)

    def _fast_hist(self, lt: np.ndarray, lp: np.ndarray) -> np.ndarray:
        mask = (lt >= 0) & (lt < self.n_classes)
        hist = np.bincount(self.n_classes * lt[mask].astype(int) + lp[mask],
                           minlength=self.n_classes ** 2)
        return hist.reshape(self.n_classes, self.n_classes)

    def get_results(self) -> Dict:
        hist = self.confusion_matrix.astype(np.float64)
        gt_sum = hist.sum(axis=1)
        mask = gt_sum != 0
        diag = np.diag(hist)

        # reference semantics (metrics/stream_metrics.py:75-115): EPS-guarded
        # ratios; Mean Acc / Mean IoU averaged over gt-present classes, Mean
        # Precision averaged UNMASKED over ALL classes (a class never
        # predicted contributes ~0).
        EPS = 1e-6
        acc = diag.sum() / hist.sum() if hist.sum() > 0 else 0.0
        acc_cls_c = diag / (gt_sum + EPS)
        acc_cls = np.mean(acc_cls_c[mask]) if mask.any() else 0.0
        precision_cls_c = diag / (hist.sum(axis=0) + EPS)
        precision_cls = np.mean(precision_cls_c)
        iu = diag / (gt_sum + hist.sum(axis=0) - diag + EPS)
        mean_iu = float(np.mean(iu[mask])) if mask.any() else 0.0

        cls_iu = {i: (float(iu[i]) if mask[i] else "X")
                  for i in range(self.n_classes)}
        cls_acc = {i: (float(acc_cls_c[i]) if mask[i] else "X")
                   for i in range(self.n_classes)}
        cls_prec = {i: (float(precision_cls_c[i]) if mask[i] else "X")
                    for i in range(self.n_classes)}
        return {
            "Total samples": self.total_samples,
            "Overall Acc": float(acc),
            "Mean Acc": float(acc_cls),
            "Mean Precision": float(precision_cls),
            "Mean IoU": mean_iu,
            "Class IoU": cls_iu,
            "Class Acc": cls_acc,
            "Class Prec": cls_prec,
            "Agg": [mean_iu, float(acc_cls), float(precision_cls)],
        }

    def synch(self):
        """Sum confusion matrices across ranks: one process, nothing to do."""

    def reset(self):
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes),
                                         np.int64)
        self.total_samples = 0

    def to_str(self, results: Dict) -> str:
        lines = ["Results:"]
        for k, v in results.items():
            if k not in ("Class IoU", "Class Acc", "Class Prec", "Agg"):
                lines.append(f"  {k}: {v}")
        return "\n".join(lines)
