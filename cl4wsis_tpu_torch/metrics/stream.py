"""Streaming semantic-segmentation metrics (confusion matrix), a copy of
``cl4wsis_tpu/metrics/stream.py`` (numpy only).

Re-design of reference ``metrics/stream_metrics.py:34-144``: incremental
int64 confusion matrix via bincount; results Overall/Mean Acc, Mean
Precision, Mean IoU, per-class dicts. In a run over several ranks each
evaluates its strided shard of the validation set and `synch` sums the
matrices and sample counts over ranks (``core/dist.sum_array``: int64 on
the CPU under gloo, on the card under NCCL). ``confusion_figure``
imports matplotlib when it is called.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from cl4wsis_tpu_torch.core import dist


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
        """Sum the confusion matrices and sample counts over ranks (in one
        all-reduce); every rank then holds the global ones."""
        n = self.n_classes
        flat = dist.sum_array(np.append(self.confusion_matrix.reshape(-1),
                                        np.int64(self.total_samples)))
        self.confusion_matrix = flat[:-1].reshape(n, n)
        self.total_samples = int(flat[-1])

    def reset(self):
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes),
                                         np.int64)
        self.total_samples = 0

    def confusion_figure(self):
        """Matplotlib figure of the row-normalised confusion matrix
        (upstream ``metrics/stream_metrics.py:133-144``)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        cm = self.confusion_matrix.astype(np.float64)
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
        im = ax.imshow(cm, cmap=plt.get_cmap("Blues"))
        fig.colorbar(im)
        ax.set_xlabel("prediction")
        ax.set_ylabel("ground truth")
        return fig

    def to_str(self, results: Dict) -> str:
        lines = ["Results:"]
        for k, v in results.items():
            if k not in ("Class IoU", "Class Acc", "Class Prec", "Agg"):
                lines.append(f"  {k}: {v}")
        return "\n".join(lines)
