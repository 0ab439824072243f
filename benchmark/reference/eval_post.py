"""The eval forward's post-processing on the exact path (no bucket, no
flip): a frozen copy of ``_postproc`` in the port's ``train/eval.py``
over the plain ``get_ins_map``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .instance_postproc import get_ins_map
from .resize import resize_bilinear


def postproc(pred: Dict[str, torch.Tensor], out_hw: Tuple[int, int],
             num_classes: int, *, val_thresh: float, val_kernel: int,
             beta: float, max_ctr: int, max_cluster: int
             ) -> Dict[str, torch.Tensor]:
    """The model's (1, *, h, w) seg, center and offset -> instance slots at
    `out_hw`."""
    pred = {k: resize_bilinear(v, out_hw, align_corners=False)
            for k, v in pred.items()}
    seg_prob = torch.softmax(pred["seg"].float(), dim=1)[0]
    center = pred["center"].float()[0]
    seg_prob, center, offset = (
        t.float().permute(1, 2, 0).contiguous()
        for t in (seg_prob, center, pred["offset"][0]))
    return get_ins_map(seg_prob, center, offset, num_classes=num_classes,
                       val_thresh=val_thresh, val_kernel=val_kernel,
                       beta=beta, max_ctr=max_ctr, max_cluster=max_cluster)
