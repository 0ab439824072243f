"""The pseudo-threshold surgery that lets the phase-2 label factory fire on
random weights: a copy of ``choose_pseudo_thresh`` in the repository's
``chip_smoke.py`` (its ``lift=False`` path), run on the reference's
float32 modules so that both sides get the same threshold and weights.

A new class and a threshold between the top two CAM peaks of that class
in at least one image of every batch (the most such images overall); the
newest seg classifier's bias of that class is raised by 10, so that those
images' image-sized component holds exactly one live peak."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference.peaks import peak_extract_nchw, smoothing
from benchmark.reference.resize import resize_bilinear

PG_BIAS_LIFT = 0.5      # a CAM that relu does not zero out
SEG_BIAS_LIFT = 10.0


@torch.no_grad()
def choose_pseudo_thresh(model, pl, pg, batches: List[Dict[str, torch.Tensor]],
                         old: int) -> Tuple[float, int, int]:
    """(threshold, class index in the newest classifier, images hit) for
    the reference modules (already carrying the PeakGenerator's lift)."""
    tops = []
    for batch in batches:
        x = batch["image"].permute(0, 3, 1, 2).contiguous()
        body = model.forward_seg(x, interpolate=False)[1]["body"]
        _, cam = pg(pl(body), label=batch["l1h"])
        cam = resize_bilinear(smoothing(cam.float())[:, old - 1:],
                              tuple(batch["image"].shape[1:3]))
        tops.append(peak_extract_nchw(cam, kernel=15, k=2)[0].cpu().numpy())
    best = None
    for c in range(tops[0].shape[1]):
        for t in ((conf[b, c, 0] + conf[b, c, 1]) / 2
                  for conf in tops for b in range(conf.shape[0])):
            hits = [int(((conf[:, c, 0] > t) & (conf[:, c, 1] < t)).sum())
                    for conf in tops]
            if min(hits) > 0 and (best is None or sum(hits) > best[0]):
                best = (sum(hits), float(t), c)
    if best is None:
        raise RuntimeError(
            "no pseudo threshold lets the factory fire in every batch; "
            "images a batch whose top two CAM peaks differ: " + str(
                [int((conf[:, :, 0] > conf[:, :, 1]).any(1).sum())
                 for conf in tops]))
    n, thresh, c = best
    return thresh, c, n


def lift_pg(state: Dict[str, torch.Tensor]) -> None:
    state["pg.extra_conv4.bias"] += PG_BIAS_LIFT


def lift_seg(state: Dict[str, torch.Tensor], n_steps: int, c: int) -> None:
    state[f"model.cls.{n_steps - 1}.bias"][c] += SEG_BIAS_LIFT
