"""The numbers that decide ``correct``, and the check that holds each to
its limit.

Training (a step against the reference's, from the same weights, batches
and dropout draws):
  loss_gap    max over the compared steps of |loss - ref| / |ref|;
  grad_gap    the median leaf's | |g| - |g_ref| | / max(|g_ref|, the
              median leaf's |g_ref|), g the first step's gradient as the
              optimizer got it (the worst leaf's is the ASPP pooling
              branch's, a cancellation residual that bfloat16 rounding
              alone moves by up to 4.5x the median leaf: PERF.md);
  change_gap  the worst leaf's gap of the parameters' change over the
              compared steps;
  net_gap     the worst |out - ref| / |ref| over the first step's network
              outputs (soft seg, instance center and offset, CAM, the old
              model's outputs);
  factory_diff  the elements in which the label factory's results differ
              from the plain factory's on the same arguments (exact).
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both (rounding alone moves them under Adam).

Inference:
  out_gap     the worst |out - ref| / |ref| (2-norms) over the model's
              outputs and the sampled images;
  post_diff   the elements in which the program's answer differs from
              the reference's post-processing of the program's own model
              outputs (exact: limit 0).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

DEAD_LEAF = 1e-3


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == b else math.inf)


def loss_gap(losses: Sequence[float], ref: Sequence[float]) -> float:
    if len(losses) != len(ref):
        raise ValueError(f"{len(losses)} losses against {len(ref)}")
    return max(rel_gap(a, b) for a, b in zip(losses, ref))


def live_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient norm is at least DEAD_LEAF of
    the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in ref_grads.items()}
    med = _median(list(norms.values()))
    return [k for k, n in norms.items() if n >= DEAD_LEAF * med]


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> List[float]:
    """| |got| - |ref| | / max(|ref|, median |ref|) of every leaf in
    `leaves`."""
    if set(got) != set(ref):
        raise ValueError(f"leaves differ: {sorted(set(got) ^ set(ref))[:5]}")
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = _median(list(rn.values()))
    gaps = []
    for k in leaves:
        d, den = abs(float(got[k].double().norm()) - rn[k]), max(rn[k], med)
        gaps.append(d / den if den > 0 else (0.0 if d == 0 else math.inf))
    return gaps


def norm_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: Sequence[str]) -> float:
    """The worst leaf's gap (see leaf_gaps)."""
    return max(leaf_gaps(got, ref, leaves))


def median_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves: Sequence[str]) -> float:
    """The median leaf's gap (see leaf_gaps)."""
    return _median(leaf_gaps(got, ref, leaves))


def worst_leaves(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 leaves: Sequence[str], n: int = 4) -> List:
    """The `n` leaves of largest norm gap: [key, elements, |got|, |ref|,
    gap] (a diagnostic, never judged)."""
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = _median(list(rn.values()))
    rows = []
    for k in leaves:
        g = float(got[k].double().norm())
        den = max(rn[k], med)
        rows.append([k, got[k].numel(), g, rn[k],
                     abs(g - rn[k]) / den if den > 0 else 0.0])
    return sorted(rows, key=lambda r: -r[-1])[:n] + [["median", 0, 0.0, med,
                                                      0.0]]


def out_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
            ) -> float:
    """max over the outputs of |got - ref| / |ref|, in float64."""
    return max(float((got[k].double() - ref[k].double()).norm() /
                     ref[k].double().norm().clamp(min=1e-30))
               for k in ref)


def post_diff(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
              ) -> int:
    """Elements that differ between two post-processed answers (a shape
    that differs counts every element)."""
    n = 0
    for k in ref:
        a, b = got[k].cpu(), ref[k].cpu()
        if a.shape != b.shape:
            n += max(a.numel(), b.numel())
        else:
            n += int((a != b).sum())
    return n


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every limit; a reading that is
    missing or not finite counts as infinite."""
    out = {}
    for name, limit in limits.items():
        v = readings.get(name, math.inf)
        if v is None or (isinstance(v, float) and math.isnan(v)):
            v = math.inf
        out[name] = {"value": v, "limit": limit}
    return out


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
