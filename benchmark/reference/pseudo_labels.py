# Frozen plain copy of cl4wsis_tpu_torch/ops/pseudo_labels.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Phase-2 pseudo labels from class components and CAM peaks (counterpart of
``cl4wsis_tpu/ops/pseudo_labels.py``), batched.

The JAX functions label one image and the train step runs them under
``vmap``; here every function takes a leading batch axis B, so the
connected components of the whole batch are one kernel launch. A component
of a new class is accepted iff it holds exactly one live CAM peak of its
class and at least MINIMUM_MASK_SIZE pixels; accepted components get
offsets to their integer centroid, weight 1, and a gaussian slot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import cc

MINIMUM_MASK_SIZE = 20  # modules/utils.py:14 of the upstream code
MAXIMUM_NUM_INST = 5    # modules/utils.py:15 of the upstream code


class Components(NamedTuple):
    """The factory's shared component pass, on the peak axis S = NC * K
    (NC active classes, K peaks each) as in the JAX function."""
    eff: torch.Tensor       # (B, H, W) int32 class map (0 = bg / inactive)
    roots: torch.Tensor     # (B, H, W) int32 component root (HW = bg)
    proot: torch.Tensor     # (B, S) int32 component root per peak (HW: none)
    accept_p: torch.Tensor  # (B, S) bool 1-peak-1-component acceptance
    cy_p: torch.Tensor      # (B, S) float32 component centroid y per peak
    cx_p: torch.Tensor      # (B, S) float32 component centroid x per peak
    pcls: torch.Tensor      # (S,) int64 0-based class id per peak


def component_stats(roots: torch.Tensor, qroots: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact (area, sum_y, sum_x) of each query root's component, int32.

    roots: (..., H, W); qroots: (..., S) with the same leading axes. Same
    contract as the JAX lane form: a query of the background root or beyond
    (>= H*W) returns zeros. The JAX function compares the (HW, S) pairs in
    fused lanes; eagerly that plane would be materialised, so here the
    per-root sums are integer scatter-adds over the root plane (exact and
    independent of order) read back at the queries.
    """
    H, W = roots.shape[-2:]
    HW = H * W
    lead = qroots.shape[:-1]
    flat = roots.reshape(-1, HW).to(torch.int64)
    N = flat.shape[0]
    dev = roots.device
    base = torch.arange(N, dtype=torch.int64, device=dev)[:, None] * (HW + 1)
    idx = torch.arange(HW, dtype=torch.int64, device=dev).expand(N, HW)
    tables = torch.zeros((3, N * (HW + 1)), dtype=torch.int64, device=dev)
    at = (flat + base).reshape(-1)
    tables[0].index_add_(0, at, torch.ones_like(at))
    tables[1].index_add_(0, at, (idx // W).reshape(-1))
    tables[2].index_add_(0, at, (idx % W).reshape(-1))
    q = qroots.reshape(N, -1).to(torch.int64)
    hit = (q >= 0) & (q < HW)
    vals = tables[:, (torch.where(hit, q, HW) + base).reshape(-1)]
    vals = torch.where(hit.reshape(1, -1), vals, 0).to(torch.int32)
    return tuple(v.reshape(lead + qroots.shape[-1:]) for v in vals)


def class_components(seg_map: torch.Tensor, cls_label: torch.Tensor,
                     num_classes: int, first_class: int,
                     peak_ys: Optional[torch.Tensor] = None,
                     peak_xs: Optional[torch.Tensor] = None,
                     peak_valid: Optional[torch.Tensor] = None) -> Components:
    """Mask the argmax seg (B, H, W) to the labelled classes in
    [first_class, num_classes), label every class's components in one
    8-connected pass over the batch, and take the stats of every
    peak-seeded component. cls_label: (B, C); peaks: (B, C, K)."""
    B, H, W = seg_map.shape
    HW = H * W
    C = num_classes
    dev = seg_map.device
    lab_ok = torch.zeros((B, C + 1), dtype=torch.bool, device=dev)
    lab_ok[:, 1:] = (cls_label > 0) & (torch.arange(C, device=dev) >= first_class)
    seg = seg_map.to(torch.int64)
    in_range = (seg >= 0) & (seg <= C)
    ok_px = torch.gather(lab_ok, 1, torch.clamp(seg, 0, C).reshape(B, HW))
    ok_px = ok_px.reshape(B, H, W) & in_range
    eff = torch.where(ok_px, seg_map, 0).to(torch.int32)
    roots = cc.connected_components_multilabel(eff, connectivity=8)
    if peak_ys is None:
        z = torch.zeros((B, 0), device=dev)
        return Components(eff, roots, z.to(torch.int32), z.to(torch.bool), z,
                          z, torch.zeros(0, dtype=torch.int64, device=dev))

    # classes below first_class never produce labels: slice them off
    K = peak_ys.shape[2]
    py = peak_ys[:, first_class:].reshape(B, -1).to(torch.int64)
    px = peak_xs[:, first_class:].reshape(B, -1).to(torch.int64)
    pcls = torch.arange(first_class, C, device=dev).repeat_interleave(K)
    at = py * W + px
    eff_at = torch.gather(eff.reshape(B, HW), 1, at)
    okp = peak_valid[:, first_class:].reshape(B, -1) & (eff_at == pcls + 1)
    proot = torch.where(okp, torch.gather(roots.reshape(B, HW), 1, at), HW)
    proot = proot.to(torch.int32)

    area, sy, sx = component_stats(roots, proot)
    denom = torch.clamp(area, min=1).float()
    cy_p = sy.float() / denom
    cx_p = sx.float() / denom
    # live peaks sharing each peak's component; acceptance wants one
    cnt = (okp[:, None, :] & (proot[:, :, None] == proot[:, None, :])).sum(-1)
    accept_p = okp & (area >= MINIMUM_MASK_SIZE) & (cnt == 1)
    return Components(eff, roots, proot, accept_p, cy_p, cx_p, pcls)


def pseudo_label_slots(seg_map: torch.Tensor, peak_ys: torch.Tensor,
                       peak_xs: torch.Tensor, peak_valid: torch.Tensor,
                       cls_label: torch.Tensor, num_classes: int,
                       max_comp: int = 64, first_class: int = 0,
                       components: Optional[Components] = None):
    """The pseudo labels of a batch except the gaussian stamp.

    Returns (slots, offset (B, 2, H, W), weight (B, 1, H, W), n_match (B,),
    truncated (B,)), slots = (valid, cy, cx, cls), each (B, max_comp): the
    accepted components in ascending root order, which the caller stamps
    with labelgen.stamp_centers_batched. Offset and weight maps cover every
    accepted component, whatever the slot cap.
    """
    if components is None:
        components = class_components(seg_map, cls_label, num_classes,
                                      first_class, peak_ys, peak_xs,
                                      peak_valid)
    comp = components
    B, H, W = seg_map.shape
    HW = H * W
    dev = seg_map.device

    # each accepted component holds exactly one live peak, so its root names
    # one accepted peak: a root table read at every pixel gives the packed
    # centroid (0 where the pixel's component was not accepted)
    acc_root = torch.where(comp.accept_p, comp.proot, HW).to(torch.int64)
    cyi = torch.clamp(torch.floor(comp.cy_p), 0, H - 1).to(torch.int64)
    cxi = torch.clamp(torch.floor(comp.cx_p), 0, W - 1).to(torch.int64)
    packed = torch.where(comp.accept_p, cyi * W + cxi + 1, 0)
    table = torch.zeros((B, HW + 1), dtype=torch.int64, device=dev)
    table.scatter_(1, acc_root, packed)
    table[:, HW] = 0
    pk = torch.gather(table, 1, comp.roots.reshape(B, HW).to(torch.int64))
    pk = pk.reshape(B, H, W)
    acc_px = pk > 0
    rem = torch.clamp(pk - 1, min=0)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    offset = torch.stack([((rem // W).float() - ys) * acc_px,
                          ((rem % W).float() - xs) * acc_px], dim=1)
    weight = acc_px.float()[:, None]

    # up to max_comp accepted components in ascending root order; every
    # rejected peak has root HW, so the sort must be stable for the slot
    # arrays to come out in the JAX function's order
    cy_p, cx_p = comp.cy_p, comp.cx_p
    pcls = comp.pcls.expand(B, -1)
    S = acc_root.shape[1]
    if S < max_comp:
        pad = max_comp - S
        acc_root = torch.cat([acc_root, acc_root.new_full((B, pad), HW)], 1)
        cy_p = torch.cat([cy_p, cy_p.new_zeros((B, pad))], 1)
        cx_p = torch.cat([cx_p, cx_p.new_zeros((B, pad))], 1)
        pcls = torch.cat([pcls, pcls.new_zeros((B, pad))], 1)
    take = torch.sort(acc_root, dim=1, stable=True)[1][:, :max_comp]
    valid = torch.gather(acc_root, 1, take) < HW
    n_match = comp.accept_p.sum(1).to(torch.int32)
    truncated = torch.clamp(n_match - max_comp, min=0)
    slots = (valid, torch.gather(cy_p, 1, take), torch.gather(cx_p, 1, take),
             torch.clamp(torch.gather(pcls, 1, take), 0,
                         num_classes - 1).to(torch.int32))
    return slots, offset, weight, n_match, truncated
