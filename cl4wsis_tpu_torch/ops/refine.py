"""Center slots and slot statistics of the instance grouping (counterpart of
the parts of ``cl4wsis_tpu/ops/refine.py`` that eval's ``get_ins_map``
reaches; the training refinement comes with the training path).

Every class's center slots live in one flat slot array: C*max_ctr NMS
centers, then C*max_cluster offset-cluster centers, class-major.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cl4wsis_tpu_torch.ops import cc, segsort, topk
from cl4wsis_tpu_torch.ops.peaks import max_pool_same
from cl4wsis_tpu_torch.ops.pseudo_labels import (MINIMUM_MASK_SIZE,
                                                 component_stats)


def _global_center_slots(eff: torch.Tensor, roots: torch.Tensor,
                         center_map: torch.Tensor, offset_map: torch.Tensor,
                         threshold: float, nms_kernel: int, beta: float,
                         max_ctr: int, max_cluster: int, num_classes: int
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                    torch.Tensor]:
    """Center slots of every class (eval form: all classes active, no
    per-component instance cap).

    eff, roots: (H, W) int32 class map and its 8-connected roots;
    center_map: (H, W, C); offset_map: (H, W, 2) (y, x).
    Returns (slots, ch_spiked (H, W, C), truncated): slots holds (S,) arrays
    ys, xs, valid, root, cls, cyf, cxf.
    """
    H, W = eff.shape
    HW = H * W
    C = num_classes
    dev = eff.device
    classes = torch.arange(C, device=dev)

    # component-masked heatmaps and pooled NMS for every class at once
    fg_all = eff[..., None] == (classes + 1)
    ch_all = center_map * fg_all
    x_nms = torch.where(ch_all > threshold, ch_all, -1.0)
    hmax = max_pool_same(x_nms[None], nms_kernel)[0]
    x_nms = torch.where(x_nms == hmax, x_nms, -1.0)
    flat_nms = x_nms.permute(2, 0, 1).reshape(C, HW).contiguous()
    n_vals, n_idx = topk.topk_hier(flat_nms, max_ctr)      # (C, max_ctr)
    n_idx = n_idx.to(torch.int64)
    n_ys, n_xs = n_idx // W, n_idx % W
    n_valid = n_vals > 0
    n_root = roots[n_ys, n_xs]
    nms_counts = (flat_nms > 0).sum(dim=1)
    truncated = torch.clamp(nms_counts - max_ctr, min=0).sum()

    # offset-cluster components of every class in one 4-connected pass; the
    # class rides in the sort key (components are class-pure)
    mag = torch.sqrt(torch.square(offset_map[..., 0]) +
                     torch.square(offset_map[..., 1]))
    weak_eff = torch.where(mag < 2.5, eff, 0).to(torch.int32)
    roots_w = cc.connected_components_multilabel(weak_eff, connectivity=4)
    idx = torch.arange(HW, dtype=torch.int32, device=dev)
    mult = 1 << int(C).bit_length()
    if HW * mult + C < 2 ** 31:
        packed = roots_w.reshape(-1) * mult + weak_eff.reshape(-1)
        spacked, sidxw = segsort.sort_by(packed, idx)
        skw, sclsw = spacked // mult, spacked % mult
    else:
        skw, sidxw, sclsw = segsort.sort_by(roots_w.reshape(-1), idx,
                                            weak_eff.reshape(-1))
    startsw = segsort.run_starts(skw)
    area_w, syw, sxw, _ = segsort.run_totals1(skw, sidxw // W, sidxw % W,
                                              torch.zeros_like(skw))
    den_w = torch.clamp(area_w, min=1).float()
    cyw_e = syw.float() / den_w
    cxw_e = sxw.float() / den_w
    accept_w = (skw < HW) & (area_w > 21 - beta) & (area_w < 21 + beta)

    # first 2*max_cluster accepted components of each class: the overflow
    # half is checked too, so a valid candidate past the cap counts as
    # truncated
    k2 = 2 * max_cluster
    fl = startsw[None] & accept_w[None] & (sclsw[None] == classes[:, None] + 1)
    c_pos = segsort.select_flagged(fl, k2).to(torch.int64)   # (C, k2)
    posc = torch.clamp(c_pos, max=HW - 1)
    c_acc = (c_pos < HW) & torch.gather(fl, 1, posc)
    c_ys = torch.floor(cyw_e[posc]).to(torch.int64)
    c_xs = torch.floor(cxw_e[posc]).to(torch.int64)
    c_root = roots[c_ys, c_xs]
    ch_at = ch_all[c_ys, c_xs, classes[:, None]]

    # one stats query for every slot's component: size gate and centroid
    q = torch.cat([n_root.reshape(-1), c_root.reshape(-1)])
    area_q, sy_q, sx_q = component_stats(roots, q)
    ok_q = area_q >= MINIMUM_MASK_SIZE
    den_q = torch.clamp(area_q, min=1).float()
    cyf_q = torch.clamp(torch.floor(sy_q.float() / den_q), 0, H - 1)
    cxf_q = torch.clamp(torch.floor(sx_q.float() / den_q), 0, W - 1)
    n_sl = n_root.numel()
    ok_n = ok_q[:n_sl].reshape(n_root.shape)
    ok_c = ok_q[n_sl:].reshape(c_root.shape)

    n_valid = n_valid & (n_root != HW) & ok_n
    c_valid = c_acc & (ch_at > 0.05) & (c_root != HW) & ok_c
    # a cluster center counts only if > 100 px from every valid NMS center
    # of its component
    d2 = (torch.square(c_ys[:, :, None] - n_ys[:, None, :]).float() +
          torch.square(c_xs[:, :, None] - n_xs[:, None, :]))
    same = n_valid[:, None, :] & (c_root[:, :, None] == n_root[:, None, :])
    min_d = torch.where(same, torch.sqrt(d2), torch.inf).amin(dim=2)
    c_valid = c_valid & (min_d > 100.0)
    truncated = truncated + c_valid[:, max_cluster:].sum()
    cyf_n = cyf_q[:n_sl].reshape(n_root.shape)
    cxf_n = cxf_q[:n_sl].reshape(n_root.shape)
    cyf_c = cyf_q[n_sl:].reshape(c_root.shape)[:, :max_cluster]
    cxf_c = cxf_q[n_sl:].reshape(c_root.shape)[:, :max_cluster]
    c_ys, c_xs = c_ys[:, :max_cluster], c_xs[:, :max_cluster]
    c_root = c_root[:, :max_cluster]
    c_valid = c_valid[:, :max_cluster]

    # valid cluster centers read as 1.0 spikes in the heatmap; the JAX code
    # also writes the unchanged value back at the invalid ones
    ch_spiked = ch_all.clone()
    cls_c = classes[:, None].expand_as(c_ys)
    ch_spiked[c_ys[c_valid], c_xs[c_valid], cls_c[c_valid]] = 1.0

    slots = {
        "ys": torch.cat([n_ys.reshape(-1), c_ys.reshape(-1)]).to(torch.int32),
        "xs": torch.cat([n_xs.reshape(-1), c_xs.reshape(-1)]).to(torch.int32),
        "valid": torch.cat([n_valid.reshape(-1), c_valid.reshape(-1)]),
        "root": torch.cat([n_root.reshape(-1), c_root.reshape(-1)]),
        "cls": torch.cat([classes.repeat_interleave(max_ctr),
                          classes.repeat_interleave(max_cluster)]
                         ).to(torch.int32),
        "cyf": torch.cat([cyf_n.reshape(-1), cyf_c.reshape(-1)]),
        "cxf": torch.cat([cxf_n.reshape(-1), cxf_c.reshape(-1)]),
    }
    return slots, ch_spiked, truncated.to(torch.int32)


def _px_class_values(eff: torch.Tensor, ch_spiked: torch.Tensor,
                     seg_probs_things: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel heatmap and probability of the pixel's own class channel
    (channel 0 for background), as flat (HW,) gathers."""
    HW = eff.numel()
    C = ch_spiked.shape[-1]
    px_cls = torch.clamp(eff.reshape(-1, 1).to(torch.int64) - 1, min=0)
    val = torch.gather(ch_spiked.reshape(HW, C), 1, px_cls)[:, 0]
    prob = torch.gather(seg_probs_things.reshape(HW, C), 1, px_cls)[:, 0]
    return val, prob


def _slot_stats_sorted(assign: torch.Tensor, eff: torch.Tensor,
                       ch_spiked: torch.Tensor,
                       seg_probs_things: torch.Tensor, n_slots: int):
    """Per-slot (npix, seg_score, vmax, py, px), each (n_slots + 1,), the
    last entry being the unassigned bin.

    One lexicographic sort by (slot, -val, pixel) makes each run's head the
    slot's maximum and its smallest pixel. The sort is three stable sorts,
    least significant key first; -val is sorted by its float total order,
    as jax.lax.sort orders floats. Probability totals are differences of a
    float64 prefix sum, which resolves a late small run as well as the JAX
    double-single scan does.
    """
    H, W = eff.shape
    HW = H * W
    val, prob = _px_class_values(eff, ch_spiked, seg_probs_things)
    a = assign.reshape(-1).to(torch.int32)
    order = torch.sort(topk.sortable_int(-val), stable=True)[1]
    order = order[torch.sort(a[order], stable=True)[1]]
    skey, nval, sprob = a[order], -val[order], prob[order]
    bnd = torch.searchsorted(
        skey, torch.arange(n_slots + 2, dtype=torch.int32, device=a.device),
        right=False)
    npix = (bnd[1:] - bnd[:-1]).float()
    csum = torch.cat([torch.zeros(1, dtype=torch.float64, device=a.device),
                      torch.cumsum(sprob.double(), 0)])
    psum = (csum[bnd[1:]] - csum[bnd[:-1]]).float()
    seg_score = psum / torch.clamp(npix, min=1.0)
    first = torch.clamp(bnd[:-1], 0, HW - 1)
    has = npix > 0
    vmax = torch.where(has, -nval[first], -torch.inf)
    vmax[-1] = -torch.inf
    pmax = torch.where(has, order[first], HW * 2)
    py = (pmax // W).float()
    px = (pmax % W).float()
    return npix, seg_score, vmax, py, px
