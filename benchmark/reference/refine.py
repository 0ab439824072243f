# Frozen plain copy of cl4wsis_tpu_torch/ops/refine.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Center slots, slot statistics and the self-refinement labels (counterpart
of ``cl4wsis_tpu/ops/refine.py``).

Every class's center slots live in one flat slot array: NC*max_ctr NMS
centers, then NC*max_cluster offset-cluster centers, class-major, for the
NC classes in [first_class, num_classes). :func:`_global_center_slots` and
the training functions take a leading batch axis, so each kernel they reach
(top-k over the NMS rows, 4-connected components of the weak clusters, run
totals) is one launch per batch; eval's ``get_ins_map`` calls them with a
batch of one. Maps are NCHW.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import cc, segsort, topk
from .grouping import assign_pixels_lanes
from .peaks import max_pool_same
from .pseudo_labels import (MAXIMUM_NUM_INST,
                                                 MINIMUM_MASK_SIZE,
                                                 Components,
                                                 class_components,
                                                 component_stats)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] for x (B, N) and idx (B, ...)."""
    B = x.shape[0]
    return torch.gather(x, 1, idx.reshape(B, -1)).reshape(idx.shape)


def _global_center_slots(eff: torch.Tensor, roots: torch.Tensor,
                         center_map: torch.Tensor, offset_map: torch.Tensor,
                         threshold: float, nms_kernel: int, beta: float,
                         max_ctr: int, max_cluster: int, num_classes: int,
                         first_class: int = 0, max_inst_cap: bool = False
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                    torch.Tensor]:
    """Center slots of every class in [first_class, num_classes).

    eff, roots: (B, H, W) int32 class map and its 8-connected roots;
    center_map: (B, C, H, W); offset_map: (B, 2, H, W) (y, x).
    Returns (slots, ch_spiked (B, NC, H, W), truncated (B,) int32): slots
    holds (B, S) arrays ys, xs, valid, root, cls (global class ids), cyf,
    cxf. `max_inst_cap` drops every slot of a component with more than
    MAXIMUM_NUM_INST valid centers (refinement only; eval has no cap).
    """
    B, H, W = eff.shape
    HW = H * W
    C = num_classes
    nc = C - first_class
    dev = eff.device
    classes = torch.arange(first_class, C, device=dev)     # global ids
    roots_f = roots.reshape(B, HW)

    # component-masked heatmaps and pooled NMS for every class at once
    fg_all = eff[:, None] == (classes + 1)[None, :, None, None]
    ch_all = center_map[:, first_class:] * fg_all
    x_nms = torch.where(ch_all > threshold, ch_all, -1.0)
    hmax = max_pool_same(x_nms, nms_kernel)
    x_nms = torch.where(x_nms == hmax, x_nms, -1.0)
    flat_nms = x_nms.reshape(B, nc, HW)
    n_vals, n_idx = topk.topk_hier(flat_nms, max_ctr)     # (B, nc, max_ctr)
    n_idx = n_idx.to(torch.int64)
    n_ys, n_xs = n_idx // W, n_idx % W
    n_valid = n_vals > 0
    n_root = _rows(roots_f, n_idx)
    nms_counts = (flat_nms > 0).sum(dim=2)
    truncated = torch.clamp(nms_counts - max_ctr, min=0).sum(1)

    # offset-cluster components of every class in one 4-connected pass; the
    # class rides in the sort key (components are class-pure)
    mag = torch.sqrt(torch.square(offset_map[:, 0]) +
                     torch.square(offset_map[:, 1]))
    weak_eff = torch.where(mag < 2.5, eff, 0).to(torch.int32)
    roots_w = cc.connected_components_multilabel(weak_eff, connectivity=4)
    idx = torch.arange(HW, dtype=torch.int32, device=dev).expand(B, HW)
    mult = 1 << int(C).bit_length()
    if HW * mult + C < 2 ** 31:
        packed = roots_w.reshape(B, HW) * mult + weak_eff.reshape(B, HW)
        spacked, sidxw = segsort.sort_by(packed, idx)
        skw, sclsw = spacked // mult, spacked % mult
    else:
        skw, sidxw, sclsw = segsort.sort_by(roots_w.reshape(B, HW), idx,
                                            weak_eff.reshape(B, HW))
    startsw = segsort.run_starts(skw)
    area_w, syw, sxw, _ = segsort.run_totals(skw, sidxw // W, sidxw % W,
                                             torch.zeros_like(skw))
    den_w = torch.clamp(area_w, min=1).float()
    cyw_e = syw.float() / den_w
    cxw_e = sxw.float() / den_w
    accept_w = (skw < HW) & (area_w > 21 - beta) & (area_w < 21 + beta)

    # first 2*max_cluster accepted components of each class: the overflow
    # half is checked too, so a valid candidate past the cap counts as
    # truncated
    k2 = 2 * max_cluster
    fl = ((startsw & accept_w)[:, None] &
          (sclsw[:, None] == (classes + 1)[None, :, None]))   # (B, nc, HW)
    c_pos = segsort.select_flagged(fl, k2).to(torch.int64)   # (B, nc, k2)
    posc = torch.clamp(c_pos, max=HW - 1)
    c_acc = (c_pos < HW) & torch.gather(fl, 2, posc)
    c_ys = torch.floor(_rows(cyw_e, posc)).to(torch.int64)
    c_xs = torch.floor(_rows(cxw_e, posc)).to(torch.int64)
    c_at = c_ys * W + c_xs
    c_root = _rows(roots_f, c_at)
    ch_at = torch.gather(ch_all.reshape(B, nc, HW), 2, c_at)

    # one stats query for every slot's component: size gate and centroid
    q = torch.cat([n_root.reshape(B, -1), c_root.reshape(B, -1)], 1)
    area_q, sy_q, sx_q = component_stats(roots, q)
    ok_q = area_q >= MINIMUM_MASK_SIZE
    den_q = torch.clamp(area_q, min=1).float()
    cyf_q = torch.clamp(torch.floor(sy_q.float() / den_q), 0, H - 1)
    cxf_q = torch.clamp(torch.floor(sx_q.float() / den_q), 0, W - 1)
    n_sl = nc * max_ctr
    ok_n = ok_q[:, :n_sl].reshape(n_root.shape)
    ok_c = ok_q[:, n_sl:].reshape(c_root.shape)

    n_valid = n_valid & (n_root != HW) & ok_n
    c_valid = c_acc & (ch_at > 0.05) & (c_root != HW) & ok_c
    # a cluster center counts only if > 100 px from every valid NMS center
    # of its component
    d2 = (torch.square(c_ys[..., :, None] - n_ys[..., None, :]).float() +
          torch.square(c_xs[..., :, None] - n_xs[..., None, :]))
    same = n_valid[..., None, :] & (c_root[..., :, None] == n_root[..., None, :])
    min_d = torch.where(same, torch.sqrt(d2), torch.inf).amin(dim=-1)
    c_valid = c_valid & (min_d > 100.0)
    truncated = truncated + c_valid[..., max_cluster:].sum((1, 2))
    cyf_n = cyf_q[:, :n_sl].reshape(n_root.shape)
    cxf_n = cxf_q[:, :n_sl].reshape(n_root.shape)
    cyf_c = cyf_q[:, n_sl:].reshape(c_root.shape)[..., :max_cluster]
    cxf_c = cxf_q[:, n_sl:].reshape(c_root.shape)[..., :max_cluster]
    c_ys, c_xs = c_ys[..., :max_cluster], c_xs[..., :max_cluster]
    c_at, c_root = c_at[..., :max_cluster], c_root[..., :max_cluster]
    c_valid = c_valid[..., :max_cluster]

    # valid cluster centers read as 1.0 spikes in the heatmap (the JAX code
    # also writes the unchanged value back at the invalid ones); a max
    # scatter marks them whatever the order of duplicate positions
    spike = torch.zeros((B, nc, HW), device=dev)
    spike.scatter_reduce_(2, c_at, c_valid.float(), "amax")
    ch_spiked = torch.where(spike.reshape(B, nc, H, W) > 0, 1.0, ch_all)

    def flat(a, b):
        return torch.cat([a.reshape(B, -1), b.reshape(B, -1)], 1)

    cls_ids = torch.cat([classes.repeat_interleave(max_ctr),
                         classes.repeat_interleave(max_cluster)])
    slots = {
        "ys": flat(n_ys, c_ys).to(torch.int32),
        "xs": flat(n_xs, c_xs).to(torch.int32),
        "valid": flat(n_valid, c_valid),
        "root": flat(n_root, c_root),
        "cls": cls_ids.to(torch.int32).expand(B, -1),
        "cyf": flat(cyf_n, cyf_c),
        "cxf": flat(cxf_n, cxf_c),
    }
    if max_inst_cap:
        # drop whole components with too many centers; roots are
        # class-pure, so one count per root is the per-class rule
        v, r = slots["valid"], slots["root"]
        per_root = (v[:, None, :] & (r[:, :, None] == r[:, None, :])).sum(-1)
        slots["valid"] = v & (per_root <= MAXIMUM_NUM_INST)
    return slots, ch_spiked, truncated.to(torch.int32)


def _px_class_values(eff: torch.Tensor, ch_spiked: torch.Tensor,
                     seg_probs_things: torch.Tensor, first_class: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel heatmap and probability of the pixel's own class channel
    (the first active channel for background), as (B, HW) gathers.
    eff: (B, H, W); ch_spiked, seg_probs_things: (B, NC, H, W), sliced to
    the active classes."""
    B, nc = ch_spiked.shape[:2]
    px_cls = torch.clamp(eff.reshape(B, 1, -1).to(torch.int64) - 1
                         - first_class, min=0)
    val = torch.gather(ch_spiked.reshape(B, nc, -1), 1, px_cls)[:, 0]
    prob = torch.gather(seg_probs_things.reshape(B, nc, -1), 1, px_cls)[:, 0]
    return val, prob


def _slot_stats_sorted(assign: torch.Tensor, eff: torch.Tensor,
                       ch_spiked: torch.Tensor,
                       seg_probs_things: torch.Tensor, n_slots: int):
    """Per-slot (npix, seg_score, vmax, py, px) of one image, each
    (n_slots + 1,), the last entry being the unassigned bin (eval's form).
    assign, eff: (H, W); ch_spiked, seg_probs_things: (C, H, W).

    One lexicographic sort by (slot, -val, pixel) makes each run's head the
    slot's maximum and its smallest pixel. The sort is three stable sorts,
    least significant key first; -val is sorted by its float total order,
    as jax.lax.sort orders floats. Probability totals are differences of a
    float64 prefix sum, which resolves a late small run as well as the JAX
    double-single scan does.
    """
    H, W = eff.shape
    HW = H * W
    val, prob = (v[0] for v in _px_class_values(
        eff[None], ch_spiked[None], seg_probs_things[None]))
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


def _slot_stats(assign: torch.Tensor, eff: torch.Tensor,
                ch_spiked: torch.Tensor, seg_probs_things: torch.Tensor,
                n_slots: int, first_class: int = 0):
    """Per-slot (npix, seg_score, vmax, py, px), each (B, n_slots + 1), the
    last entry being the unassigned bin: the JAX lane form's statistics.

    The argmax pixel is the smallest flat index whose value is within 1e-12
    of the slot's maximum (the lane form's tolerance). Counts, maxima and
    argmax pixels are integer or max/min scatters, exact in any order; the
    probability totals are differences of a float64 prefix sum over the
    pixels sorted by slot, so they too come out the same on every run.
    assign, eff: (B, H, W); ch_spiked, seg_probs_things: (B, NC, H, W),
    sliced to the active classes.
    """
    B, H, W = eff.shape
    HW = H * W
    S1 = n_slots + 1
    dev = eff.device
    val, prob = _px_class_values(eff, ch_spiked, seg_probs_things,
                                 first_class)
    a = assign.reshape(B, HW).to(torch.int64)

    skey, order = torch.sort(a, dim=1, stable=True)
    bnd = torch.searchsorted(
        skey, torch.arange(S1 + 1, device=dev).expand(B, S1 + 1).contiguous())
    npix = (bnd[:, 1:] - bnd[:, :-1]).float()
    csum = torch.cat([torch.zeros((B, 1), dtype=torch.float64, device=dev),
                      torch.cumsum(torch.gather(prob, 1, order).double(), 1)],
                     1)
    psum = (torch.gather(csum, 1, bnd[:, 1:]) -
            torch.gather(csum, 1, bnd[:, :-1])).float()
    seg_score = psum / torch.clamp(npix, min=1.0)

    vmax = torch.full((B, S1), -torch.inf, device=dev)
    vmax.scatter_reduce_(1, a, val, "amax")
    vmax[:, n_slots] = -torch.inf
    at_max = val >= torch.gather(vmax, 1, a) - 1e-12
    idx = torch.arange(HW, device=dev).expand(B, HW)
    pmax = torch.full((B, S1), 2 * HW, dtype=torch.int64, device=dev)
    pmax.scatter_reduce_(1, a, torch.where(at_max, idx, 2 * HW), "amin")
    return npix, seg_score, vmax, (pmax // W).float(), (pmax % W).float()


def refine_label_slots(seg_probs: torch.Tensor, center_map: torch.Tensor,
                       offset_map: torch.Tensor, label: torch.Tensor,
                       gt_seg: torch.Tensor, *, num_classes: int,
                       refine_thresh: float = 0.3, nms_kernel: int = 41,
                       beta: float = 3.0, max_ctr: int = 16,
                       max_cluster: int = 8, first_class: int = 0,
                       components: Components = None
                       ) -> Dict[str, torch.Tensor]:
    """Self-refinement labels of a batch from the model's own predictions,
    except the gaussian stamp: (stamp_valid, stamp_y, stamp_x, stamp_cls),
    each (B, S), for labelgen.stamp_centers_batched, and offset
    (B, 2, H, W), weight (B, 1, H, W), truncated (B,).

    seg_probs: (B, C+1, H, W) softmax seg, thing channels masked by the
    image-level label; center_map: (B, C, H, W); offset_map: (B, 2, H, W);
    label: (B, C) new-class labels; gt_seg: (B, H, W) argmax seg with old
    classes zeroed. `components`: the pseudo-label pass's shared
    class_components of the same (gt_seg, label).
    """
    B, H, W = gt_seg.shape
    HW = H * W
    C = num_classes
    n_slots = (C - first_class) * (max_ctr + max_cluster)
    dev = gt_seg.device
    if components is None:
        components = class_components(gt_seg, label, C, first_class)
    eff, roots = components.eff, components.roots

    slots, ch_spiked, truncated = _global_center_slots(
        eff, roots, center_map, offset_map, refine_thresh, nms_kernel, beta,
        max_ctr, max_cluster, C, first_class, max_inst_cap=True)
    assign = assign_pixels_lanes(slots["ys"], slots["xs"], slots["valid"],
                                 slots["root"], offset_map, roots)
    npix, seg_score, vmax, py, px = _slot_stats(
        assign, eff, ch_spiked, seg_probs[:, 1 + first_class:], n_slots,
        first_class)

    center_score = vmax[:, :n_slots]
    seg_score = seg_score[:, :n_slots]
    slot_ok = slots["valid"] & (npix[:, :n_slots] > 0)
    # a weak center falls back to the floored centroid of its component
    use_seg_center = center_score < refine_thresh
    out_y = torch.where(use_seg_center, slots["cyf"], py[:, :n_slots])
    out_x = torch.where(use_seg_center, slots["cxf"], px[:, :n_slots])
    conf = torch.where(use_seg_center, seg_score, center_score * seg_score)
    conf = torch.clamp(conf, 0.0, 1.0)

    # pixel maps: weight = conf of the pixel's slot, offsets toward the
    # slot's center; the unassigned bin reads zeros
    zero = torch.zeros((B, 1), device=dev)
    slot_conf = torch.cat([torch.where(slot_ok, conf, 0.0), zero], 1)
    oy_i = torch.clamp(out_y, 0, H - 1).to(torch.int64)
    ox_i = torch.clamp(out_x, 0, W - 1).to(torch.int64)
    packed = (slot_ok.to(torch.int64) * H + oy_i) * W + ox_i
    packed = torch.cat([packed, zero.to(torch.int64)], 1)
    af = assign.reshape(B, HW).to(torch.int64)
    pk = torch.gather(packed, 1, af).reshape(B, H, W)
    conf_px = torch.gather(slot_conf, 1, af).reshape(B, H, W)
    live = pk >= HW
    rem = pk - torch.where(live, HW, 0)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    weight = (conf_px * live)[:, None]
    offset = torch.stack([((rem // W).float() - ys) * live,
                          ((rem % W).float() - xs) * live], dim=1)
    return {"stamp_valid": slot_ok, "stamp_y": out_y, "stamp_x": out_x,
            "stamp_cls": slots["cls"], "offset": offset, "weight": weight,
            "truncated": truncated}
