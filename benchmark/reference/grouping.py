# Frozen plain copy of cl4wsis_tpu_torch/ops/grouping.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Nearest-center pixel assignment (counterparts of
``assign_pixels_classbanks`` and ``assign_pixels_lanes`` in
``cl4wsis_tpu/ops/grouping.py``)."""

from __future__ import annotations

import torch


def assign_pixels_classbanks(ctr_y: torch.Tensor, ctr_x: torch.Tensor,
                             ctr_valid: torch.Tensor, ctr_root: torch.Tensor,
                             offsets: torch.Tensor, pixel_root: torch.Tensor,
                             px_cls: torch.Tensor, *, num_classes: int,
                             max_ctr: int, max_cluster: int) -> torch.Tensor:
    """Each pixel goes to the nearest valid center of its own class bank
    that shares its component root; ties go to the lowest k in the bank.
    Returns (H, W) int32 global slot ids, S = C*(max_ctr+max_cluster) where
    no center qualifies.

    Slots are laid out as `_global_center_slots` makes them: an NMS block
    (C, max_ctr) then a cluster block (C, max_cluster), both class-major.
    Bank k of class c is NMS slot k for k < max_ctr, else cluster slot
    k - max_ctr. A valid slot's root lies in its own class, so no other
    bank could win (root purity, as the JAX docstring argues). The JAX
    function fetches each pixel's bank row with one-hot matmuls; here it is
    an exact gather by the pixel's class.
    """
    C, mc, mcl = num_classes, max_ctr, max_cluster
    S = C * (mc + mcl)
    H, W = pixel_root.shape

    def bank(a):
        return torch.cat([a[:C * mc].reshape(C, mc),
                          a[C * mc:].reshape(C, mcl)], dim=1)

    pc = px_cls.reshape(-1).to(torch.int64)
    cy = bank(ctr_y.float())[pc]                       # (HW, K)
    cx = bank(ctr_x.float())[pc]
    cv = bank(ctr_valid)[pc]
    cr = bank(ctr_root.to(torch.int64))[pc]

    dev = offsets.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    loc_y = (ys + offsets[..., 0]).reshape(-1, 1)
    loc_x = (xs + offsets[..., 1]).reshape(-1, 1)
    proot = pixel_root.reshape(-1, 1).to(torch.int64)
    d = torch.square(loc_y - cy) + torch.square(loc_x - cx)
    d = torch.where(cv & (cr == proot), d, torch.inf)
    dmin, k = torch.min(d, dim=1)
    has = torch.isfinite(dmin)
    gid = torch.where(k < mc, pc * mc + k, C * mc + pc * mcl + (k - mc))
    return torch.where(has, gid, S).to(torch.int32).reshape(H, W)


def assign_pixels_lanes(ctr_y: torch.Tensor, ctr_x: torch.Tensor,
                        ctr_valid: torch.Tensor, ctr_root: torch.Tensor,
                        offsets: torch.Tensor, pixel_root: torch.Tensor
                        ) -> torch.Tensor:
    """Each pixel goes to the nearest valid center, over all S slots, that
    shares its component root; ties go to the lowest slot, and a pixel with
    no such center gets S. Batched: slots (B, S), offsets (B, 2, H, W)
    (y, x), pixel_root (B, H, W) -> (B, H, W) int32.

    As in the JAX function every pixel measures all S slots, here as one
    (B, H*W, S) distance plane; torch.min returns the first minimum, the
    lowest slot."""
    B, S = ctr_y.shape
    H, W = pixel_root.shape[-2:]
    dev = offsets.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    loc_y = (ys + offsets[:, 0]).reshape(B, -1, 1)
    loc_x = (xs + offsets[:, 1]).reshape(B, -1, 1)
    # in place: at the training shapes each (B, H*W, S) plane is 2 GB
    d = torch.square_(loc_y - ctr_y.float()[:, None, :])
    d += torch.square_(loc_x - ctr_x.float()[:, None, :])
    ok = ctr_valid[:, None, :] & (pixel_root.reshape(B, -1, 1) ==
                                  ctr_root[:, None, :])
    dmin, best = torch.min(d.masked_fill_(~ok, torch.inf), dim=2)
    has = torch.isfinite(dmin)
    return torch.where(has, best, S).to(torch.int32).reshape(B, H, W)
