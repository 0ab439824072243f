# Frozen plain copy of cl4wsis_tpu_torch/ops/labelgen.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Center, offset and weight targets, and the gaussian center stamp
(counterpart of ``cl4wsis_tpu/ops/labelgen.py`` and of
``stamp_centers_batched`` in ``cl4wsis_tpu/ops/pallas_stamp.py``).

Instance masks carry dense ids 1..K (0 background, 255 ignore). The
per-instance pixel count and coordinate sums are exact integers; the
centroid is float32(sum) / float32(max(count, 1)), as the JAX batched
function computes it, so count, centroid and class equal JAX's bit for
bit. Offsets gather the centroid by id, with no (B, H*W, K) planes.

Every live slot max-composes exp(-(dx^2 + dy^2) / (2 sigma^2)) inside the
box |dx|, |dy| <= 3 sigma + 1 around its integer-floored center into its
class channel. A slot stamps nothing if it is invalid or its floored center
lies off the plane; a class id out of range is clipped to the nearest
channel, as in the JAX function.

The port's layout is NCHW: (B, K) slot arrays -> (B, C, H, W) float32.

:func:`stamp_centers_batched` launches the kernel of ``csrc/stamp.cu`` on a
CUDA tensor and runs :func:`stamp_centers`, the plain version, on a CPU
tensor. Both take their template from :func:`_template` on the slots'
device, so on one card they agree bit for bit.

The kernel is bound by the bytes of its output, which is almost all zeros.
A block owns a spatial tile of one image for all channels: it bins the
image's slots once, stores the (tile, channel) pairs no slot touches as
zeros, 16 bytes a thread, and gathers the max over the covering slots'
template values only where there are any. It takes any sigma, any H and W,
any B and C, and up to ``cl4_stamp_max_slots()`` slots per image.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F



def _template(sigma: int, device: torch.device) -> torch.Tensor:
    """(2r+1, 2r+1) float32 gaussian over integer offsets in [-r, r], by the
    JAX function's expression."""
    r = 3 * sigma + 1
    d = torch.arange(2 * r + 1, dtype=torch.float32, device=device) - r
    dy, dx = d[:, None], d[None, :]
    return torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * sigma ** 2))


def _fold_slots(valid: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                cls: torch.Tensor, num_classes: int, shape: Tuple[int, int]):
    """(iy, ix, sel) int32: the floored center and the channel to stamp;
    sel is -1 and the center (0, 0) where the slot stamps nothing."""
    H, W = shape
    fy, fx = torch.floor(cy), torch.floor(cx)
    ok = valid & (fy >= 0) & (fy < H) & (fx >= 0) & (fx < W)
    iy = torch.where(ok, fy, 0.0).to(torch.int32)
    ix = torch.where(ok, fx, 0.0).to(torch.int32)
    sel = torch.where(ok, torch.clamp(cls, 0, num_classes - 1), -1)
    return iy, ix, sel.to(torch.int32)


def stamp_centers(valid: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                  cls: torch.Tensor, num_classes: int, sigma: int,
                  shape: Tuple[int, int]) -> torch.Tensor:
    """Plain version: every slot's window is max-scattered into an r-padded
    plane (slots that stamp nothing scatter zeros), then the plane is cut
    back to (B, C, H, W)."""
    H, W = shape
    B, K = valid.shape
    r = 3 * sigma + 1
    win = 2 * r + 1
    dev = valid.device
    tmpl = _template(sigma, dev)
    iy, ix, sel = _fold_slots(valid, cy, cx, cls, num_classes, shape)
    live = sel >= 0
    Hp, Wp = H + 2 * r, W + 2 * r
    plane = (torch.arange(B, device=dev)[:, None] * num_classes +
             torch.clamp(sel, min=0).to(torch.int64))
    # the window's top-left in padded coordinates is the center (iy, ix)
    top = (plane * Hp + iy.to(torch.int64)) * Wp + ix.to(torch.int64)
    off = torch.arange(win, device=dev)
    idx = (top[:, :, None, None] + off[:, None] * Wp + off[None, :])
    vals = tmpl * live[:, :, None, None]
    padded = torch.zeros(B * num_classes * Hp * Wp, dtype=torch.float32,
                         device=dev)
    padded.scatter_reduce_(0, idx.reshape(-1), vals.reshape(-1), "amax",
                           include_self=True)
    return padded.view(B, num_classes, Hp, Wp)[:, :, r:r + H, r:r + W]


def stamp_centers_batched(valid: torch.Tensor, cy: torch.Tensor,
                          cx: torch.Tensor, cls: torch.Tensor,
                          num_classes: int, sigma: int,
                          shape: Tuple[int, int]) -> torch.Tensor:
    """(B, K) slot arrays -> (B, C, H, W) heatmaps; see the module doc."""
    return stamp_centers(valid, cy, cx, cls, num_classes, sigma, shape)


def _slot_sums(inst_masks: torch.Tensor, seg_maps: torch.Tensor,
               max_inst: int):
    """(B, H, W) ids and classes -> count, sum of y, sum of x and the
    largest class (B, max_inst + 1) int64, over the pixels of each id
    1..max_inst; column 0 gathers the pixels of no slot (background,
    ignore, ids above max_inst)."""
    B, H, W = inst_masks.shape
    K1 = max_inst + 1
    dev = inst_masks.device
    ids = inst_masks.long()
    valid = (ids > 0) & (ids != 255)
    slot = torch.where(valid & (ids <= max_inst), ids, 0)
    index = (slot + K1 * torch.arange(B, device=dev)[:, None, None]).view(-1)
    ys = torch.arange(H, device=dev)[:, None].expand(B, H, W).reshape(-1)
    xs = torch.arange(W, device=dev)[None, :].expand(B, H, W).reshape(-1)
    zeros = torch.zeros(B * K1, dtype=torch.int64, device=dev)
    count = torch.bincount(index, minlength=B * K1)
    sy = zeros.index_add(0, index, ys)
    sx = zeros.index_add(0, index, xs)
    segv = torch.where(valid, seg_maps.long(), 0).view(-1)
    cls = zeros.scatter_reduce(0, index, segv, "amax", include_self=True)
    return tuple(t.view(B, K1) for t in (count, sy, sx, cls))


def batched_instance_stats(inst_masks: torch.Tensor, seg_maps: torch.Tensor,
                           max_inst: int):
    """Per image and instance slot: count (B, K) float32, centroid cy, cx
    (B, K) float32 and class cls (B, K) int32, the seg class - 1 (0 for an
    empty slot). Ids above `max_inst` belong to no slot."""
    count, sy, sx, cls = (t[:, 1:] for t in
                          _slot_sums(inst_masks, seg_maps, max_inst))
    den = torch.clamp(count, min=1).float()
    return (count.float(), sy.float() / den, sx.float() / den,
            torch.clamp(cls - 1, min=0).to(torch.int32))


def _offsets(inst_masks: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
             pid: torch.Tensor):
    """Offsets (B, 2, H, W), y first, from each valid pixel to the
    centroid of slot `pid` (B, H, W) of (B, K') centroids, and the weight
    (B, 1, H, W): 1 at valid pixels, else 0 (and offset 0)."""
    B, H, W = inst_masks.shape
    dev = inst_masks.device
    vf = ((inst_masks > 0) & (inst_masks != 255)).float()
    flat = pid.view(B, -1)
    cy_pl = torch.gather(cy, 1, flat).view(B, H, W)
    cx_pl = torch.gather(cx, 1, flat).view(B, H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    offset = torch.stack([(cy_pl - ys) * vf, (cx_pl - xs) * vf], dim=1)
    return offset, vf[:, None]


def batched_label_generation(seg_maps: torch.Tensor, inst_masks: torch.Tensor,
                             num_classes: int, sigma: int = 8,
                             max_inst: int = 50):
    """The step-0 targets of a batch: center (B, C, H, W), offset
    (B, 2, H, W) and weight (B, 1, H, W), float32. The centers come from
    :func:`stamp_centers_batched` (the kernel on a CUDA tensor). An id
    above `max_inst` reads centroid 0: its offset is (-y, -x), its weight
    1, as in the JAX batched function."""
    B, H, W = inst_masks.shape
    count, cy, cx, cls = batched_instance_stats(inst_masks, seg_maps,
                                                max_inst)
    center = stamp_centers_batched(count > 0, cy, cx, cls, num_classes,
                                   sigma, (H, W))
    ids = inst_masks.long()
    pid = torch.where((ids > 0) & (ids <= max_inst), ids, 0)
    offset, weight = _offsets(inst_masks, F.pad(cy, (1, 0)),
                              F.pad(cx, (1, 0)), pid)
    return center, offset, weight


def instance_stats(inst_mask: torch.Tensor, seg_map: torch.Tensor,
                   max_inst: int):
    """One image's (H, W) ids and classes -> count (K,) float32, cy, cx
    (K,) float32 and cls (K,) int32. The per-image JAX function sums in
    float32, which equals these exact sums while they stay below 2^24; it
    leaves an empty slot's class arbitrary, here it is 0."""
    count, cy, cx, cls = batched_instance_stats(inst_mask[None],
                                                seg_map[None], max_inst)
    return count[0], cy[0], cx[0], cls[0]


def label_generation(seg_map: torch.Tensor, inst_mask: torch.Tensor,
                     num_classes: int, sigma: int = 8, max_inst: int = 50):
    """One image's targets: center (C, H, W), offset (2, H, W), weight
    (1, H, W). As in the per-image JAX function, an id above `max_inst`
    reads the last slot's centroid."""
    count, cy, cx, cls = instance_stats(inst_mask, seg_map, max_inst)
    H, W = inst_mask.shape
    center = stamp_centers_batched((count > 0)[None], cy[None], cx[None],
                                   cls[None], num_classes, sigma, (H, W))
    ids = inst_mask.long()[None]
    pid = torch.clamp(torch.where((ids > 0) & (ids != 255), ids - 1, 0),
                      max=max_inst - 1)
    offset, weight = _offsets(inst_mask[None], cy[None], cx[None], pid)
    return center[0], offset[0], weight[0]
