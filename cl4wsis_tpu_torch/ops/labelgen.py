"""Gaussian center stamping (counterpart of ``stamp_centers`` in
``cl4wsis_tpu/ops/labelgen.py`` and ``stamp_centers_batched`` in
``cl4wsis_tpu/ops/pallas_stamp.py``).

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

from cl4wsis_tpu_torch.ops import kernels


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


def stamp_centers_cuda(valid: torch.Tensor, cy: torch.Tensor,
                       cx: torch.Tensor, cls: torch.Tensor, num_classes: int,
                       sigma: int, shape: Tuple[int, int]) -> torch.Tensor:
    """(B, K) slots on the card -> (B, C, H, W) float32 (csrc/stamp.cu)."""
    H, W = shape
    if valid.dim() != 2:
        raise ValueError(f"stamp: expected (B, K) slots, got "
                         f"{tuple(valid.shape)}")
    for name, t in (("cy", cy), ("cx", cx), ("cls", cls)):
        if t.shape != valid.shape:
            raise ValueError(f"stamp: {name} has shape {tuple(t.shape)}, "
                             f"valid {tuple(valid.shape)}")
    B, K = valid.shape
    lib = kernels.lib()
    if K > lib.cl4_stamp_max_slots():
        raise ValueError(f"stamp: at most {lib.cl4_stamp_max_slots()} slots "
                         f"per image, got {K}")
    if sigma < 0 or min(B, H, W, num_classes) < 1:
        raise ValueError(f"stamp: unsupported sigma {sigma} or shape "
                         f"(B {B}, C {num_classes}, H {H}, W {W})")
    tmpl = _template(sigma, valid.device)
    iy, ix, sel = (t.contiguous() for t in
                   _fold_slots(valid, cy, cx, cls, num_classes, shape))
    for name, t in (("iy", iy), ("ix", ix), ("sel", sel)):
        kernels.require_cuda(t, torch.int32, 2, f"stamp {name}")
    out = torch.empty((B, num_classes, H, W), dtype=torch.float32,
                      device=valid.device)
    err = lib.cl4_stamp(
        kernels.ptr(iy), kernels.ptr(ix), kernels.ptr(sel), kernels.ptr(tmpl),
        kernels.ptr(out), B, K, num_classes, H, W, 3 * sigma + 1,
        kernels.stream_of(out))
    kernels.check(err, "stamp")
    return out


def stamp_centers_batched(valid: torch.Tensor, cy: torch.Tensor,
                          cx: torch.Tensor, cls: torch.Tensor,
                          num_classes: int, sigma: int,
                          shape: Tuple[int, int]) -> torch.Tensor:
    """(B, K) slot arrays -> (B, C, H, W) heatmaps; see the module doc."""
    if not valid.is_cuda:
        return stamp_centers(valid, cy, cx, cls, num_classes, sigma, shape)
    return stamp_centers_cuda(valid, cy, cx, cls, num_classes, sigma, shape)
