# Frozen plain copy of cl4wsis_tpu_torch/ops/cc.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Connected components (counterparts of ``connected_components_multilabel``
and ``connected_components`` in ``cl4wsis_tpu/ops/cc.py``).

Multilabel: every pixel with class > 0 gets the smallest flat index of its
same-class component; background (class <= 0) gets H*W. Pixels connect only
to equal classes, so one pass labels every class at once. Binary: every
nonzero pixel of a mask gets the smallest flat index of its component.

On a CUDA tensor :func:`connected_components_multilabel` and
:func:`connected_components` launch the union-find kernels of
``csrc/cc.cu``; on a CPU tensor they run :func:`cc_multilabel_plain`, label
propagation to a fixpoint. Neither has an iteration cap: both stop only when
the labels are final.
"""

from __future__ import annotations

import torch


_BIG = torch.iinfo(torch.int32).max


def _neighbour_offsets(connectivity: int):
    if connectivity == 4:
        return ((-1, 0), (1, 0), (0, -1), (0, 1))
    if connectivity == 8:
        return tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                     if (dy, dx) != (0, 0))
    raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")


def _shift(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], `fill` outside the plane."""
    H, W = x.shape[-2:]
    p = torch.nn.functional.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def cc_multilabel_plain(cls_map: torch.Tensor,
                        connectivity: int = 8) -> torch.Tensor:
    """Fixpoint label propagation: each round takes the minimum label over
    the same-class neighbours, then jumps pointers twice (l = l[l]), until
    no label changes. (H, W) or (N, H, W) -> int32 roots."""
    cls = cls_map.to(torch.int32)
    H, W = cls.shape[-2:]
    planes = cls.reshape(-1, H, W)
    N = planes.shape[0]
    fg = planes > 0
    idx = torch.arange(H * W, dtype=torch.int64, device=cls.device)
    base = (torch.arange(N, dtype=torch.int64, device=cls.device) * H * W)
    lab = torch.where(fg, idx.reshape(1, H, W).expand(N, H, W), _BIG)
    edges = [(dy, dx, (_shift(planes, dy, dx, -1) == planes) & fg)
             for dy, dx in _neighbour_offsets(connectivity)]
    while True:
        new = lab
        for dy, dx, ok in edges:
            nb = _shift(lab, dy, dx, _BIG)
            new = torch.minimum(new, torch.where(ok, nb, _BIG))
        flat = new.reshape(N, H * W)
        for _ in range(2):
            safe = torch.where(flat == _BIG, 0, flat) + base[:, None]
            hop = flat.reshape(-1)[safe]
            flat = torch.where(flat == _BIG, _BIG, torch.minimum(flat, hop))
        new = flat.reshape(N, H, W)
        if torch.equal(new, lab):
            break
        lab = new
    out = torch.where(fg, lab, H * W).to(torch.int32)
    return out.reshape(cls.shape)


def connected_components_multilabel(cls_map: torch.Tensor,
                                    connectivity: int = 8) -> torch.Tensor:
    """Label all classes' components in one pass; see the module doc."""
    return cc_multilabel_plain(cls_map, connectivity)


def cc_binary_plain(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """The fixpoint of :func:`cc_multilabel_plain` over the one class
    `mask != 0`. (H, W) or (N, H, W) -> int32 roots."""
    return cc_multilabel_plain((mask != 0).to(torch.int32), connectivity)


def connected_components(mask: torch.Tensor,
                         connectivity: int = 8) -> torch.Tensor:
    """Label the nonzero pixels of a mask; see the module doc."""
    return cc_binary_plain(mask, connectivity)
