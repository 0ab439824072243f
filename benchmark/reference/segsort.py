# Frozen plain copy of cl4wsis_tpu_torch/ops/segsort.py for the benchmark's
# reference: the same arithmetic, every kernel replaced by its plain
# version, imports made local. Do not import the port from here.
"""Sorted-domain segment helpers and run totals (counterparts of
``cl4wsis_tpu/ops/segsort.py`` and ``cl4wsis_tpu/ops/pallas_seg.py``).

Keys are sorted, equal keys form contiguous runs, and per-run reductions
become plain operations over the runs. :func:`run_totals` gives, for every
element of a sorted key row, its run length and the run sums of three int32
payloads: on a CUDA tensor through the kernel of ``csrc/run_totals.cu``, on
a CPU tensor through :func:`run_totals_plain`, the composition of the
helpers below.

The kernel is bound by bytes (four rows read, four written). It finds run
heads and tails from neighbouring keys, totals each run inside a tile with
a forward and a backward segmented scan in registers, and settles the runs
that cross tiles from one small descriptor per tile in a second launch that
rewrites only those runs' elements. Its only scratch is the descriptors:
``cl4_run_totals_desc()`` int32 per tile of ``cl4_run_totals_tile()``
elements.
"""

from __future__ import annotations

from typing import Tuple

import torch


Totals = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sort_by(key: torch.Tensor, *payloads: torch.Tensor):
    """Sort `key` ascending along the last axis, carrying `payloads`.
    Returns (skey, *spayloads). Callers must not rely on the order of equal
    keys."""
    skey, order = torch.sort(key, dim=-1, stable=True)
    return (skey,) + tuple(torch.gather(p, -1, order) for p in payloads)


def run_starts(skeys: torch.Tensor) -> torch.Tensor:
    """True where a new equal-key run begins (position 0 included)."""
    s = skeys != torch.roll(skeys, 1, dims=-1)
    s[..., 0] = True
    return s


def run_ends(skeys: torch.Tensor) -> torch.Tensor:
    """True at the last element of each equal-key run."""
    e = skeys != torch.roll(skeys, -1, dims=-1)
    e[..., -1] = True
    return e


def _run_ids(starts: torch.Tensor) -> torch.Tensor:
    """Flat run id of every element; rows of a batch get distinct ids
    because every row starts a run at position 0."""
    return torch.cumsum(starts.reshape(-1).to(torch.int64), 0) - 1


def seg_total(vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Per-element total of its run (integer sums wrap like int32)."""
    rid = _run_ids(starts)
    tot = torch.zeros(vals.numel(), dtype=torch.int64, device=vals.device)
    tot.index_add_(0, rid, vals.reshape(-1).to(torch.int64))
    return tot[rid].reshape(vals.shape).to(vals.dtype)


def seg_length(starts: torch.Tensor) -> torch.Tensor:
    """Per-element length of its run, int32."""
    return seg_total(torch.ones_like(starts, dtype=torch.int32), starts)


def select_flagged(flags: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the first `k` True flags along the last axis, in order;
    N where exhausted. int32."""
    n = flags.shape[-1]
    cum = torch.cumsum(flags.to(torch.int64), dim=-1)
    want = torch.arange(1, k + 1, dtype=torch.int64, device=flags.device)
    want = want.expand(flags.shape[:-1] + (k,)).contiguous()
    pos = torch.searchsorted(cum.contiguous(), want, right=False)
    return torch.clamp(pos, max=n).to(torch.int32)


def run_totals_plain(skey: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                     v3: torch.Tensor) -> Totals:
    """(B, N) run totals composed from the helpers above."""
    starts = run_starts(skey)
    return (seg_length(starts), seg_total(v1, starts), seg_total(v2, starts),
            seg_total(v3, starts))


def run_totals(skey: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
               v3: torch.Tensor) -> Totals:
    """Per-element (run length, run sums of v1, v2, v3) over sorted (B, N)
    int32 key rows, exact in int32."""
    return run_totals_plain(skey, v1, v2, v3)

