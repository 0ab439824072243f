"""Norm selection by the --norm_act flag (counterpart of
``cl4wsis_tpu/core/norms.py::norm_factory``)."""

from __future__ import annotations

from cl4wsis_tpu_torch.core.abn import ABN


def norm_factory(norm_act: str):
    """iabn_sync and iabn map to ABN, as in the JAX package; AIN and ABR
    are not ported yet."""
    if norm_act in ("abr", "iabr", "ain"):
        raise NotImplementedError(f"norm_act {norm_act!r} is not ported yet")
    return ABN
