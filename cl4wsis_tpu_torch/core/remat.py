"""Block rematerialisation for ``--remat`` (the counterpart of flax's
``nn.remat`` on each backbone block of the JAX package).

:func:`checkpointed` runs a block under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: its
activations are dropped after the forward and recomputed in the backward.
A recompute must leave what the forward did alone, which PyTorch's
checkpoint does not see to in two places:

* the norms' running statistics would move twice: while a recompute runs,
  :func:`recomputing` is true and the norms skip their update;
* ``preserve_rng_state`` restores only torch's default generators, not an
  explicit ``torch.Generator``: the recompute draws its dropout masks from
  the generator's state as it was before the block's forward, then hands
  the generator back at the state the backward found it in.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

_STATE = threading.local()


def recomputing() -> bool:
    """True while a checkpointed block is being recomputed in this thread."""
    return getattr(_STATE, "depth", 0) > 0


def checkpointed(fn: Callable, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
    """``fn(x)``, its activations recomputed in the backward. `generator`
    is the one `fn` draws its dropout masks from, if any. Without autograd
    (no_grad, inference) this is ``fn(x)``."""
    if not torch.is_grad_enabled():
        return fn(x)
    before = None if generator is None else generator.get_state()
    calls = []

    def run(inp):
        if not calls:           # the forward
            calls.append(1)
            return fn(inp)
        _STATE.depth = getattr(_STATE, "depth", 0) + 1
        after = None
        if generator is not None:
            after = generator.get_state()
            generator.set_state(before)
        try:
            return fn(inp)
        finally:
            if generator is not None:
                generator.set_state(after)
            _STATE.depth -= 1

    return checkpoint(run, x, use_reentrant=False)
