"""What a phase-2 step decided, recorded while it runs: every call of its
label factory (arguments and results, copied to the host at once, since
the step blends the results in place afterwards), and the first outputs
of its old model and its PeakGenerator (forward hooks). The tap swaps the
module attribute ``label_factory`` that the step looks up at each call,
for the set-up's compared steps only; the window runs the step as it is."""

from __future__ import annotations

import inspect
from typing import Dict, List, Tuple

import torch


def to_host(obj):
    """A copy of `obj` with every tensor on the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def flat(obj, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor in `obj`, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [(path, obj)]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in flat(obj[k], f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [x for i, v in enumerate(obj) for x in flat(v, f"{path}[{i}]")]
    return []


class Tap:
    def __init__(self, step_module, old: torch.nn.Module,
                 pg: torch.nn.Module):
        self.module, self.old, self.pg = step_module, old, pg
        self.calls: List[Dict] = []
        self.first: Dict = {}

    def __enter__(self) -> "Tap":
        real = self.module.label_factory
        sig = inspect.signature(real)

        def tapped(*args, **kw):
            out = real(*args, **kw)
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            self.calls.append({"args": to_host(dict(bound.arguments)),
                               "fac": to_host(out)})
            return out
        self.real = real
        self.module.label_factory = tapped
        def keep(name, value):
            if name not in self.first:
                self.first[name] = to_host(value)
        self.hooks = [   # a hook that returns None leaves the output alone
            self.old.register_forward_hook(lambda m, i, o: keep("old", o)),
            self.pg.register_forward_hook(lambda m, i, o: keep("cam", o[1]))]
        return self

    def __exit__(self, *exc) -> None:
        self.module.label_factory = self.real
        for h in self.hooks:
            h.remove()
