"""Weights drawn on the device from the run's seed, in one call, for the
state-dict layout of the reference's modules (which the port shares key
for key): every convolution weight normal with std 1 / sqrt(fan in) (the
lecun-normal family of the port's default start), every 1-D weight and
running variance 1, every bias and running mean 0."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...]]]


def spec_of(modules: Dict[str, torch.nn.Module]) -> Spec:
    """(prefixed key, shape) of every state-dict entry, in a fixed order."""
    return [(f"{prefix}.{k}", tuple(v.shape))
            for prefix, m in modules.items()
            for k, v in m.state_dict().items()]


def seeded_state(spec: Spec, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The weights of `spec` from `seed`, float32 on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [(k, s) for k, s in spec if len(s) == 4]
    flat = torch.randn(sum(math.prod(s) for _, s in drawn), generator=gen,
                       device=device)
    out, at = {}, 0
    for k, s in drawn:
        n = math.prod(s)
        out[k] = flat[at:at + n].view(s) * (math.prod(s[1:]) ** -0.5)
        at += n
    for k, s in spec:
        if len(s) == 4:
            continue
        last = k.rsplit(".", 1)[-1]
        ones = last in ("weight", "running_var")
        if last not in ("weight", "bias", "running_var", "running_mean"):
            raise ValueError(f"no rule draws {k} {s}")
        out[k] = (torch.ones if ones else torch.zeros)(s, device=device)
    return out


def split(state: Dict[str, torch.Tensor], prefix: str
          ) -> Dict[str, torch.Tensor]:
    """One module's entries of `state`, without their prefix."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in state.items() if k.startswith(p)}


def sub_seed(seed: int, what: str) -> int:
    """A seed of its own for each use of the run's seed (64-bit, stable
    across processes)."""
    h = 1469598103934665603
    for ch in f"{seed}/{what}".encode():
        h = ((h ^ ch) * 1099511628211) % 2 ** 64
    return h % 2 ** 63
