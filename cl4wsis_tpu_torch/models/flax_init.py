"""flax's init families for the port's fresh layers (``--torch_init false``,
the default of both packages' CLI).

The JAX package's layers start in flax's defaults: every conv and dense
kernel from ``variance_scaling(1.0, "fan_in", "truncated_normal")``, a
standard normal truncated to [-2, 2] and scaled by
``sqrt(1 / fan_in) / 0.87962566103423978`` (so that its std is
``sqrt(1 / fan_in)``), and every bias zero. Its ``--torch_init true``
re-draws them in torch's families (``models/torch_init.py`` there). The
port's layers are built in torch's families, so this module goes the
other way: it re-draws every ``nn.Conv2d``/``nn.Linear`` of a module in
flax's.

Skipped are the subtrees whose explicit init is the same in both
packages: the ASPP head ``head.*`` (xavier-normal, ``models/deeplab.py``)
and the PeakGenerator's ``extra_conv4`` (normal(0, sqrt(2 / new)), zero
bias, ``wss/modules.py``). Norm layers keep their ones and zeros.

fan_in is ``in_channels / groups * kh * kw``, the number flax's HWIO
kernel with ``feature_group_count`` gives (1 * 5 * 5 for the Panoptic
decoder's depthwise convolutions).
"""

from __future__ import annotations

import math
from typing import Iterable

import torch
from torch import nn

# the std of a standard normal truncated to (-2, 2)
TRUNC_STD = 0.87962566103423978
# the port's names of the JAX package's torch_init.DEFAULT_SKIP
# ("seg_head", "extra_conv4")
DEFAULT_SKIP = ("head", "extra_conv4")
# erf(+-2 / sqrt(2)): the uniform interval whose erfinv is the standard
# normal truncated to (-2, 2)
_ERF_2 = math.erf(2.0 / math.sqrt(2.0))


def fan_in(weight: torch.Tensor) -> int:
    """Inputs per output unit: (out, in / groups, kh, kw) -> in / groups *
    kh * kw; (out, in) -> in."""
    return weight[0].numel()


def truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """A standard normal truncated to (-2, 2), float32, on `generator`'s
    device, by inverting the CDF as ``jax.random.truncated_normal`` does:
    one uniform draw an element, so that the draws are the same in every
    torch version (``nn.init.trunc_normal_`` changed its algorithm)."""
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(-_ERF_2, _ERF_2, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def flax_family_init(module: nn.Module, generator: torch.Generator,
                     skip: Iterable[str] = DEFAULT_SKIP) -> nn.Module:
    """Re-draw, in place, every conv and linear layer of `module` outside
    the subtrees named in `skip` (matched against any component of the
    layer's dotted name) in flax's families: the kernel truncated-normal
    lecun, the bias zero. Draws come from `generator`, on the module's
    device, in the module's order, and leave torch's global stream
    alone."""
    skip = tuple(skip)
    with torch.no_grad():
        for name, m in module.named_modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)) or any(
                    p in skip for p in name.split(".")):
                continue
            scale = (1.0 / fan_in(m.weight)) ** 0.5 / TRUNC_STD
            m.weight.copy_(truncated_normal(m.weight.shape, generator)
                           .mul_(scale))
            if m.bias is not None:
                m.bias.zero_()
    return module
