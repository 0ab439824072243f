"""Build the reference's modules from a configuration file's sizes, and the
precisions they run in: float32 with TF32 off, or the control's float8."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
from torch import nn
import torch.nn.functional as F

from .assembly import make_model
from .wss import PeakGenerator, PseudoLabeler

FP8_MAX = 448.0    # the largest finite float8_e4m3fn


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 matmuls and convolutions in full float32 while inside."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded through float8 e4m3 under one per-tensor scale (its
    largest magnitude maps to 448), back in x's dtype; the gradient passes
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def bf16(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded through bfloat16, back in x's dtype; the gradient passes
    straight through."""
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


class Bf16Conv2d(nn.Conv2d):
    """A convolution that rounds its input, weight and output through
    bfloat16, as autocast's bfloat16 convolutions do (a witness of what
    bfloat16 itself costs, not the control)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bf16(F.conv2d(bf16(x), bf16(self.weight), self.bias,
                             self.stride, self.padding, self.dilation,
                             self.groups))


class Fp8Conv2d(nn.Conv2d):
    """A convolution whose input and weight are rounded to float8 first:
    the control, the next precision below the configuration's bfloat16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(fp8(x), fp8(self.weight), self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


def set_precision(module: nn.Module, precision: str) -> nn.Module:
    """"fp32": as built; "bf16" / "fp8": every convolution becomes a
    Bf16Conv2d / Fp8Conv2d."""
    cls = {"fp32": None, "bf16": Bf16Conv2d, "fp8": Fp8Conv2d}[precision]
    if cls is not None:
        for m in module.modules():
            if type(m) is nn.Conv2d:
                m.__class__ = cls
    return module


def model(cfg: Dict, classes) -> nn.Module:
    """The CL4WSIS model of `cfg` for the per-step class counts `classes`."""
    return make_model(tuple(classes), cfg["backbone"], cfg["output_stride"],
                      cfg["crop_size"],
                      backbone_structure=tuple(cfg["blocks"]))


def phase2_modules(cfg: Dict) -> Dict[str, nn.Module]:
    """The phase-2 step's four modules, keyed as the benchmark's weights
    are: the model of every step, the previous step's model, the
    PseudoLabeler and the PeakGenerator."""
    classes = cfg["classes"]
    old, tot = sum(classes[:-1]), sum(classes)
    return {"model": model(cfg, classes),
            "old": model(cfg, classes[:-1]),
            "pl": PseudoLabeler(tot, in_channels=cfg["body_channels"]),
            "pg": PeakGenerator(tot - 1, old - 1)}
