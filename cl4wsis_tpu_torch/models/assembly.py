"""Model assembly: backbone + DeepLab-v3 seg branch + instance branch
(counterpart of ``cl4wsis_tpu/models/assembly.py``), NCHW.

``state_dict()`` has the upstream key layout that
``cl4wsis_tpu/cl/ckpt.py::convert_torch_cl4wsis`` reads: ``body.*``,
``head.*``, ``cls.{i}``, ``decoder.instance_decoder.*`` and
``instance_head.classifier.{center,offset}.*``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from cl4wsis_tpu_torch.core.norms import norm_factory
from cl4wsis_tpu_torch.models.deeplab import (DeepLabV3Head,
                                              IncrementalClassifier)
from cl4wsis_tpu_torch.models.panoptic import (IncrementalInstanceHead,
                                               PanopticDecoder)
from cl4wsis_tpu_torch.models.resnet import ResNet
from cl4wsis_tpu_torch.ops.resize import resize_bilinear

# bottleneck ResNets only; the basic-block nets and WideResNet-38 come later
_RESNET_STRUCTURES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


class CL4WSISModel(nn.Module):
    """Incremental instance segmentation model.

    classes: per-step class counts, e.g. (16, 5) for VOC 15-5 step 1 (step
    0 includes background). pooling_size: eval-time ASPP window =
    crop // output_stride. backbone_structure overrides the block counts
    (e.g. (1, 1, 1, 1) for tiny test nets).
    """

    def __init__(self, classes: Sequence[int], backbone: str = "resnet101",
                 output_stride: int = 16, pooling_size: Optional[int] = 32,
                 has_instance: bool = True, norm_act: str = "iabn_sync",
                 backbone_structure: Optional[Sequence[int]] = None):
        super().__init__()
        if backbone not in _RESNET_STRUCTURES:
            raise NotImplementedError(f"backbone {backbone!r} is not ported")
        self.classes = tuple(classes)
        self.has_instance = has_instance
        norm = norm_factory(norm_act)
        structure = tuple(backbone_structure or _RESNET_STRUCTURES[backbone])
        self.body = ResNet(structure, output_stride, norm)
        self.head = DeepLabV3Head(self.body.out_channels, 256, 256,
                                  output_stride, pooling_size, norm)
        self.cls = IncrementalClassifier(256, self.classes)
        if has_instance:
            feats = {"res2": 256, "res3": 512, "res4": 1024,
                     "res5": self.body.out_channels}
            self.decoder = nn.Module()
            self.decoder.instance_decoder = PanopticDecoder(feats)
            center_classes = list(self.classes)
            center_classes[0] -= 1  # background has no center channel
            self.instance_head = IncrementalInstanceHead(128, center_classes)

    @property
    def tot_classes(self) -> int:
        return sum(self.classes)

    def forward(self, x: torch.Tensor, interpolate: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x: (B, 3, H, W) normalised images -> dict of NCHW predictions:
        seg (C+1 logits), and with the instance branch center (C) and
        offset (2); at the network's strides (seg at the output stride,
        center and offset at 1/4) unless `interpolate`. In train mode the
        decoder's dropout draws from `generator`."""
        features = self.body(x)
        pred = {"seg": self.cls(self.head(features["res5"]))}
        if self.has_instance:
            pred.update(self.forward_instance(features, generator))
        return _upsample(pred, x.shape[2:]) if interpolate else pred

    def forward_features(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The backbone alone: dict(res1..res5)."""
        return self.body(x)

    def forward_instance(self, features: Dict[str, torch.Tensor],
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
        """Instance decoder and head on given backbone features; in train
        mode the decoder's dropout draws from `generator`."""
        dec = self.decoder.instance_decoder(features, generator)
        return self.instance_head(dec)

    def forward_seg(self, x: torch.Tensor, interpolate: bool = True
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
        """The semantic branch only: ({"seg"}, {"body": res5,
        "features": all backbone features})."""
        features = self.body(x)
        pred = {"seg": self.cls(self.head(features["res5"]))}
        if interpolate:
            pred = _upsample(pred, x.shape[2:])
        return pred, {"body": features["res5"], "features": features}


def _upsample(pred: Dict[str, torch.Tensor], size) -> Dict[str, torch.Tensor]:
    # final predictions upsample with align_corners=True, as upstream
    return {k: resize_bilinear(v, size, align_corners=True)
            for k, v in pred.items()}


def make_model(classes: Sequence[int], backbone: str = "resnet101",
               output_stride: int = 16, crop_size: int = 512,
               branch: str = "ins", norm_act: str = "iabn_sync",
               backbone_structure: Optional[Sequence[int]] = None
               ) -> CL4WSISModel:
    """Factory with the arguments of the JAX ``make_model``."""
    return CL4WSISModel(classes, backbone, output_stride,
                        pooling_size=crop_size // output_stride,
                        has_instance=(branch == "ins"), norm_act=norm_act,
                        backbone_structure=backbone_structure)
