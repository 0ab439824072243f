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
from cl4wsis_tpu_torch.models.wide_resnet import (WRN38_STRUCTURE,
                                                  WiderResNet38A2)
from cl4wsis_tpu_torch.ops.resize import resize_bilinear

# structure, bottleneck? (upstream models/resnet.py:126-138)
_RESNET_STRUCTURES = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}
_WIDE_STRUCTURES = {"wider_resnet38_a2": WRN38_STRUCTURE}


def backbone_channels(backbone: str) -> int:
    """The channels of a backbone's res5."""
    if "wide" in backbone:
        return 4096
    if backbone in _RESNET_STRUCTURES and not _RESNET_STRUCTURES[backbone][1]:
        return 512  # basic-block nets (18/34)
    return 2048


class CL4WSISModel(nn.Module):
    """Incremental instance segmentation model.

    classes: per-step class counts, e.g. (16, 5) for VOC 15-5 step 1 (step
    0 includes background). pooling_size: eval-time ASPP window =
    crop // output_stride. backbone_structure overrides the block counts
    (four for a ResNet, e.g. (1, 1, 1, 1) for tiny test nets; six for
    WideResNet-38, whose output stride is always 8). detach_instance:
    ``forward`` gives the instance branch detached backbone features, so
    its loss trains no backbone weight. remat: each backbone block's
    activations are recomputed in the backward.
    """

    def __init__(self, classes: Sequence[int], backbone: str = "resnet101",
                 output_stride: int = 16, pooling_size: Optional[int] = 32,
                 has_instance: bool = True, norm_act: str = "iabn_sync",
                 backbone_structure: Optional[Sequence[int]] = None,
                 detach_instance: bool = False, remat: bool = False):
        super().__init__()
        self.classes = tuple(classes)
        self.has_instance = has_instance
        self.detach_instance = detach_instance
        norm = norm_factory(norm_act)
        if backbone in _RESNET_STRUCTURES:
            structure, bottleneck = _RESNET_STRUCTURES[backbone]
            self.body = ResNet(tuple(backbone_structure or structure),
                               output_stride, norm, bottleneck, remat)
        elif backbone in _WIDE_STRUCTURES:
            self.body = WiderResNet38A2(
                tuple(backbone_structure or _WIDE_STRUCTURES[backbone]),
                norm, remat)
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        self.head = DeepLabV3Head(self.body.out_channels, 256, 256,
                                  output_stride, pooling_size, norm)
        self.cls = IncrementalClassifier(256, self.classes)
        if has_instance:
            self.decoder = nn.Module()
            self.decoder.instance_decoder = PanopticDecoder(
                self.body.feature_channels)
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
        center and offset at res2's: 1/4 on a ResNet, 1/8 on WideResNet-38)
        unless `interpolate`. In train mode the dropout of the body (if it
        has any) and of the decoder draws from `generator`."""
        features = self.body(x, generator)
        pred = {"seg": self.cls(self.head(features["res5"]))}
        if self.has_instance:
            ins_feats = ({k: v.detach() for k, v in features.items()}
                         if self.detach_instance else features)
            pred.update(self.forward_instance(ins_feats, generator))
        return _upsample(pred, x.shape[2:]) if interpolate else pred

    def forward_features(self, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
        """The backbone alone: dict(res1..res5); in train mode its dropout
        draws from `generator`."""
        return self.body(x, generator)

    def forward_instance(self, features: Dict[str, torch.Tensor],
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
        """Instance decoder and head on given backbone features; in train
        mode the decoder's dropout draws from `generator`."""
        dec = self.decoder.instance_decoder(features, generator)
        return self.instance_head(dec)

    def forward_seg(self, x: torch.Tensor, interpolate: bool = True,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
        """The semantic branch only: ({"seg"}, {"body": res5,
        "features": all backbone features}); in train mode the body's
        dropout draws from `generator`."""
        features = self.body(x, generator)
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
               branch: str = "ins", detach_instance: bool = False,
               norm_act: str = "iabn_sync", remat: bool = False,
               backbone_structure: Optional[Sequence[int]] = None
               ) -> CL4WSISModel:
    """Factory with the arguments of the JAX ``make_model``."""
    return CL4WSISModel(classes, backbone, output_stride,
                        pooling_size=crop_size // output_stride,
                        has_instance=(branch == "ins"), norm_act=norm_act,
                        backbone_structure=backbone_structure,
                        detach_instance=detach_instance, remat=remat)
