"""Inference API (counterpart of ``cl4wsis_tpu/serve.py``).

    predictor = Predictor.from_checkpoint(
        "checkpoints/step/voc-15-5-ov/OURS_1", classes=(16, 5))
    # or, from a model and its weights:
    # predictor = Predictor(make_model((16, 5)), state_dict)
    result = predictor(image_uint8)               # (H, W, 3)
    result.instances()                            # [{label, score, mask}]
    coco = result.to_coco(image_id=1)             # COCO result dicts (RLE)

The predictor runs on the card unless the caller passes ``device="cpu"``;
without a card it raises rather than fall back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from cl4wsis_tpu_torch.cl.ckpt import load_checkpoint
from cl4wsis_tpu_torch.data.maskrle import rle_encode
from cl4wsis_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.train.eval import make_eval_forward

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class InstancePrediction:
    """One image's predictions."""

    ins_map: np.ndarray          # (H, W) int32 slot id, -1 = background
    labels: np.ndarray           # (S,) 0-based thing class per slot
    scores: np.ndarray           # (S,)
    valid: np.ndarray            # (S,) bool
    seg: np.ndarray              # (H, W) semantic map (0 = background)

    def instances(self) -> List[Dict[str, Any]]:
        out = []
        for s in np.nonzero(self.valid)[0]:
            mask = self.ins_map == s
            if mask.any():
                out.append({"label": int(self.labels[s]),
                            "score": float(self.scores[s]), "mask": mask})
        return out

    def to_coco(self, image_id: int,
                category_ids: Optional[Sequence[int]] = None
                ) -> List[Dict[str, Any]]:
        """COCO-format results (uncompressed RLE segmentations)."""
        res = []
        for inst in self.instances():
            cat = (category_ids[inst["label"]] if category_ids is not None
                   else inst["label"] + 1)
            res.append({"image_id": image_id, "category_id": int(cat),
                        "score": inst["score"],
                        "segmentation": rle_encode(
                            inst["mask"].astype(np.uint8))})
        return res


class Predictor:
    """Bucketed inference over a model and its weights."""

    def __init__(self, model: torch.nn.Module,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, *,
                 device: str = "cuda", dtype: str = "bfloat16",
                 val_thresh: float = 0.1, val_kernel: int = 41,
                 beta: float = 3.0, val_flip: bool = False,
                 bucket_multiple: Optional[int] = 64):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor: no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if state_dict is not None:
            model.load_state_dict(state_dict)
        model = model.to(self.device).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.dtype = _DTYPES[dtype]
        self.n_things = model.tot_classes - 1
        self.forward = make_eval_forward(
            model, self.n_things, device=self.device, dtype=self.dtype,
            val_flip=val_flip, val_thresh=val_thresh, val_kernel=val_kernel,
            beta=beta, bucket_multiple=bucket_multiple)

    @classmethod
    def from_checkpoint(cls, path: str, classes: Sequence[int],
                        backbone: str = "resnet101", output_stride: int = 16,
                        crop_size: int = 512, dtype: str = "bfloat16",
                        **kw) -> "Predictor":
        """A predictor over the model of a checkpoint the trainer saved
        (``cl/ckpt.save_checkpoint``), built by ``make_model`` for
        `classes`, `backbone` and `output_stride`, with as many blocks a
        stage as the checkpoint holds (a ``--tiny`` run's too); `kw` go to
        ``Predictor`` (``device``, ``val_flip``, ...)."""
        state = load_checkpoint(path)["model"]
        blocks = tuple(sum(k.startswith(f"body.mod{i}.block") and
                           k.endswith(".convs.conv1.weight") for k in state)
                       for i in range(2, 6))
        model = make_model(classes, backbone, output_stride, crop_size,
                           backbone_structure=blocks)
        return cls(model, state, dtype=dtype, **kw)

    def __call__(self, image: np.ndarray) -> InstancePrediction:
        """image: (H, W, 3) uint8, or float in [0, 1], or pre-normalized."""
        h, w = image.shape[:2]
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        if image.max() > 4.0:  # heuristics: not yet normalized
            image = image / 255.0
        if image.min() >= 0.0:  # normalize if still in [0, 1]
            image = (image - IMAGENET_MEAN) / IMAGENET_STD
        x = torch.from_numpy(np.ascontiguousarray(image[None], np.float32))
        out = self.forward(x, (h, w))
        ins = out["ins_map"].cpu().numpy()
        labels = out["label"].cpu().numpy()
        seg = np.where(ins >= 0, labels[np.clip(ins, 0, None)] + 1, 0)
        return InstancePrediction(
            ins_map=ins, labels=labels, scores=out["score"].cpu().numpy(),
            valid=out["valid"].cpu().numpy(), seg=seg.astype(np.int32))
