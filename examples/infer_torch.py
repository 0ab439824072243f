"""Inference example of the PyTorch port: load a checkpoint, predict
instances, export COCO json (the counterpart of ``examples/infer.py``).

Run: python examples/infer_torch.py <checkpoint> <image.jpg> [--device cpu]
     [--backbone resnet101] [--crop_size 512] [--out predictions.json]
(on the card unless --device cpu; the checkpoint is a VOC 15-5 step-1 one,
classes (16, 5), as the trainer writes it).
"""

import argparse
import json
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cl4wsis_tpu_torch.serve import Predictor  # noqa: E402


def main(ckpt: str, image_path: str, device: str = "cuda",
         backbone: str = "resnet101", crop_size: int = 512,
         out: str = "predictions.json") -> list:
    predictor = Predictor.from_checkpoint(ckpt, classes=(16, 5),
                                          backbone=backbone,
                                          crop_size=crop_size, device=device)
    img = np.asarray(Image.open(image_path).convert("RGB"))
    result = predictor(img)
    for inst in result.instances():
        print(f"class={inst['label']} score={inst['score']:.3f} "
              f"area={int(inst['mask'].sum())}")
    coco = result.to_coco(image_id=0)
    with open(out, "w") as f:
        json.dump(coco, f)
    print(f"wrote {out}")
    return coco


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("image")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--crop_size", type=int, default=512)
    ap.add_argument("--out", default="predictions.json")
    a = ap.parse_args()
    main(a.ckpt, a.image, a.device, a.backbone, a.crop_size, a.out)
