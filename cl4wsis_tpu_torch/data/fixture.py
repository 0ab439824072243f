"""The painted mini-VOC of the fixture protocol (the port's own copy of the
JAX package's test fixture writer, ``tests/test_data.py``: the same
images, annotations and JSON from the same ``RandomState(0)`` draws).

    write_fake_voc(root, n_images=48, size=64, rich=True, wrap=True,
                   paint=True)

writes ``root/voc/JPEGImages/img_NNN.jpg`` and
``root/voc/pascal_sbd_{train,val}.json`` (both splits hold every image),
the layout ``data/voc.make_voc_datasets`` reads under ``--data_root root``.
``scripts/run_rebuild_fixture_torch.py`` and ``chip_smoke.py`` train on it.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image


def palette(c):
    """Deterministic class-keyed RGB fill for painted fixtures."""
    return np.array([(c * 37) % 200 + 55, (c * 91) % 200 + 55,
                     (c * 151) % 200 + 55], np.uint8)


def write_fake_voc(root, n_images=6, size=48, rich=False, wrap=False,
                   paint=False):
    """Tiny VOC/SBD fixture: images + COCO-style polygon annotations for
    classes 1 (old) and 16 (new in 15-5). With ``rich=True`` every image
    carries one of new classes 16..20 and one of old classes 1..15, both
    round-robin, so all 20 classes appear. ``wrap=True`` keeps object
    positions on the image for large `n_images` (the default 4+3i walk
    runs off a 64^2 canvas past ~15 images).

    ``paint=True`` makes the task learnable: objects are drawn into the
    image in class-keyed colours over a gray-noise background, and the two
    objects of a rich image are vertically separated instead of stacked.
    Without it the images are pure noise: structurally valid for pipeline
    tests, but training on them can never reach a nonzero mAP."""
    img_dir = os.path.join(root, "voc", "JPEGImages")
    os.makedirs(img_dir, exist_ok=True)
    rs = np.random.RandomState(0)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        name = f"img_{i:03d}.jpg"
        if paint:
            arr = (rs.rand(size, size, 3) * 40 + 100).astype(np.uint8)
        else:
            arr = (rs.rand(size, size, 3) * 255).astype(np.uint8)
        images.append({"id": i + 1, "file_name": name,
                       "height": size, "width": size})
        # one class-16 object everywhere; class-1 object on even images
        # (rich: round-robin new 16..20 and old 1..15 so all 20 exist)
        if rich:
            cats = [16 + i % 5, (i % 15) + 1]
        else:
            cats = [16] + ([1] if i % 2 == 0 else [])
        # paint mode scales objects with the canvas (an OS-16 backbone sees
        # size/16 cells; fixed 16-px objects vanish at larger fixtures)
        sc = max(1, size // 64) if paint else 1
        ow = 16 * sc
        x0 = 4 + ((3 * i) % max(size - 12 - ow, 1) if wrap else 3 * i)
        for k, c in enumerate(cats):
            y0 = (size // 2 + 2) if (paint and k == 1) else 4
            oh = (16 + c % 7) * sc
            y1 = y0 + oh
            poly = [x0, y0, x0 + ow, y0, x0 + ow, y1, x0, y1]
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": c,
                "segmentation": [poly], "iscrowd": 0,
                "bbox": [x0, y0, ow, oh], "area": ow * oh})
            ann_id += 1
            if paint:
                block = (palette(c)[None, None, :].astype(np.int32)
                         + rs.randint(-12, 13, (oh, ow, 3)))
                arr[y0:y1, x0:x0 + ow] = np.clip(block, 0, 255)
        Image.fromarray(arr).save(os.path.join(img_dir, name))
    body = {"images": images, "annotations": annotations,
            "categories": [{"id": c, "name": str(c)} for c in range(1, 21)]}
    for split in ("train", "val"):
        with open(os.path.join(root, "voc", f"pascal_sbd_{split}.json"),
                  "w") as f:
            json.dump(body, f)
