"""VOC -> COCO label-space remapping for the coco-voc incremental protocol
(a copy of ``cl4wsis_tpu/data/cocovoc.py``).

Re-design of reference ``data/make_cocovoc.py:104-152`` (offline PNG remap)
and ``dataset/voc.py`` VOCasCOCOSegmentationIncremental: step 1 of coco-voc
trains on VOC images whose class ids live in COCO's 91-id space. Instead of
an offline remapped copy of the dataset, the remap happens at annotation
load (`as_coco=True` on the SBD-json dataset); the offline script is still
provided for parity:

    python -m cl4wsis_tpu_torch.data.cocovoc <in_dir> <out_dir>
"""

from __future__ import annotations

import os
import sys

import numpy as np

# VOC class id (1..20) -> COCO category id (reference data/make_cocovoc.py:104)
COCO_MAP = {
    0: 0, 1: 5, 2: 2, 3: 16, 4: 9, 5: 44, 6: 6, 7: 3, 8: 17, 9: 62, 10: 21,
    11: 67, 12: 18, 13: 19, 14: 4, 15: 1, 16: 64, 17: 20, 18: 63, 19: 7,
    20: 72, 255: 255,
}

VOC_TO_COCO_LUT = np.zeros((256,), np.uint8)
for k, v in COCO_MAP.items():
    VOC_TO_COCO_LUT[k] = v


def remap_voc_dir(in_dir: str, out_dir: str) -> int:
    """Offline remap of VOC segmentation PNGs into the COCO label space
    (SegmentationClassAugAsCoco equivalent). Returns #files written."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(in_dir)):
        if not name.endswith(".png"):
            continue
        lbl = np.asarray(Image.open(os.path.join(in_dir, name)))
        Image.fromarray(VOC_TO_COCO_LUT[lbl]).save(
            os.path.join(out_dir, name), "PNG")
        n += 1
    return n


if __name__ == "__main__":
    print(remap_voc_dir(sys.argv[1], sys.argv[2]), "files remapped")
