"""Minimal COCO annotation database, a pycocotools.coco.COCO replacement
(a copy of ``cl4wsis_tpu/data/cocojson.py``).

Covers what the reference datasets use: ann/img indexing, getAnnIds with
iscrowd filtering, loadAnns/loadImgs, annToMask
(``dataset/voc.py:240-305``, ``dataset/coco.py:59-107``).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from cl4wsis_tpu_torch.data.maskrle import ann_to_mask


class CocoJson:
    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            self.dataset = json.load(f)
        self.anns: Dict[int, Dict] = {}
        self.imgs: Dict[int, Dict] = {}
        self.cats: Dict[int, Dict] = {}
        self.img_to_anns: Dict[int, List[Dict]] = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def getImgIds(self) -> List[int]:
        return self.get_img_ids()

    def getAnnIds(self, imgIds: Union[int, Sequence[int]],
                  iscrowd: Optional[bool] = None) -> List[int]:
        if isinstance(imgIds, int):
            imgIds = [imgIds]
        anns = [a for i in imgIds for a in self.img_to_anns.get(i, [])]
        if iscrowd is not None:
            anns = [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]
        return [a["id"] for a in anns]

    def loadAnns(self, ids: Sequence[int]) -> List[Dict]:
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids: Union[int, Sequence[int]]) -> List[Dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def annToMask(self, ann: Dict) -> np.ndarray:
        img = self.imgs[ann["image_id"]]
        return ann_to_mask(ann, img["height"], img["width"])
