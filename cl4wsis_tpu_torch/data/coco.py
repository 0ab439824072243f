"""COCO thing-only dataset for coco offline and coco-voc step 0
(counterpart of ``cl4wsis_tpu/data/coco.py``).

Re-design of reference ``dataset/coco.py``: instances_{train,val}2017 json,
split txt files, seg map as max over annToMask * category_id, instance-id
mask, 91-dim image-level one-hot. Same output contract as data/voc.py;
wrapped by IncrementalInstanceDataset for the CL remapping.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from cl4wsis_tpu_torch.data.cocojson import CocoJson
from cl4wsis_tpu_torch.data.transforms import train_transform, val_transform
from cl4wsis_tpu_torch.data.voc import (IncrementalInstanceDataset,
                                        _has_valid_annotation)

# categories absent from COCO's 91-id space (reference dataset/coco.py:8)
IGNORE_LABELS = [12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91]


class COCODataset:
    def __init__(self, root: str, train: bool = True,
                 indices: Optional[np.ndarray] = None):
        ds_root = os.path.join(os.path.expanduser(root), "coco")
        split = "train" if train else "val"
        folder = f"{split}2017"
        ann_f = os.path.join(ds_root, "annotations", f"instances_{folder}.json")
        split_f = os.path.join(ds_root, "split", f"{split}.txt")

        self.ds_root = ds_root
        self.folder = folder
        self.is_train = train
        self.coco = CocoJson(ann_f)

        with open(split_f) as f:
            files = {line.strip() + ".jpg" for line in f}

        ids: List[int] = []
        for img_id in sorted(self.coco.get_img_ids()):
            anno = self.coco.loadAnns(self.coco.getAnnIds(img_id, iscrowd=False))
            if _has_valid_annotation(anno) and \
                    self.coco.imgs[img_id]["file_name"] in files:
                ids.append(img_id)
        if indices is not None:
            ids = [ids[i] for i in indices]
        self.indices = ids

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, index: int):
        img_id = self.indices[index]
        info = self.coco.loadImgs(img_id)[0]
        img = Image.open(os.path.join(self.ds_root, "images", self.folder,
                                      info["file_name"])).convert("RGB")
        anno = self.coco.loadAnns(self.coco.getAnnIds(img_id))
        seg = np.max(np.stack([self.coco.annToMask(a) * a["category_id"]
                               for a in anno]), axis=0).astype(np.uint8)
        if not self.is_train:
            masks = np.stack([self.coco.annToMask(a) for a in anno]).astype(bool)
            labels = np.array([a["category_id"] for a in anno], np.int32)
            return img, seg, masks, labels, info["file_name"]
        inst = np.max(np.stack([self.coco.annToMask(a) * (i + 1)
                                for i, a in enumerate(anno)]), axis=0
                      ).astype(np.uint8)
        l1h = np.zeros((91,), np.float32)
        cats = np.unique([a["category_id"] for a in anno]).astype(int)
        l1h[cats - 1] = 1
        return img, seg, inst, l1h, info["file_name"]


def make_coco_datasets(data_root: str, step_dict: Dict[int, List[int]],
                       step: int, crop_size: int = 448,
                       crop_size_val: Optional[int] = 512,
                       train_indices: Optional[np.ndarray] = None,
                       seed: int = 0):
    """Factory for coco / coco-voc step 0 (reference dataset/__init__.py)."""
    train_raw = COCODataset(data_root, train=True, indices=train_indices)
    val_raw = COCODataset(data_root, train=False)
    train = IncrementalInstanceDataset(
        train_raw, step_dict, step, train=True,
        transform=train_transform(crop_size), masking=True, seed=seed)
    val = IncrementalInstanceDataset(
        val_raw, step_dict, step, train=False,
        transform=val_transform(crop_size_val), masking=False)
    return train, val
