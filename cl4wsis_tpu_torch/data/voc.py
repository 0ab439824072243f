"""VOC/SBD instance segmentation dataset with incremental CL wrappers
(counterpart of ``cl4wsis_tpu/data/voc.py``).

Re-design of reference ``dataset/voc.py`` (VOCInstanceSegmentation +
VOCInstanceSegmentationIncremental) and ``dataset/dataset.py``
(IncrementalInstanceSegmentationDataset): COCO-json SBD annotations
(`pascal_sbd_{train,val}.json`), overlap/disjoint image filtering, masking
of annotations to the current task's new classes, 256-entry label remap LUT,
and one-hot image-label selection masking old classes.

Output contract (numpy, HWC; the samples never touch the card, so a
data-loader worker process needs no CUDA):
  train sample: image (H,W,3) f32 normalized, seg (H,W) i32 remapped,
    inst (H,W) i32 dense ids (non-task instances dropped), l1h (C_tot-1,)
  eval sample: image (1,h,w,3), seg (H,W), gt_masks (K,H,W) bool,
    gt_labels (K,) remapped-1 (0-based thing classes), fname

One change of idiom: a train sample's augmentation stream is keyed on
(seed, epoch, index), and the epoch comes with the index
(``dataset[(epoch, index)]``; a bare index is epoch 0). The JAX dataset
takes the epoch from an attribute its loader sets; a DataLoader worker
holds its own copy of the dataset and would never see that attribute
change.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from PIL import Image

from cl4wsis_tpu_torch.data.cocojson import CocoJson
from cl4wsis_tpu_torch.data.transforms import (Compose, normalize_image,
                                               train_transform, val_transform)

VOC_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def _has_valid_annotation(anno: List[Dict]) -> bool:
    if len(anno) == 0:
        return False
    if all(any(o <= 1 for o in obj["bbox"][2:]) for obj in anno):
        return False
    return "keypoints" not in anno[0]


def check_if_insert(anno: List[Dict], overlap: bool, seen_classes, new_classes,
                    is_train: bool = True) -> bool:
    """Reference ``dataset/voc.py:199-216``."""
    if not is_train:
        return True
    if overlap:
        return any(a["category_id"] in new_classes for a in anno)
    is_new = False
    for a in anno:
        if a["category_id"] in new_classes:
            is_new = True
        if a["category_id"] not in seen_classes:
            return False
    return is_new


class VOCInstanceSegmentation:
    """Raw SBD-json dataset (reference ``dataset/voc.py:217-330``)."""

    def __init__(self, data_dir: str, ann_file: str, old_classes: List[int],
                 new_classes: List[int], is_train: bool = True,
                 overlap: bool = True, masking: bool = True,
                 as_coco: bool = False, pseudo: Optional[str] = None):
        self.coco = CocoJson(ann_file)
        self.data_dir = data_dir
        self.pseudo = pseudo  # precomputed pseudo-label set name
        self.root = os.path.join(data_dir, "voc", "JPEGImages")
        self.is_train = is_train
        self.old_classes = old_classes
        self.new_classes = new_classes
        self.masking = masking
        self.n_l1h = 91 if as_coco else 20
        if as_coco:
            # remap annotation category ids into the COCO label space
            # (coco-voc step 1; reference VOCasCOCOSegmentationIncremental)
            from cl4wsis_tpu_torch.data.cocovoc import COCO_MAP
            for ann in self.coco.anns.values():
                ann["category_id"] = COCO_MAP[ann["category_id"]]

        ids = []
        for img_id in sorted(self.coco.get_img_ids()):
            anno = self.coco.loadAnns(self.coco.getAnnIds(img_id, iscrowd=False))
            if _has_valid_annotation(anno):
                if check_if_insert(anno, overlap, new_classes + old_classes,
                                   new_classes, is_train):
                    ids.append(img_id)
        self.indices = ids

    def __len__(self):
        return len(self.indices)

    def _load_image(self, img_id: int):
        info = self.coco.loadImgs(img_id)[0]
        path = info["file_name"]
        return Image.open(os.path.join(self.root, path)).convert("RGB"), path

    def __getitem__(self, index: int):
        img_id = self.indices[index]
        img, path = self._load_image(img_id)
        anno = self.coco.loadAnns(self.coco.getAnnIds(img_id))
        if self.is_train:
            if self.masking:  # only current-task (new-class) annotations
                anno = [a for a in anno if a["category_id"] in self.new_classes]
            seg = np.max(np.stack([self.coco.annToMask(a) * a["category_id"]
                                   for a in anno]), axis=0).astype(np.uint8)
            inst = np.max(np.stack([self.coco.annToMask(a) * (i + 1)
                                    for i, a in enumerate(anno)]), axis=0
                          ).astype(np.uint8)
            l1h = np.zeros((self.n_l1h,), np.float32)
            cats = np.unique([a["category_id"] for a in anno]).astype(int)
            l1h[cats - 1] = 1
            if self.pseudo is not None:
                # precomputed pseudo instance labels substitute seg + inst
                # (reference dataset/voc.py:159-169,305-320):
                # data/voc/{pseudo}/ins_seg_{pseudo}/{name}.npy with
                # dict(mask=(K,H,W) bool, class=(K,) 0-based thing classes)
                name = os.path.splitext(os.path.basename(path))[0]
                npy = np.load(os.path.join(
                    self.data_dir, "voc", self.pseudo,
                    f"ins_seg_{self.pseudo}", f"{name}.npy"),
                    allow_pickle=True).item()
                masks = npy["mask"].astype(np.uint8)
                seg = np.max(np.stack([m * (int(c) + 1) for m, c in
                                       zip(masks, npy["class"])]), axis=0
                             ).astype(np.uint8)
                inst = np.max(np.stack([m * (i + 1) for i, m in
                                        enumerate(masks)]), axis=0
                              ).astype(np.uint8)
            return img, seg, inst, l1h, path
        seg = np.max(np.stack([self.coco.annToMask(a) * a["category_id"]
                               for a in anno]), axis=0).astype(np.uint8)
        masks = np.stack([self.coco.annToMask(a) for a in anno]).astype(bool)
        labels = np.array([a["category_id"] for a in anno], np.int32)
        return img, seg, masks, labels, path


class IncrementalInstanceDataset(torch.utils.data.Dataset):
    """CL wrapper: remap LUT + l1h selection (reference
    ``dataset/dataset.py:110-284``). Indexed by ``(epoch, index)`` or by a
    bare index (epoch 0)."""

    def __init__(self, dataset, step_dict: Dict[int, List[int]], step: int,
                 train: bool = True, transform: Optional[Compose] = None,
                 masking: bool = True, masking_value: int = 0, seed: int = 0):
        self.dataset = dataset
        self.train = train
        self.transform = transform
        self.step = step
        self.seed = seed

        self.order = [c for s in sorted(step_dict) for c in step_dict[s]]
        if step > 0:
            self.labels = [self.order[0]] + list(step_dict[step])
        else:
            self.labels = list(step_dict[step])
        self.labels_old = [lbl for s in range(step) for lbl in step_dict[s]]
        self.tot_classes = len(self.order)

        inverted = {lb: self.order.index(lb) for lb in self.order}
        inverted[255] = masking_value if train else 255
        if masking:
            mapping_dict = {x: inverted[x] for x in self.labels + [255]}
        else:
            mapping_dict = inverted
        self.mapping = np.zeros((256,), np.int32)
        for k, v in mapping_dict.items():
            self.mapping[k] = v

        # l1h selection (reference LabelSelection, dataset.py:269-284)
        order = np.array([c for c in self.order if c != 0]) - 1
        self.l1h_order = order
        if masking:
            self.l1h_mask = np.zeros((len(order),), np.float32)
            self.l1h_mask[-(len(self.labels) - 1):] = 1
        else:
            self.l1h_mask = np.ones((len(order),), np.float32)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key: Union[int, Tuple[int, int]]):
        epoch, index = key if isinstance(key, tuple) else (0, key)
        if self.train:
            img, seg, inst, l1h_raw, path = self.dataset[index]
            lbl = np.stack([seg, inst], axis=-1).astype(np.uint8)
            # (seed, epoch, index)-keyed stream: fresh transforms every
            # epoch, identical across runs, processes and PYTHONHASHSEED
            rng = np.random.RandomState(np.random.MT19937(
                np.random.SeedSequence((self.seed, int(epoch), index))))
            if self.transform is not None:
                img, lbl_pil = self.transform(img, Image.fromarray(lbl), rng)
                lbl = np.asarray(lbl_pil)
            image = normalize_image(img)
            seg = self.mapping[lbl[..., 0]].astype(np.int32)
            inst = lbl[..., 1].astype(np.int32)
            inst = inst * (seg > 0)  # drop instances outside the task
            l1h = (l1h_raw[self.l1h_order] * self.l1h_mask).astype(np.float32)
            return {"image": image, "seg": seg, "inst": _dense_ids(inst),
                    "l1h": l1h, "fname": path}
        img, seg, masks, labels, path = self.dataset[index]
        lbl = Image.fromarray(seg)
        rng = np.random.RandomState(0)
        if self.transform is not None:
            img, lbl = self.transform(img, lbl, rng)
        image = normalize_image(img)
        seg_remap = self.mapping[np.asarray(lbl)].astype(np.int32)
        gt_labels = self.mapping[labels] - 1  # 0-based thing classes
        return {"image": image[None], "seg": seg_remap,
                "gt_masks": masks, "gt_labels": gt_labels.astype(np.int32),
                "fname": path}


def _dense_ids(inst: np.ndarray) -> np.ndarray:
    """Relabel instance ids to dense 1..K (device labelgen contract)."""
    ids = np.unique(inst)
    ids = ids[(ids != 0) & (ids != 255)]
    out = np.zeros_like(inst)
    for k, i in enumerate(ids, start=1):
        out[inst == i] = k
    return out


def make_voc_datasets(data_root: str, step_dict: Dict[int, List[int]],
                      step: int, crop_size: int = 512,
                      crop_size_val: Optional[int] = 512,
                      overlap: bool = True, masking: bool = True,
                      as_coco: bool = False, pseudo: Optional[str] = None,
                      val_on_trainset: bool = False, seed: int = 0):
    """Factory mirroring reference ``dataset/__init__.py:9-72`` for VOC
    (and coco-voc step 1 with as_coco=True). `val_on_trainset` evaluates on
    the train split (reference test_on_train protocol)."""
    labels, labels_old = (list(step_dict[step]),
                          [lb for s in range(step) for lb in step_dict[s]])
    new_classes = [c for c in labels if c != 0]
    old_classes = [c for c in labels_old if c != 0]
    train_raw = VOCInstanceSegmentation(
        data_root, os.path.join(data_root, "voc", "pascal_sbd_train.json"),
        old_classes, new_classes, is_train=True, overlap=overlap,
        masking=masking, as_coco=as_coco, pseudo=pseudo)
    val_json = "pascal_sbd_train.json" if val_on_trainset else "pascal_sbd_val.json"
    val_raw = VOCInstanceSegmentation(
        data_root, os.path.join(data_root, "voc", val_json),
        old_classes, new_classes, is_train=False, overlap=overlap,
        masking=False, as_coco=as_coco)
    train = IncrementalInstanceDataset(
        train_raw, step_dict, step, train=True,
        transform=train_transform(crop_size), masking=masking, seed=seed)
    val = IncrementalInstanceDataset(
        val_raw, step_dict, step, train=False,
        transform=val_transform(crop_size_val), masking=False)
    return train, val
