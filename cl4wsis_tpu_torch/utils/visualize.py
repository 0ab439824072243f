"""Visualisation helpers: colour maps, label to colour, denormalisation
and the instance sample image (a copy of ``cl4wsis_tpu/utils/visualize.py``,
numpy only).

The full colour-map surface of upstream ``utils/utils.py``: the VOC,
Cityscapes and ADE20K tables and the ``color_map`` dispatcher,
``Label2Color``, ``label_to_color_image`` (the instance palette upstream
``train.py:32`` imports), ``denorm``/``Denormalize`` and
``label_to_one_hot``; ``sample_image`` composes the image and its
instance map as the CLI's ``--sample_num`` writes them.

The ADE20K palette (upstream utils/utils.py:78-239) and the
instance-visualisation table (``_COLORS``, utils/utils.py:280-357, the
public Detectron2 colour map) are published constant tables, embedded as
base64-packed arrays (uint8 RGB rows; milli-unit uint16 for the float
table).

Upstream's ``denorm`` default mean carries a typo (0.4069 for the ImageNet
0.406, utils/utils.py:23); call sites pass explicit values, so the
canonical constant is used.
"""

from __future__ import annotations

import base64

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def denorm(image: np.ndarray) -> np.ndarray:
    """Invert ImageNet normalization; NHWC or HWC."""
    return image * IMAGENET_STD + IMAGENET_MEAN


class Denormalize:
    """Configurable-mean/std inverse normalization (reference
    utils/utils.py:41-51), channel-last."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return image * self.std + self.mean


def label_to_one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """(...,) int -> (..., C) one-hot (reference utils/utils.py:7-10)."""
    return np.eye(num_classes, dtype=np.float32)[labels]


def voc_cmap(n: int = 256, normalized: bool = False) -> np.ndarray:
    """The canonical VOC bit-interleaved colormap."""
    def bitget(v, i):
        return (v >> i) & 1

    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap / 255.0 if normalized else cmap


# 19-class cityscapes palette + trailing void black row
# (reference utils/utils.py:71-75)
CITYSCAPES_CMAP = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32], [0, 0, 0]], np.uint8)


def cityscapes_cmap() -> np.ndarray:
    return CITYSCAPES_CMAP.copy()


# ADE20K 150-class palette (+ leading void black), published table
# (reference utils/utils.py:78-239) packed as 151*3 uint8.
_ADE_B64 = (
    "AAAAeHh4tHh4BubmUDIyBMgDeHhQjIyMzAX/5ubmBPoH4AX/6/8HlgU9eHhGCP8z/wZSj/"
    "+MzP8E/zMHzEYDAGbIPeb6/wYzC2b//wdH/wngCQfm3Nzc/wlccAn/CP/WB//g/7gGCv9H"
    "/ykKB///4P8IZgj//z0G/8IH/3oIAP8U/wgp/wWZBjP/6wz/oJYUAKP/jIyM+goPFP8AH/"
    "8A/x8A/+AAmf8AAAD//0cAAOv/AK3/HwD/C8jI/1IAAP/1AD3/AP9wAP+F/wAA/6MA/2YA"
    "wv8AAI//M/8AAFL/AP8pAP+tCgD/rf8AAP+Z/1wA/wD//wD1/wBm/60A/wAU/7i4AB//AP"
    "89AEf//wDMAP/CAP9SAAr/AHD/MwD/AML/AHr/AP+j/5kAAP8K/3AAj/8AUgD/o/8A/+sA"
    "CLiqhQD/AP9cuAD//wAfALj/ANb//wBwXP8AAOD/cOD/RrigowD/mQD/R/8A/wCj/8wA/w"
    "CPAP/rhf8A/wDr9QD//wB6//UACr7U1v8AAMz/FAD///8AAJn/ACn/AP/MKQD/Kf8ArQD/"
    "APX/RwD/egD/AP+4AFz/uP8AAIX//9YAGcLCZv8AXAD/"
)


def ade_cmap() -> np.ndarray:
    """256-row uint8 colormap, rows 0..150 the ADE20K palette, rest zeros
    (reference utils/utils.py:78-239)."""
    table = np.frombuffer(base64.b64decode(_ADE_B64),
                          np.uint8).reshape(-1, 3)
    cmap = np.zeros((256, 3), np.uint8)
    cmap[: len(table)] = table
    return cmap


def color_map(dataset: str) -> np.ndarray:
    """Dataset-name -> palette dispatcher (reference utils/utils.py:62-67)."""
    if dataset == "voc":
        return voc_cmap()
    if dataset == "cityscapes":
        return cityscapes_cmap()
    if dataset in ("ade", "coco", "coco-voc"):
        return ade_cmap()
    raise ValueError(f"no colormap for dataset {dataset!r}")


# Instance-visualization palette (the public Detectron2 colormap; reference
# utils/utils.py:280-357, imported by train.py:32). 73 float RGB rows in
# [0, 1] at 3-decimal precision, packed as milli-unit uint16.
_COLORS_B64 = (
    "AAAAAAAAUgNFAWIAoQO2An0A7gG4ACwC0gGiArwALQHpAqUDewJOALgALAEsASwBWAJYAl"
    "gC6AMAAAAA6AP0AQAA7QLtAgAAAADoAwAAAAAAAOgDmwIAAOgDTQFNAQAATQGbAgAATQHo"
    "AwAAmwJNAQAAmwKbAgAAmwLoAwAA6ANNAQAA6AObAgAA6APoAwAAAABNAfQBAACbAvQBAA"
    "DoA/QBTQEAAPQBTQFNAfQBTQGbAvQBTQHoA/QBmwIAAPQBmwJNAfQBmwKbAvQBmwLoA/QB"
    "6AMAAPQB6ANNAfQB6AObAvQB6APoA/QBAABNAegDAACbAugDAADoA+gDTQEAAOgDTQFNAe"
    "gDTQGbAugDTQHoA+gDmwIAAOgDmwJNAegDmwKbAugDmwLoA+gD6AMAAOgD6ANNAegD6AOb"
    "AugDTQEAAAAA9AEAAAAAmwIAAAAAQQMAAAAA6AMAAAAAAACnAAAAAABNAQAAAAD0AQAAAA"
    "CbAgAAAABBAwAAAADoAwAAAAAAAKcAAAAAAE0BAAAAAPQBAAAAAJsCAAAAAEEDAAAAAOgD"
    "jwCPAI8AWQNZA1kD6APoA+gD"
)

_COLORS = (np.frombuffer(base64.b64decode(_COLORS_B64), np.uint16)
           .reshape(-1, 3).astype(np.float32) / 1000.0)


def label_to_color_image(label: np.ndarray) -> np.ndarray:
    """Int instance/label image -> float RGB via the 73-color table, ids
    wrapping modulo the table (reference utils/utils.py:359-360 indexes the
    table directly; wrapping keeps >=73 instances in range)."""
    return _COLORS[np.asarray(label) % len(_COLORS)]


class Label2Color:
    """Map an int label image to RGB using a colormap."""

    def __init__(self, cmap: np.ndarray):
        self.cmap = cmap

    def __call__(self, lbls: np.ndarray) -> np.ndarray:
        return self.cmap[np.clip(lbls, 0, len(self.cmap) - 1)]


def sample_image(image: np.ndarray, ins_map: np.ndarray) -> np.ndarray:
    """A (H, W, 3) normalised image and its (H, W) instance-id map (-1 for
    no instance) -> the (H, 2W, 3) uint8 sample the CLI's ``--sample_num``
    writes: the denormalised image beside the instances coloured through
    the 73-colour table on black. Ids wrap onto rows 1..72 before the
    shift: a plain ``(ins + 1) % 73`` would send ids = 72 (mod 73) to row
    0, black, hiding them against the background."""
    ins = np.asarray(ins_map)
    img = np.clip(denorm(image), 0, 1)
    ins_rgb = (label_to_color_image(ins % 72 + 1) * 255
               * (ins >= 0)[..., None])
    vis = np.concatenate([(img * 255).astype(np.uint8), ins_rgb], axis=1)
    return vis.astype(np.uint8)
