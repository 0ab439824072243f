"""COCO mask decoding without pycocotools (counterpart of
``cl4wsis_tpu/data/maskrle.py``).

Compressed-RLE strings (rleFrString semantics, column-major runs),
uncompressed RLE and polygons. Polygons are rasterised by the native
library only (``data/native.py``, bit-equal to pycocotools' ``rleFrPoly``);
where it cannot be built, this raises. The JAX package falls through to cv2
``fillPoly`` or a numpy scanline, which draw other boundary pixels; the
port has neither. The numpy RLE functions here are the oracle the native
ones are held against, and ``rle_encode`` gives the dict that
``InstancePrediction.to_coco`` returns.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from cl4wsis_tpu_torch.data import native


def rle_from_string(s: Union[str, bytes]) -> List[int]:
    """Decode a COCO compressed-RLE counts string to run lengths."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def rle_decode(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    """Run lengths (column-major, starting with 0s) -> (h, w) uint8 mask."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if total < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - total, np.uint8)])
    return flat[:h * w].reshape(w, h).T  # column-major


def rle_encode(mask: np.ndarray) -> Dict:
    """Binary mask -> uncompressed RLE dict (column-major counts)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(idx).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int, w: int
                     ) -> np.ndarray:
    """Rasterise COCO polygons ([x0, y0, x1, y1, ...] lists) to a (h, w)
    uint8 mask through the native library."""
    return native.poly_to_mask(polys, h, w)


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """pycocotools ``coco.annToMask``: polygons, or RLE (compressed string
    or uncompressed counts) of the annotation's own size."""
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    counts = seg["counts"]
    if isinstance(counts, (str, bytes)):
        counts = native.rle_from_string(
            counts.decode() if isinstance(counts, bytes) else counts)
    return native.rle_decode(counts, seg["size"][0], seg["size"][1])
