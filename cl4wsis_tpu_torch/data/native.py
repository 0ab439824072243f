"""ctypes bindings for the host mask library (counterpart of
``cl4wsis_tpu/data/native.py``).

``cl4wsis_tpu_torch/csrc/maskops.cpp`` (a byte-for-byte copy of the JAX
package's ``csrc/maskops.cpp``) is compiled at first use with
``g++ -O3 -fPIC -shared -std=c++17`` into ``cl4wsis_tpu_torch/_build/``,
named by a hash of the source and the flags, so a stale build is never
loaded and one build serves every host the directory is copied to (no
``-march=native``). A failed build raises with the compiler's output: the
polygon rasteriser has no fallback that draws other pixels.

The library is opened lazily, once per process, and kept in this module:
nothing holds the handle in a dataset, so a data-loader worker (a fresh
process) opens its own. It is host-only and never touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "maskops.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I = ctypes.c_int
_SIGNATURES = {
    "rle_from_string": ([ctypes.c_char_p, _I, _I64P, _I], _I),
    "rle_decode": ([_I64P, _I, _I, _I, _U8P], None),
    "rle_encode": ([_U8P, _I, _I, _I64P, _I], _I),
    "poly_to_mask": ([_F64P, _I, _I, _I, _U8P], None),
    "connected_components_stats": ([_U8P, _I, _I, _I, _I32P, _F64P, _I], _I),
    "mask_iou": ([_U8P, _I, _U8P, _I, ctypes.c_int64, _F64P], None),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmaskops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not there yet; returns its path."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the mask library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / so.name
        p = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp_so), str(SOURCE)],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n"
                               f"{p.stdout}{p.stderr}")
        os.replace(tmp_so, so)   # atomic: concurrent builds agree
    return so


def lib() -> ctypes.CDLL:
    """The library of this process, built and opened at first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = args, res
        _lib = handle
    return _lib


def rle_from_string(s: str) -> List[int]:
    buf = np.zeros(len(s) + 1, np.int64)
    n = lib().rle_from_string(s.encode("ascii"), len(s),
                              buf.ctypes.data_as(_I64P), len(buf))
    return buf[:n].tolist()


def rle_decode(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    runs = np.ascontiguousarray(counts, np.int64)
    out = np.zeros((h, w), np.uint8)
    lib().rle_decode(runs.ctypes.data_as(_I64P), len(runs), h, w,
                     out.ctypes.data_as(_U8P))
    return out


def rle_encode(mask: np.ndarray) -> List[int]:
    h, w = mask.shape
    m = np.ascontiguousarray(mask, np.uint8)
    buf = np.zeros(h * w + 2, np.int64)
    n = lib().rle_encode(m.ctypes.data_as(_U8P), h, w,
                         buf.ctypes.data_as(_I64P), len(buf))
    return buf[:n].tolist()


def poly_to_mask(polys: Sequence[Sequence[float]], h: int, w: int
                 ) -> np.ndarray:
    """COCO polygons rasterised with pycocotools' ``rleFrPoly`` semantics
    (exact), OR-ed together as pycocotools merges them; polygons of fewer
    than 3 points are skipped."""
    out = np.zeros((h, w), np.uint8)
    op = out.ctypes.data_as(_U8P)
    for p in polys:
        if len(p) < 6:
            continue
        xy = np.ascontiguousarray(p, np.float64)
        lib().poly_to_mask(xy.ctypes.data_as(_F64P), len(xy) // 2, h, w, op)
    return out


def connected_components_stats(mask: np.ndarray, connectivity: int = 8,
                               max_comp: int = 4096
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Components of a (h, w) mask by union-find: (labels (h, w) int32, 0
    for background and 1..K in first-pixel order, stats (K, 3) float64
    [area, mean y, mean x]). Raises past `max_comp` components."""
    h, w = mask.shape
    m = np.ascontiguousarray(mask, np.uint8)
    labels = np.zeros((h, w), np.int32)
    stats = np.zeros((max_comp, 3), np.float64)
    k = lib().connected_components_stats(
        m.ctypes.data_as(_U8P), h, w, connectivity,
        labels.ctypes.data_as(_I32P), stats.ctypes.data_as(_F64P), max_comp)
    if k < 0:
        raise RuntimeError(f"more than {max_comp} components")
    st = stats[:k]
    area = np.maximum(st[:, 0], 1)
    return labels, np.stack([st[:, 0], st[:, 1] / area, st[:, 2] / area],
                            axis=1)


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix (n, m) float64 of masks a (n, h, w) and b (m, h, w); 0
    where both masks are empty."""
    n, m = a.shape[0], b.shape[0]
    a8 = np.ascontiguousarray(a.reshape(n, -1), np.uint8)
    b8 = np.ascontiguousarray(b.reshape(m, -1), np.uint8)
    if a8.shape[1] != b8.shape[1]:
        raise ValueError(f"mask sizes differ: {a.shape} and {b.shape}")
    out = np.zeros((n, m), np.float64)
    lib().mask_iou(a8.ctypes.data_as(_U8P), n, b8.ctypes.data_as(_U8P), m,
                   a8.shape[1], out.ctypes.data_as(_F64P))
    return out
