"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``cl4wsis_tpu_torch/csrc/*.cu`` have a plain C interface and
include no PyTorch header. At first use they are compiled for Hopper
(``sm_90a``), one ``nvcc`` per source started together, and linked into one
shared library under ``cl4wsis_tpu_torch/_build/``, named by a hash of the
sources so a stale build is never loaded. The library is opened with
``ctypes``; every pointer and the stream cross as ``c_void_p``.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card may have no ``nvcc`` either.

The wrappers allocate outputs and scratch with ``torch.empty`` and launch on
PyTorch's current stream without synchronising. Scratch may be dropped as
soon as the launch is queued: the caching allocator hands a freed block only
to work queued later on the same stream.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it. A run
sets the counts to 0 with :func:`reset_launches` and reads them afterwards
to show that a path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("topk.cu", "cc.cu", "run_totals.cu", "stamp.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {"topk": 0, "cc_multilabel": 0, "run_totals": 0,
                            "stamp": 0, "cc_binary": 0}

_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cl4_topk_segment": ([], _I),
    "cl4_topk_max_k": ([], _I),
    "cl4_topk_f32": ([_P, _I, _I, _I, _P, _P, _P, _P, _P], _I),
    "cl4_cc_multilabel": ([_P, _P, _I, _I, _I, _I, _P], _I),
    "cl4_cc_binary": ([_P, _P, _I, _I, _I, _I, _P], _I),
    "cl4_run_totals_tile": ([], _I),
    "cl4_run_totals_desc": ([], _I),
    "cl4_run_totals": ([_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "cl4_stamp_max_slots": ([], _I),
    "cl4_stamp": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
    "cl4_error_string": ([_I], ctypes.c_char_p),
    "cl4_set_device": ([_I], _I),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libcl4wsis_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources (in parallel) and link the library if it is not
    there yet. Returns its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for name, _, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / so.name
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp_so), *(str(o) for _, o, _ in procs)]
        p = subprocess.run(link, capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{p.stdout}{p.stderr}")
        os.replace(tmp_so, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for fn, (args, res) in _SIGNATURES.items():
            f = getattr(handle, fn)
            f.argtypes = args
            f.restype = res
        _lib = handle
    return _lib


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """Make `t`'s device current for the library and return PyTorch's
    current stream on it, which the kernels launch on."""
    err = lib().cl4_set_device(t.device.index or 0)
    if err != 0:
        raise RuntimeError(f"cudaSetDevice failed: error {err}")
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error, else count the launch."""
    if err != 0:
        msg = lib().cl4_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({msg})")
    LAUNCHES[name] += 1


def require_cuda(t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 name: str) -> None:
    """The checks every wrapper makes before passing a pointer."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
