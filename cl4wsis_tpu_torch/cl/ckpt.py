"""Weight carry-over from the JAX package (counterpart of
``cl4wsis_tpu/cl/ckpt.py``, the inverse of its ``convert_torch_cl4wsis``).

:func:`convert_jax_variables` turns the JAX model's ``{"params",
"batch_stats"}`` tree, with numpy arrays as leaves, into a state dict of the
port's :class:`~cl4wsis_tpu_torch.models.CL4WSISModel`: HWIO kernels become
OIHW weights and every flax path its upstream torch key.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_PARAM_FIELDS = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_FIELDS = {"mean": "running_mean", "var": "running_var"}
# flax sub-path of a depthwise-separable conv -> its torch Sequential path
_DWSEP = {("depthwise", "conv"): "0.0.0", ("depthwise", "bn"): "0.0.1",
          ("pointwise",): "0.1", ("pointwise_bn",): "0.2"}
# PseudoLabeler and PeakGenerator layers keep their flax names
_WSS_LAYERS = ("conv1", "norm1", "conv2", "norm2", "cls", "extra_conv4")


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _body_module(path: Tuple[str, ...]) -> str:
    name, rest = path[0], path[1:]
    if name in ("mod1_conv1", "mod1_bn1"):
        return "mod1." + name[len("mod1_"):]
    m = re.fullmatch(r"(mod\d+)_(block\d+)", name)
    if not m or len(rest) != 1:
        raise KeyError(path)
    layer = rest[0]
    if layer.startswith("proj_"):
        return f"{m.group(1)}.{m.group(2)}.{layer}"
    return f"{m.group(1)}.{m.group(2)}.convs.{layer}"


def _dwsep(path: Tuple[str, ...]) -> str:
    return _DWSEP[tuple(path)]


def _module_key(path: Tuple[str, ...]) -> str:
    """flax module path (without the leaf field) -> torch module path."""
    top, rest = path[0], path[1:]
    if not rest and top in _WSS_LAYERS:
        return top
    if top == "body":
        return "body." + _body_module(rest)
    if top == "seg_head":
        m = re.fullmatch(r"map_conv(\d)", rest[0])
        return f"head.map_convs.{m.group(1)}" if m else f"head.{rest[0]}"
    if top == "cls":
        return "cls." + rest[0][len("cls_"):]
    if top == "instance_decoder":
        base = "decoder.instance_decoder."
        sub = rest[0]
        if sub == "aspp":
            part = rest[1]
            m = re.fullmatch(r"branch(\d)", part)
            if m:
                idx = {"conv": "0", "bn": "1"}[rest[2]]
                return f"{base}aspp.convs.{m.group(1)}.{idx}"
            return base + {"pool_conv": "aspp.convs.4.aspp_pooling.1",
                           "project_conv": "aspp.project.0",
                           "project_bn": "aspp.project.1"}[part]
        m = re.fullmatch(r"(project|fuse)_(\d)", sub)
        if m and m.group(1) == "project":
            idx = {"conv": "0", "bn": "1"}[rest[1]]
            return f"{base}project.{m.group(2)}.{idx}"
        if m:
            return f"{base}fuse.{m.group(2)}.{_dwsep(rest[1:])}"
    if top == "instance_head":
        m = re.fullmatch(r"(center|offset)_(fuse|cls_(\d+))", rest[0])
        base = f"instance_head.classifier.{m.group(1)}."
        if m.group(2) == "fuse":
            return base + "fuse." + _dwsep(rest[1:])
        return base + "cls." + m.group(3)
    raise KeyError(path)


def convert_jax_variables(variables: Dict[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree of the model, the
    PseudoLabeler or the PeakGenerator -> its port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for coll, fields in (("params", _PARAM_FIELDS),
                         ("batch_stats", _STAT_FIELDS)):
        for path, leaf in _leaves(variables.get(coll, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)   # HWIO -> OIHW
            key = f"{_module_key(path[:-1])}.{fields[path[-1]]}"
            sd[key] = torch.from_numpy(np.array(arr))  # a writable copy
    return sd
