"""Checkpoints, CL-step classifier expansion, the torch iABN weight ingest
and the weight carry-over from the JAX package (counterpart of
``cl4wsis_tpu/cl/ckpt.py``).

Everything works on state dicts in the upstream key layout (``body.*``,
``head.*``, ``cls.{i}``, ``decoder.instance_decoder.*``,
``instance_head.classifier.*``):

1. :func:`expand_for_new_step`: previous-step weights into the new step's
   model. The incremental classifiers are per-step modules, so torch's
   strict=False load is :func:`tree_merge`; the new ``cls.{n-1}`` and
   center classifier keep their fresh init or are background-imprinted
   (:func:`init_balanced_classifier`).
2. :func:`save_checkpoint` / :func:`load_checkpoint`: ``torch.save`` of a
   nested dict of state dicts (the JAX package writes orbax checkpoints,
   which need JAX).
3. :func:`convert_torch_resnet` / :func:`load_torch_pretrained`: the
   ImageNet iABN pickles onto ``body.*``.
4. :func:`convert_jax_variables` turns the JAX model's ``{"params",
   "batch_stats"}`` tree, with numpy arrays as leaves, into a state dict of
   the port's :class:`~cl4wsis_tpu_torch.models.CL4WSISModel`: HWIO kernels
   become OIHW weights and every flax path its upstream torch key (the
   inverse of the JAX ``convert_torch_cl4wsis``).
5. :func:`convert_jax_adam` / :func:`load_adam_state`: optax's Adam
   moments and count into ``torch.optim.Adam``'s per-parameter state, so
   a run carried over from JAX goes on with the optimizer's history.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from cl4wsis_tpu_torch.core import dist

# ---------------------------------------------------------------- merging


def tree_merge(base: Any, update: Any) -> Any:
    """Deep merge `update` into `base` with torch strict=False semantics:
    keys present in both are overwritten, keys only in base keep their
    value, keys only in update are IGNORED (e.g. a step-0 instance branch
    loading into a phase-1 branch-'none' model)."""
    if isinstance(base, dict) and isinstance(update, dict):
        out = dict(base)
        for k, v in update.items():
            if k in base:
                out[k] = tree_merge(base[k], v)
        return out
    return update


def init_balanced_classifier(state: Dict[str, torch.Tensor],
                             classes: Sequence[int],
                             prefix: str = "cls.") -> Dict[str, torch.Tensor]:
    """Background imprinting for the newest step's classifier
    (upstream ``segmentation_module.py:132-144``): the new weights copy the
    background row of ``{prefix}0``, the new bias is bkg_bias -
    log(n_new + 1); ``{prefix}0``'s background bias is shifted to the same
    value."""
    new_key = f"{prefix}{len(classes) - 1}"
    w0 = state[f"{prefix}0.weight"].detach().cpu()  # (Cout, Cin, 1, 1)
    b0 = state[f"{prefix}0.bias"].detach().cpu().numpy().copy()
    new_bias_val = b0[0] - float(np.log(classes[-1] + 1))
    n_new = state[f"{new_key}.weight"].shape[0]
    out = dict(state)
    out[f"{new_key}.weight"] = w0[:1].repeat(n_new, 1, 1, 1)
    out[f"{new_key}.bias"] = torch.full((n_new,), new_bias_val,
                                        dtype=torch.float32)
    b0[0] = new_bias_val
    out[f"{prefix}0.bias"] = torch.from_numpy(b0)
    return out


def expand_for_new_step(new_state: Dict[str, torch.Tensor],
                        old_state: Dict[str, torch.Tensor],
                        classes: Sequence[int],
                        init_balanced: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """Previous-step weights into a freshly initialised new-step model's
    state dict (upstream ``train.py:747-762``)."""
    state = tree_merge(new_state, old_state)
    if init_balanced:
        state = init_balanced_classifier(state, classes)
        center = "instance_head.classifier.center.cls."
        if f"{center}0.weight" in state:
            state = init_balanced_classifier(
                state, [c - 1 if i == 0 else c for i, c in enumerate(classes)],
                prefix=center)
    return state


# ---------------------------------------------------------------- file io

def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """``torch.save`` of a nested dict of state dicts and numbers, written
    beside `path` and renamed into place, so a reader never finds half a
    file. Over several ranks rank 0 writes and every rank waits at a
    barrier until it has, so no rank reads the file before it is whole."""
    if dist.is_main():
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
    dist.barrier()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint of :func:`save_checkpoint`, its tensors on the CPU
    (every rank reads it and copies it to its own card)."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def ckpt_path(root: str, dataset: str, task: str, overlap: bool, name: str,
              step: int) -> str:
    """Canonical layout (upstream ``run.py:52``):
    checkpoints/step/{ds}-{task}[-ov]/{name}_{step}."""
    ov = "-ov" if overlap else ""
    return os.path.join(root, "step", f"{dataset}-{task}{ov}", f"{name}_{step}")


# ------------------------------------------------------- torch iABN ingest

_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def convert_torch_resnet(state_dict: Dict[str, Any],
                         abs_bn_weight: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """A torch iABN ResNet or WideResNet state dict (the ImageNet
    pretrained format of upstream ``segmentation_module.py:37-57``) -> the
    port's ``body.*`` keys, float32. A 'module.' prefix is stripped and
    ``classifier.*`` dropped. Every ``bn*`` and ``proj_bn`` layer is a
    norm (WideResNet's block ``bn1`` and ``bn_out`` too). InPlace-ABN
    applies |weight| in its forward, so a BN weight ingests as abs(weight)
    by default."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.startswith("classifier."):
            continue
        parts = key.split(".")
        layer, field = parts[-2], parts[-1]
        val = torch.as_tensor(np.asarray(val, np.float32))
        if layer.startswith("bn") or layer == "proj_bn":
            if field not in _BN_FIELDS:
                continue
            if field == "weight" and abs_bn_weight:
                val = val.abs()
        elif field != "weight":
            continue
        out["body." + key] = val
    return out


def load_torch_pretrained(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """An iABN ImageNet checkpoint as ``body.*`` weights, if present. The
    file is read as the JAX package reads it, as a full pickle: upstream's
    training scripts save numpy scalars, ``argparse.Namespace`` or other
    objects beside ``state_dict``, which ``weights_only=True`` refuses."""
    if not os.path.exists(path):
        return None
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return convert_torch_resnet(blob.get("state_dict", blob))


# ------------------------------------------------- carry-over from JAX

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


def _body_module(path: Tuple[str, ...], wide: bool) -> str:
    """A body path -> its upstream key. In a ResNet block every norm lives
    in ``convs``; in a WideResNet block ``bn1`` is the pre-activation norm
    beside ``convs``, and ``bn_out`` follows the last module."""
    name, rest = path[0], path[1:]
    if name in ("mod1_conv1", "mod1_bn1"):
        return "mod1." + name[len("mod1_"):]
    if name == "bn_out" and wide and not rest:
        return name
    m = re.fullmatch(r"(mod\d+)_(block\d+)", name)
    if not m or len(rest) != 1:
        raise KeyError(path)
    layer = rest[0]
    if layer.startswith("proj_") or (wide and layer == "bn1"):
        return f"{m.group(1)}.{m.group(2)}.{layer}"
    return f"{m.group(1)}.{m.group(2)}.convs.{layer}"


def _dwsep(path: Tuple[str, ...]) -> str:
    return _DWSEP[tuple(path)]


def _module_key(path: Tuple[str, ...], wide: bool = False) -> str:
    """flax module path (without the leaf field) -> torch module path;
    `wide`: the body is a WideResNet."""
    top, rest = path[0], path[1:]
    if not rest and top in _WSS_LAYERS:
        return top
    if top == "body":
        return "body." + _body_module(rest, wide)
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
    """JAX ``{"params", "batch_stats"}`` tree of the model (any backbone),
    the PseudoLabeler or the PeakGenerator -> its port's state dict."""
    wide = any("bn_out" in variables.get(coll, {}).get("body", {})
               for coll in ("params", "batch_stats"))
    sd: Dict[str, torch.Tensor] = {}
    for coll, fields in (("params", _PARAM_FIELDS),
                         ("batch_stats", _STAT_FIELDS)):
        for path, leaf in _leaves(variables.get(coll, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)   # HWIO -> OIHW
            key = f"{_module_key(path[:-1], wide)}.{fields[path[-1]]}"
            sd[key] = torch.from_numpy(np.array(arr))  # a writable copy
    return sd


def convert_jax_adam(mu: Dict[str, Any], nu: Dict[str, Any], count: Any
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """optax ``scale_by_adam``'s state of the model (its ``mu`` and ``nu``
    trees, shaped as the model's params, numpy leaves, and its ``count``
    of updates taken) -> ``torch.optim.Adam``'s state of each parameter,
    by state-dict key: ``exp_avg``, ``exp_avg_sq`` and ``step``. Both
    read the count the same way in their bias corrections, so ``step`` is
    the count."""
    exp_avg = convert_jax_variables({"params": mu})
    exp_avg_sq = convert_jax_variables({"params": nu})
    step = float(np.asarray(count))
    return {k: {"step": torch.tensor(step), "exp_avg": exp_avg[k],
                "exp_avg_sq": exp_avg_sq[k]} for k in exp_avg}


def load_adam_state(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    state: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Put :func:`convert_jax_adam`'s `state` into `optimizer`, an Adam
    over `model`'s parameters: each parameter of a param group gets its
    entry, on its device (a frozen parameter sits in no group and gets
    none). A trained parameter missing from `state` raises KeyError."""
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            s = state[names[id(p)]]
            optimizer.state[p] = {
                "step": s["step"].clone(),
                "exp_avg": s["exp_avg"].to(p.device, p.dtype).clone(),
                "exp_avg_sq": s["exp_avg_sq"].to(p.device, p.dtype).clone()}
