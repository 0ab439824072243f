"""The port's serving path (get_ins_map, Predictor with and without flip,
from_checkpoint, to_coco) against the JAX package on the CPU, and the
port's import and device rules."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl4wsis_tpu.models import make_model as jax_make_model
from cl4wsis_tpu.ops.instance_postproc import get_ins_map as jax_get_ins_map
from cl4wsis_tpu.serve import InstancePrediction as JaxInstancePrediction
from cl4wsis_tpu.serve import Predictor as JaxPredictor
from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables
from cl4wsis_tpu_torch.cli.config import parse_config
from cl4wsis_tpu_torch.data.maskrle import rle_decode
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.ops.instance_postproc import get_ins_map
from cl4wsis_tpu_torch.serve import InstancePrediction, Predictor
from cl4wsis_tpu_torch.train.trainer import Trainer
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def painted_scene(H, W, C, seed, n_inst):
    """(seg_prob, center, offset) with `n_inst` painted instances: random
    boxes of random classes (later ones occlude earlier ones), soft class
    probabilities, gaussian centers (one in four too weak for NMS, so only
    its offset cluster can find it) and offsets toward each center."""
    rs = np.random.RandomState(seed)
    seg = rs.uniform(0.0, 0.2, (H, W, C + 1)).astype(np.float32)
    seg[..., 0] += 1.0
    center = np.zeros((H, W, C), np.float32)
    offset = rs.uniform(-20, 20, (H, W, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i in range(n_inst):
        c = rs.randint(C)
        cy, cx = rs.uniform(6, H - 6), rs.uniform(6, W - 6)
        ry, rx = rs.uniform(4, 12, 2)
        box = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
        seg[box] = rs.uniform(0.0, 0.2, (box.sum(), C + 1))
        seg[box, c + 1] = rs.uniform(0.5, 1.0)
        peak = 0.08 if i % 4 == 3 else rs.uniform(0.3, 1.0)
        g = peak * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
        center[..., c] = np.maximum(center[..., c], g)
        offset[..., 0][box] = (cy - yy)[box]
        offset[..., 1][box] = (cx - xx)[box]
    seg /= seg.sum(-1, keepdims=True)
    return seg, center, offset


def assert_same_slots(got, want, score_atol=1e-5):
    """ins_map, label and valid exact; score within `score_atol` (the port
    takes probability totals from a float64 prefix, JAX from a
    double-single one)."""
    for k in ("ins_map", "label", "valid", "truncated"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(np.asarray(got["score"]),
                               np.asarray(want["score"]), rtol=0,
                               atol=score_atol)


@pytest.mark.parametrize("seed,n_inst,C", [(0, 6, 2), (1, 12, 4), (2, 20, 6),
                                           (3, 3, 1)])
def test_get_ins_map_matches_jax(seed, n_inst, C):
    seg, center, offset = painted_scene(64, 64, C, seed, n_inst)
    kw = dict(num_classes=C, val_kernel=15, max_ctr=8, max_cluster=4)
    got = get_ins_map(torch.from_numpy(seg), torch.from_numpy(center),
                      torch.from_numpy(offset), **kw)
    want = jax_get_ins_map(jnp.asarray(seg), jnp.asarray(center),
                           jnp.asarray(offset), **kw)
    assert got["ins_map"].dtype == torch.int32
    assert int(got["valid"].sum()) > 0
    assert_same_slots({k: v.numpy() for k, v in got.items()}, want)


def test_get_ins_map_finds_weak_center_by_its_cluster():
    """An instance whose center heat (0.08) is under val_thresh is found
    only through its offset cluster, and scores its seg score."""
    seg, center, offset = painted_scene(64, 64, 1, 5, 4)   # 4th is weak
    got = get_ins_map(torch.from_numpy(seg), torch.from_numpy(center),
                      torch.from_numpy(offset), num_classes=1, val_kernel=15,
                      max_ctr=8, max_cluster=4)
    valid = got["valid"].numpy()
    assert valid[8:].any(), "no cluster slot was found"
    want = jax_get_ins_map(jnp.asarray(seg), jnp.asarray(center),
                           jnp.asarray(offset), num_classes=1, val_kernel=15,
                           max_ctr=8, max_cluster=4)
    assert_same_slots({k: v.numpy() for k, v in got.items()}, want)


@pytest.fixture(scope="module")
def tiny_models():
    jm = jax_make_model((3, 2), "resnet101", 16, 64,
                        backbone_structure=(1, 1, 1, 1))
    # jitted: flax's eager init takes about three times as long here
    variables = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # a positive bias on the center head, so NMS finds centers
    head = variables["params"]["instance_head"]
    for name in ("center_cls_0", "center_cls_1"):
        head[name]["bias"] = head[name]["bias"] + np.float32(0.3)
    port = make_model((3, 2), "resnet101", 16, 64,
                      backbone_structure=(1, 1, 1, 1))
    return jm, variables, port


@pytest.mark.parametrize("hw,bucket", [((60, 44), 64), ((64, 64), 64),
                                       ((60, 44), None)])
def test_predictor_matches_jax(tiny_models, hw, bucket):
    """Bucketed (pad, mask, crop) and exact per-size paths."""
    jm, variables, port = tiny_models
    img = (np.random.RandomState(hw[0]).rand(*hw, 3) * 255).astype(np.uint8)
    want = JaxPredictor(jm, variables, val_kernel=15,
                        bucket_multiple=bucket)(img)
    pred = Predictor(port, convert_jax_variables(variables), device="cpu",
                     dtype="float32", val_kernel=15, bucket_multiple=bucket)
    got = pred(img)
    assert got.ins_map.shape == hw
    for k in ("ins_map", "labels", "valid", "seg"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-5)
    assert 0 < len(got.instances()) == len(want.instances())


def test_predictor_val_flip_matches_jax(tiny_models):
    """val_flip: the image and its flip as one batch of 2, the seg
    probabilities and centers averaged with the flip undone."""
    jm, variables, port = tiny_models
    img = (np.random.RandomState(7).rand(60, 44, 3) * 255).astype(np.uint8)
    want = JaxPredictor(jm, variables, val_kernel=15, val_flip=True)(img)
    got = Predictor(port, convert_jax_variables(variables), device="cpu",
                    dtype="float32", val_kernel=15, val_flip=True)(img)
    for k in ("ins_map", "labels", "valid", "seg"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-5)
    assert len(got.instances()) > 0
    plain = Predictor(port, device="cpu", dtype="float32", val_kernel=15)(img)
    assert not np.array_equal(plain.ins_map, got.ins_map)


def _prediction(cls, seed, H=20, W=16, S=6):
    rs = np.random.RandomState(seed)
    ins = rs.randint(-1, S, (H, W)).astype(np.int32)
    ins[:, :3] = 5                               # slot 5: a column band
    labels = rs.randint(0, 20, S).astype(np.int32)
    valid = np.array([True, True, False, True, False, True])
    scores = rs.rand(S).astype(np.float32)
    seg = np.where(ins >= 0, labels[np.clip(ins, 0, None)] + 1, 0)
    return cls(ins_map=ins, labels=labels, scores=scores, valid=valid,
               seg=seg.astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_to_coco_matches_jax(seed):
    """COCO results (uncompressed RLE) equal the JAX package's; each RLE
    decodes back to its instance's mask exactly."""
    got = _prediction(InstancePrediction, seed)
    want = _prediction(JaxInstancePrediction, seed)
    cats = list(range(100, 120))
    for kw in ({}, {"category_ids": cats}):
        res = got.to_coco(image_id=7, **kw)
        assert res == want.to_coco(image_id=7, **kw)
        assert len(res) == 4
        for r, inst in zip(res, got.instances()):
            assert r["image_id"] == 7 and r["score"] == inst["score"]
            m = rle_decode(r["segmentation"]["counts"],
                           *r["segmentation"]["size"])
            np.testing.assert_array_equal(m, inst["mask"].astype(np.uint8))
    assert res[0]["category_id"] == cats[got.labels[0]]


def test_from_checkpoint_matches_the_in_memory_predictor(tmp_path):
    """A tiny trainer's checkpoint, served through from_checkpoint, gives
    the outputs of a Predictor over the trainer's own model, bit for
    bit."""
    cfg = parse_config(["--tiny", "--synthetic", "--device", "cpu", "--dtype",
                        "float32", "--crop_size", "64", "--step", "0"])
    trainer = Trainer(cfg, iters_per_epoch=1)
    with torch.no_grad():
        for conv in trainer.model.instance_head.classifier.center.cls:
            conv.bias += 0.3
    path = str(tmp_path / "ck")
    trainer.save(path, 0)
    kw = dict(device="cpu", dtype="float32", val_kernel=15)
    served = Predictor.from_checkpoint(path, trainer.classes, crop_size=64,
                                       **kw)
    assert [len(getattr(served.model.body, f"mod{i}")) for i in (2, 3, 4, 5)
            ] == [1, 1, 1, 1]
    ref = Predictor(trainer.model, **kw)
    for hw in ((60, 44), (64, 64)):
        img = (np.random.RandomState(hw[1]).rand(*hw, 3) * 255).astype(
            np.uint8)
        got, want = served(img), ref(img)
        for k in ("ins_map", "labels", "valid", "seg", "scores"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)
        assert len(got.instances()) > 0


def test_predictor_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = make_model((3, 2), "resnet101", 16, 64,
                       backbone_structure=(1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model)


def test_port_imports_no_jax():
    """Importing every module of the port (the training slice's among them),
    and chip_smoke.py, loads neither jax nor the JAX package (whose name
    the port's name starts with)."""
    code = r"""
import importlib, pathlib, sys
root = pathlib.Path("cl4wsis_tpu_torch")
mods = sorted(".".join(p.with_suffix("").parts) for p in root.rglob("*.py"))
for m in mods:
    importlib.import_module(m.removesuffix(".__init__"))
importlib.import_module("chip_smoke")
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                      "cl4wsis_tpu")]
print(len(mods), bad)
assert len(mods) > 25 and not bad, bad
assert {"cl4wsis_tpu_torch.train.phase2", "cl4wsis_tpu_torch.ops.labelgen",
        "cl4wsis_tpu_torch.wss.modules",
        "cl4wsis_tpu_torch.data.synthetic", "cl4wsis_tpu_torch.cli.main",
        "cl4wsis_tpu_torch.train.trainer", "cl4wsis_tpu_torch.metrics.voc_ap",
        "cl4wsis_tpu_torch.cl.tasks", "cl4wsis_tpu_torch.data.voc",
        "cl4wsis_tpu_torch.data.coco", "cl4wsis_tpu_torch.data.loader",
        "cl4wsis_tpu_torch.data.native"} <= set(mods), mods
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


@pytest.mark.parametrize("backbone,output_stride", [("resnet18", 16),
                                                    ("resnet34", 8)])
def test_from_checkpoint_builds_the_basic_block_nets(tmp_path, backbone,
                                                     output_stride):
    """from_checkpoint reads the blocks of a basic-block net's checkpoint
    (one a stage here) and serves it bit-equal to a Predictor over the
    model that wrote it."""
    from cl4wsis_tpu_torch.cl.ckpt import save_checkpoint
    torch.manual_seed(0)
    model = make_model((3, 2), backbone, output_stride, 64,
                       backbone_structure=(1, 1, 1, 1))
    state = model.state_dict()
    for k in state:                     # instances to serve
        if k.startswith("instance_head.classifier.center.cls."):
            state[k] = state[k] + 0.3 if k.endswith(".bias") else state[k]
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"model": state})
    kw = dict(device="cpu", dtype="float32", val_kernel=15)
    served = Predictor.from_checkpoint(path, (3, 2), backbone, output_stride,
                                       64, **kw)
    assert served.model.body.out_channels == 512
    img = (np.random.RandomState(1).rand(60, 44, 3) * 255).astype(np.uint8)
    got, want = served(img), Predictor(model, state, **kw)(img)
    for k in ("ins_map", "labels", "scores", "valid", "seg"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
