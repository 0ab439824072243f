"""The port's model (cl4wsis_tpu_torch.models) against the JAX model on
a tiny ResNet, at float32 on the CPU, with weights carried over by
cl4wsis_tpu_torch.cl.ckpt.convert_jax_variables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl4wsis_tpu.cl.ckpt import convert_torch_cl4wsis
from cl4wsis_tpu.models import make_model as jax_make_model
from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.models.assembly import backbone_channels
from torch_one_thread import one_torch_thread  # noqa: F401

CLASSES = (16, 5)
TINY = (1, 1, 1, 1)


def jax_tiny_variables(model, size, seed):
    """JAX init with every BN scale, bias, mean and var randomised, so the
    carried-over statistics matter (scales may be negative: no abs)."""
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rs = np.random.RandomState(seed)

    def randomise(tree):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                randomise(leaf)
            elif k in ("scale", "var"):
                lo = -1.5 if k == "scale" else 0.5
                tree[k] = rs.uniform(lo, 1.5, leaf.shape).astype(np.float32)
            elif k in ("mean",) or (k == "bias" and leaf.ndim == 1):
                tree[k] = (0.1 * rs.randn(*leaf.shape)).astype(np.float32)

    v = {"params": dict(v["params"]), "batch_stats": dict(v["batch_stats"])}
    randomise(v["params"])
    randomise(v["batch_stats"])
    return v


@pytest.mark.parametrize("crop", [32, 48])
def test_tiny_model_forward_matches_jax(crop):
    """seg, center and offset at 64x64 within atol=rtol=1e-4 (float32
    convolutions summed in different orders). crop 32 / 48 give eval
    pooling windows 2 (even: the extra pad pixel goes after) and 3."""
    size = 64
    jm = jax_make_model(CLASSES, "resnet101", 16, crop,
                        backbone_structure=TINY)
    variables = jax_tiny_variables(jm, size, 0)
    x = np.random.RandomState(1).randn(1, size, size, 3).astype(np.float32)
    want, _ = jm.apply(variables, jnp.asarray(x), train=False,
                       interpolate=False)

    port = make_model(CLASSES, "resnet101", 16, crop,
                      backbone_structure=TINY).eval()
    port.load_state_dict(convert_jax_variables(variables))   # strict
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), interpolate=False)
    assert set(got) == {"seg", "center", "offset"}
    for k in got:
        g = got[k].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


def test_state_dict_converts_back_to_the_jax_tree():
    """convert_torch_cl4wsis(port.state_dict()) == the JAX variables,
    leaf for leaf: the port's state dict has the upstream key layout."""
    jm = jax_make_model(CLASSES, "resnet101", 16, 32,
                        backbone_structure=TINY)
    variables = jax_tiny_variables(jm, 64, 2)
    port = make_model(CLASSES, "resnet101", 16, 32, backbone_structure=TINY)
    port.load_state_dict(convert_jax_variables(variables))
    back = convert_torch_cl4wsis(port.state_dict(), abs_bn_weight=False)
    for coll in ("params", "batch_stats"):
        assert (jax.tree_util.tree_structure(back[coll]) ==
                jax.tree_util.tree_structure(variables[coll])), coll
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                       np.asarray(b)),
            back[coll], variables[coll])


def test_full_width_state_dict_matches_jax_leaves():
    """At full width (ResNet-101, 21 classes) every JAX leaf lands on one
    port tensor of the same size and no port tensor is left over: the
    carry-over covers the model the card serves."""
    jm = jax_make_model(CLASSES, "resnet101", 16, 512)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    zeros = {k: zeros[k] for k in ("params", "batch_stats")}
    port = make_model(CLASSES, "resnet101", 16, 512)
    port.load_state_dict(convert_jax_variables(zeros))       # strict
    assert "body.mod4.block23.convs.conv3.weight" in port.state_dict()
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax


@pytest.mark.parametrize("backbone,output_stride,norm_act", [
    ("resnet18", 16, "iabn_sync"), ("resnet34", 8, "iabn_sync"),
    ("resnet101", 8, "iabn_sync"), ("resnet18", 16, "abr"),
    ("resnet101", 16, "ain")])
def test_tiny_backbones_forward_and_convert_back_like_jax(
        backbone, output_stride, norm_act):
    """The basic-block ResNets, ResNet-101 at output stride 8 and the
    --norm_act norms, one block a stage: seg, center and offset at 64^2
    within atol=rtol=1e-4 in eval (the ResNet's center at 1/4, seg at the
    output stride), and the state dict converting back to the JAX tree
    leaf for leaf."""
    size = 64
    jm = jax_make_model(CLASSES, backbone, output_stride, 32,
                        norm_act=norm_act, backbone_structure=TINY)
    variables = jax_tiny_variables(jm, size, 3)
    x = np.random.RandomState(4).randn(1, size, size, 3).astype(np.float32)
    want, _ = jm.apply(variables, jnp.asarray(x), train=False,
                       interpolate=False)
    port = make_model(CLASSES, backbone, output_stride, 32,
                      norm_act=norm_act, backbone_structure=TINY).eval()
    port.load_state_dict(convert_jax_variables(variables))   # strict
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), interpolate=False)
    assert got["seg"].shape[2:] == (size // output_stride,) * 2
    assert got["center"].shape[2:] == (size // 4,) * 2
    for k in got:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    back = convert_torch_cl4wsis(port.state_dict(), abs_bn_weight=False)
    for coll in ("params", "batch_stats"):
        assert (jax.tree_util.tree_structure(back[coll]) ==
                jax.tree_util.tree_structure(variables[coll])), coll
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                       np.asarray(b)),
            back[coll], variables[coll])


@pytest.mark.parametrize("backbone", ["resnet18", "resnet34"])
def test_full_width_basic_block_nets_match_jax_leaves(backbone):
    """At full depth and width the basic-block nets' JAX leaves (by
    eval_shape) land one to one on the port's tensors, the parameter
    counts equal; res5 has 512 channels."""
    jm = jax_make_model(CLASSES, backbone, 16, 512)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    port = make_model(CLASSES, backbone, 16, 512)
    port.load_state_dict(convert_jax_variables(
        {k: zeros[k] for k in ("params", "batch_stats")}))   # strict
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax
    assert port.body.out_channels == backbone_channels(backbone) == 512
    assert port.body.feature_channels == {"res1": 64, "res2": 64,
                                          "res3": 128, "res4": 256,
                                          "res5": 512}
