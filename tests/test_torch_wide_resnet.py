"""The port's WideResNet-38 A2 (cl4wsis_tpu_torch.models.wide_resnet) and
the model around it against cl4wsis_tpu on the CPU in float32, weights
carried over by cl4wsis_tpu_torch.cl.ckpt.convert_jax_variables:

* a WideResNet of one block a module (structure (1,)*6, full widths) in
  eval and in train mode with JAX's recorded dropout masks: res1..res5
  within 1e-4 (eval: of each value, atol and rtol; train: of the
  feature's largest magnitude, as every norm there sums its float32
  batch statistics in another order), the moved BN statistics within
  1e-5;
* the stride, dilation and pooling schedule of its blocks;
* the full-width WideResNet-38 model of the COCO-to-VOC recipe key for key
  against JAX's by jax.eval_shape, and its parameter count;
* convert_torch_cl4wsis(port.state_dict()) equal to the JAX tree, leaf
  for leaf, and the whole OS8 model's seg, center and offset within 1e-4
  at 64^2 (the decoder at 1/8);
* --remat: one train step's gradients equal to those without (1e-6
  relative), its running stats and the generator's state equal.

The JAX model takes WideResNet-38's structure from its module; the tests
give it (1,)*6 through a subclass while its calls run (jax_wrn16)."""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cl4wsis_tpu.models.wide_resnet as jax_wide_resnet
from cl4wsis_tpu.cl.ckpt import convert_torch_cl4wsis
from cl4wsis_tpu.models import make_model as jax_make_model
from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.models.assembly import backbone_channels
from cl4wsis_tpu_torch.models.resnet import ResNet
from cl4wsis_tpu_torch.models.wide_resnet import (WiderResNet38A2,
                                                  wider_resnet16_a2)
from tests.test_torch_model import jax_tiny_variables
from torch_one_thread import one_torch_thread  # noqa: F401

WRN16 = (1, 1, 1, 1, 1, 1)
SIZE = 32
CLASSES = (3, 2)
FEAT_ATOL, STATS_ATOL = 1e-4, 1e-5


class _JaxWRN16(jax_wide_resnet.WiderResNet38A2):
    structure: tuple = WRN16


@contextlib.contextmanager
def jax_wrn16():
    """While open, the JAX model builds WideResNet bodies of one block a
    module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_wide_resnet, "WiderResNet38A2", _JaxWRN16)
        yield


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


class _JitInit:
    """A JAX module whose init is jitted (flax's eager init of a WideResNet
    takes several times as long), for jax_tiny_variables."""

    def __init__(self, module):
        self.init = jax.jit(module.init, static_argnames="train")


def _body_state(variables):
    sd = convert_jax_variables({c: {"body": variables[c]}
                                for c in ("params", "batch_stats")})
    return {k[len("body."):]: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def body16():
    """JAX's WRN-16 body with randomised norms, and the port's with its
    weights."""
    jb = _JaxWRN16()
    v = jax_tiny_variables(_JitInit(jb), SIZE, 0)
    port = WiderResNet38A2(WRN16)
    port.load_state_dict(_body_state(v))          # strict
    return jb, v, port


class _RecordedDropout(torch.nn.Module):
    """A JAX run's dropout mask (NHWC), applied as flax applies it."""

    def __init__(self, keep_nhwc, p):
        super().__init__()
        self.keep = torch.from_numpy(keep_nhwc).permute(0, 3, 1, 2)
        self.p = p

    def forward(self, x, generator=None):
        return torch.where(self.keep, x / (1.0 - self.p), 0.0)


def test_body_eval_matches_jax(body16):
    jb, v, port = body16
    x = np.random.RandomState(1).randn(2, SIZE, SIZE, 3).astype(np.float32)
    want = jb.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    assert list(got) == [f"res{i}" for i in range(1, 6)]
    for k, w in want.items():
        assert got[k].shape[1] == port.feature_channels[k]
        np.testing.assert_allclose(_nhwc(got[k]), np.asarray(w), rtol=1e-4,
                                   atol=FEAT_ATOL, err_msg=k)


def test_body_train_matches_jax_with_its_dropout_masks(body16):
    """Train mode: batch statistics in every norm, dropout 0.3 in mod6 and
    0.5 in mod7 with the masks the JAX run drew."""
    jb, v, port = body16
    x = np.random.RandomState(2).randn(2, SIZE, SIZE, 3).astype(np.float32)
    seen = {}

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.module.name == "drop":
            seen[context.module.scope.path[0]] = (
                np.asarray(out) != 0, context.module.rate)
        return out

    with fnn.intercept_methods(intercept):
        want, upd = jb.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(3)})
    assert set(seen) == {"mod6_block1", "mod7_block1"}
    port = WiderResNet38A2(WRN16)
    port.load_state_dict(_body_state(v))
    for path, (keep, p) in seen.items():
        mod, block = path.split("_")
        getattr(getattr(port, mod), block).drop = _RecordedDropout(keep, p)
        assert 0.5 * (1 - p) < keep.mean() < 1.2 * (1 - p)
    got = port.train()(_nchw(x))
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(_nhwc(got[k]), w, rtol=0,
                                   atol=FEAT_ATOL * np.abs(w).max(),
                                   err_msg=k)
    sd = port.state_dict()
    stats = _body_state({"params": {}, "batch_stats":
                         jax.tree_util.tree_map(np.asarray,
                                                upd["batch_stats"])})
    assert len(stats) == 2 * 15
    for k, w in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0,
                                   atol=STATS_ATOL, err_msg=k)


def test_block_schedule():
    """/2 pools before mod2 and mod3, stride 2 at mod4.block1 only,
    dilation 1 / 2 / 4 in mod2-4 / mod5 / mod6-7, dropout 0.3 and 0.5 in
    mod6 and mod7; the features at /4 (res1) and /8."""
    net = WiderResNet38A2((2, 1, 2, 2, 2, 1))
    for i in range(2, 8):
        for j, block in enumerate(getattr(net, f"mod{i}")):
            first = block.convs.conv1
            stride = 2 if (i, j) == (4, 0) else 1
            assert first.stride == (stride, stride), (i, j)
            dil = {5: 2, 6: 4, 7: 4}.get(i, 1)
            assert block.convs.conv2.dilation == (dil, dil), (i, j)
            p = {6: 0.3, 7: 0.5}.get(i)
            assert (block.drop is None) == (p is None) and (
                p is None or block.drop.p == p), (i, j)
            assert (block.proj_conv is not None) == (j == 0), (i, j)
    with torch.no_grad():
        out = wider_resnet16_a2().eval()(torch.zeros(1, 3, 64, 64))
    assert {k: tuple(v.shape[1:]) for k, v in out.items()} == {
        "res1": (256, 16, 16), "res2": (512, 8, 8), "res3": (1024, 8, 8),
        "res4": (2048, 8, 8), "res5": (4096, 8, 8)}


def _shape_zeros(jm, size):
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    return shapes, {k: zeros[k] for k in ("params", "batch_stats")}


def test_full_width_recipe_model_matches_jax_leaves():
    """make_model((61, 20), "wider_resnet38_a2", 8, 448), the COCO-to-VOC
    step-1 model: every JAX leaf (by eval_shape) lands on one port tensor
    of its size, no port tensor is left over, the parameter counts are
    equal; the decoder reads WideResNet's channels."""
    jm = jax_make_model((61, 20), "wider_resnet38_a2", 8, 448)
    shapes, zeros = _shape_zeros(jm, 64)
    port = make_model((61, 20), "wider_resnet38_a2", 8, 448)
    port.load_state_dict(convert_jax_variables(zeros))       # strict
    sd = port.state_dict()
    assert "body.mod4.block6.convs.conv2.weight" in sd
    assert "body.mod7.block1.convs.conv3.weight" in sd
    assert sd["body.bn_out.weight"].shape == (4096,)
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax
    assert port.body.out_channels == backbone_channels(
        "wider_resnet38_a2") == 4096
    assert port.body.feature_channels == {"res1": 256, "res2": 512,
                                          "res3": 1024, "res4": 2048,
                                          "res5": 4096}


@pytest.fixture(scope="module")
def model16():
    """The OS8 WideResNet model (structure (1,)*6, classes (3, 2)) of JAX,
    its randomised variables, and the port's over them."""
    with jax_wrn16():
        jm = jax_make_model(CLASSES, "wider_resnet38_a2", 8, 64)
        v = jax_tiny_variables(_JitInit(jm), 64, 5)
    port = make_model(CLASSES, "wider_resnet38_a2", 8, 64,
                      backbone_structure=WRN16)
    port.load_state_dict(convert_jax_variables(v))           # strict
    return jm, v, port


def test_state_dict_converts_back_to_the_jax_tree(model16):
    jm, v, port = model16
    back = convert_torch_cl4wsis(port.state_dict(), abs_bn_weight=False)
    for coll in ("params", "batch_stats"):
        assert (jax.tree_util.tree_structure(back[coll]) ==
                jax.tree_util.tree_structure(v[coll])), coll
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                       np.asarray(b)),
            back[coll], v[coll])


def test_os8_model_forward_matches_jax(model16):
    """seg, center and offset at the network's strides: 1/8 for all three
    on WideResNet (a ResNet's center is at 1/4), at 64^2."""
    jm, v, port = model16
    x = np.random.RandomState(6).randn(1, 64, 64, 3).astype(np.float32)
    with jax_wrn16():
        want, _ = jax.jit(lambda v, x: jm.apply(
            v, x, train=False, interpolate=False))(v, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(_nchw(x), interpolate=False)
    for k in ("seg", "center", "offset"):
        assert got[k].shape[2:] == (8, 8), k
        np.testing.assert_allclose(_nhwc(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def _train_step(body, x, seed):
    """One train-mode forward and backward of a body from a generator
    seeded with `seed`: (gradients, running stats, the generator's state
    after)."""
    gen = torch.Generator().manual_seed(seed)
    body.train()
    body.zero_grad(set_to_none=True)
    out = body(x, gen)
    loss = sum((v * torch.linspace(-1, 1, v.numel()).view(v.shape)).sum()
               for v in out.values())
    loss.backward()
    grads = {k: p.grad.clone() for k, p in body.named_parameters()
             if p.grad is not None}
    stats = {k: b.clone() for k, b in body.named_buffers()}
    return grads, stats, gen.get_state()


@pytest.mark.parametrize("make", [
    lambda remat: WiderResNet38A2(WRN16, remat=remat),
    lambda remat: ResNet((1, 1, 1, 1), 8, remat=remat),
    lambda remat: ResNet((1, 1, 1, 1), 16, bottleneck=False, remat=remat)],
    ids=["wider_resnet16", "resnet101_tiny_os8", "resnet18_tiny"])
def test_remat_step_equals_the_step_without(make):
    """The same weights, batch and generator with and without --remat (the
    bodies hold every checkpointed block): gradients within 1e-6 relative
    per tensor, running stats moved once (equal), the generator at the
    same state (the recompute redrew WideResNet's dropout masks from the
    saved state and handed the generator back)."""
    torch.manual_seed(0)
    plain, remat = make(False), make(True)
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 3, 32, 32)
                         .astype(np.float32))
    g0, s0, r0 = _train_step(plain, x, 11)
    g1, s1, r1 = _train_step(remat, x, 11)
    assert g0.keys() == g1.keys() and len(g0) > 20
    for k in g0:
        err = float((g1[k] - g0[k]).norm() / max(g0[k].norm(), 1e-30))
        assert err <= 1e-6, (k, err)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=0, msg=k)
    assert torch.equal(r0, r1)
    moved = [k for k in s0 if "running_var" in k and
             not torch.equal(s0[k], torch.ones_like(s0[k]))]
    assert len(moved) > 8
