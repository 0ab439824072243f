"""Train-mode ABN's two ways to its batch statistics
(cl4wsis_tpu_torch.core.abn): the fused batch norm one rank takes and the
sums of x and x^2 that a run over several ranks takes (``summed_stats``
on one rank), each against cl4wsis_tpu/core/abn.py on the CPU in float32
(outputs within 1e-5, the moved running stats within 1e-6, the gradients
of the input, scale and bias within 1e-5 of their largest magnitude), and
against each other; one value a channel; a --remat recompute."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl4wsis_tpu.core.abn import ABN as JaxABN
from cl4wsis_tpu_torch.core import abn
from cl4wsis_tpu_torch.core.abn import ABN
from cl4wsis_tpu_torch.core.remat import checkpointed
from torch_one_thread import one_torch_thread  # noqa: F401

OUT_ATOL, STATS_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-5
C = 6
PATHS = {"fused": contextlib.nullcontext, "summed": abn.summed_stats}


def _variables(rs):
    return {"params": {"scale": rs.uniform(-1.5, 1.5, C).astype(np.float32),
                       "bias": (0.1 * rs.randn(C)).astype(np.float32)},
            "batch_stats": {"mean": (0.3 * rs.randn(C)).astype(np.float32),
                            "var": rs.uniform(0.5, 1.5, C).astype(np.float32)}}


def _port(v, activation):
    m = ABN(C, activation=activation).train()
    m.load_state_dict({
        "weight": torch.from_numpy(v["params"]["scale"].copy()),
        "bias": torch.from_numpy(v["params"]["bias"].copy()),
        "running_mean": torch.from_numpy(v["batch_stats"]["mean"].copy()),
        "running_var": torch.from_numpy(v["batch_stats"]["var"].copy())})
    return m


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _port_run(v, activation, x, g, path):
    """Output, running mean and var, and the gradients of the input, scale
    and bias of sum(out * g), through `path`."""
    m = _port(v, activation)
    xt = _nchw(x).requires_grad_(True)
    with PATHS[path]():
        out = m(xt)
    (out * _nchw(g)).sum().backward()
    return {"out": _nhwc(out), "mean": m.running_mean.numpy(),
            "var": m.running_var.numpy(), "x": _nhwc(xt.grad),
            "scale": m.weight.grad.numpy(), "bias": m.bias.grad.numpy()}


@pytest.mark.parametrize("shape", [(3, 5, 7), (4, 1, 1), (1, 1, 1)],
                         ids=["map", "pooled", "one_value"])
@pytest.mark.parametrize("activation", ["leaky_relu", "identity"])
@pytest.mark.parametrize("path", ["fused", "summed"])
def test_train_stats_match_jax(path, activation, shape):
    """Each path against the JAX module, also on a pooled map (one value
    a sample, as the ASPP head's image pooling) and on one value a channel
    (which the fused norm cannot take: ABN then takes the sums)."""
    rs = np.random.RandomState(len(path) + len(activation) + shape[0])
    x = (rs.randn(*shape, C) * 2 + 0.5).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    v = _variables(rs)
    jm = JaxABN(features=C, activation=activation)

    def jloss(params, xx):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, upd)

    (_, (want, upd)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    got = _port_run(v, activation, x, g, path)
    np.testing.assert_allclose(got["out"], np.asarray(want), rtol=0,
                               atol=OUT_ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[k], upd["batch_stats"][k], rtol=0,
                                   atol=STATS_ATOL)
    for k, w in (("x", gx), ("scale", gp["scale"]), ("bias", gp["bias"])):
        w = np.asarray(w)
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_RTOL * max(np.abs(w).max(),
                                                        1e-30))


def test_fused_and_summed_agree():
    """The two paths on one input: outputs and gradients within 1e-5 of
    their largest magnitude, running stats within 1e-6."""
    rs = np.random.RandomState(7)
    x = (rs.randn(4, 6, 6, C) + 1.0).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    v = _variables(rs)
    fused = _port_run(v, "leaky_relu", x, g, "fused")
    summed = _port_run(v, "leaky_relu", x, g, "summed")
    for k in ("out", "x", "scale", "bias"):
        np.testing.assert_allclose(fused[k], summed[k], rtol=0,
                                   atol=GRAD_RTOL * np.abs(summed[k]).max())
    for k in ("mean", "var"):
        np.testing.assert_allclose(fused[k], summed[k], rtol=0,
                                   atol=STATS_ATOL)


@pytest.mark.parametrize("spread", [1e-2, 1e-3])
def test_fused_holds_where_the_sums_cancel(spread):
    """Channels whose spread is a hundredth or a thousandth of their mean:
    E[x^2] - mean^2 in float32 loses the variance to cancellation, the
    fused norm does not. Its output stays within 1e-4 of the float64
    normalisation, the sums' lands over 1e-3 from it."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy((rs.randn(4, C, 6, 6) * spread + 1.0).astype(
        np.float32))
    x64 = x.double()
    mean = x64.mean((0, 2, 3), keepdim=True)
    var = x64.var((0, 2, 3), unbiased=False, keepdim=True)
    want = (x64 - mean) / torch.sqrt(var + 1e-5)
    err = {}
    for path, ctx in PATHS.items():
        with ctx(), torch.no_grad():
            got = ABN(C, activation="identity").train()(x)
        err[path] = float((got.double() - want).abs().max())
    assert err["fused"] < 1e-4 < 1e-3 < err["summed"], err


def test_summed_stats_is_scoped():
    """summed_stats routes ABN to the sums inside it and only there."""
    rs = np.random.RandomState(8)
    x = torch.from_numpy(rs.randn(2, C, 3, 3).astype(np.float32))
    m = ABN(C).train()
    calls = []
    real = abn.batch_stats

    def counting(xf):
        calls.append(xf.shape)
        return real(xf)
    abn.batch_stats = counting
    try:
        m(x)
        with abn.summed_stats():
            m(x)
        m(x)
    finally:
        abn.batch_stats = real
    assert calls == [(2, C, 3, 3)]


@pytest.mark.parametrize("path", ["fused", "summed"])
def test_remat_recompute_moves_running_stats_once(path):
    """Through a checkpointed block the forward moves the running stats
    and the recompute in the backward does not: they end where one plain
    forward leaves them, with the same gradient."""
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(3, C, 4, 4).astype(np.float32))
    v = _variables(rs)
    plain, remat = _port(v, "leaky_relu"), _port(v, "leaky_relu")
    xp, xr = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    with PATHS[path]():
        plain(xp).square().sum().backward()
        checkpointed(remat, xr).square().sum().backward()
    for k in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(remat, k), getattr(plain, k),
                                   rtol=0, atol=0)
    torch.testing.assert_close(xr.grad, xp.grad, rtol=0, atol=0)
