"""The port's --norm_act norms (cl4wsis_tpu_torch.core.norms: AIN and ABR,
and ABN's ELU) against cl4wsis_tpu/core/norms.py on the CPU in float32:
outputs within 1e-5, the moved running stats within 1e-6, the gradients of
the input, scale and bias (through jax.grad) within 1e-5 of their largest
magnitude; norm_factory's mapping; and both norms through the CLI."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl4wsis_tpu.core.abn import ABN as JaxABN
from cl4wsis_tpu.core.norms import ABR as JaxABR
from cl4wsis_tpu.core.norms import AIN as JaxAIN
from cl4wsis_tpu.core.norms import norm_factory as jax_norm_factory
from cl4wsis_tpu_torch.core.abn import ABN
from cl4wsis_tpu_torch.core.norms import ABR, AIN, norm_factory
from tests.test_data import _write_fake_voc
from tests.test_torch_cli_data import STEP0, _results, _run

OUT_ATOL, STATS_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-5
C = 6
NORMS = {"ain": (AIN, JaxAIN), "abr": (ABR, JaxABR), "abn": (ABN, JaxABN)}


def _variables(rs):
    return {"params": {"scale": rs.uniform(-1.5, 1.5, C).astype(np.float32),
                       "bias": (0.1 * rs.randn(C)).astype(np.float32)},
            "batch_stats": {"mean": (0.3 * rs.randn(C)).astype(np.float32),
                            "var": rs.uniform(0.5, 1.5, C).astype(np.float32)}}


def _port(cls, v, activation, train):
    m = cls(C, activation=activation).train(train)
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


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("activation", ["leaky_relu", "elu", "identity"])
@pytest.mark.parametrize("norm", ["ain", "abr", "abn"])
def test_norm_matches_jax(norm, activation, train):
    """Output, running stats, and the gradients of a random projection of
    the output with respect to the input, scale and bias."""
    cls, jcls = NORMS[norm]
    rs = np.random.RandomState(len(norm) + len(activation))
    x = (rs.randn(3, 5, 7, C) * 2 + 0.5).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    v = _variables(rs)
    jm = jcls(features=C, activation=activation)

    def jloss(params, xx):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=train, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, upd)

    (_, (want, upd)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    m = _port(cls, v, activation, train)
    xt = _nchw(x).requires_grad_(True)
    out = m(xt)
    (out * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), rtol=0,
                               atol=OUT_ATOL)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(m.running_mean.numpy(), stats["mean"],
                               rtol=0, atol=STATS_ATOL)
    np.testing.assert_allclose(m.running_var.numpy(), stats["var"],
                               rtol=0, atol=STATS_ATOL)
    for got, w in ((_nhwc(xt.grad), gx), (m.weight.grad.numpy(),
                                          gp["scale"]),
                   (m.bias.grad.numpy(), gp["bias"])):
        w = np.asarray(w)
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())
    if norm == "abr":    # JAX's momentum 1.0: frozen running stats
        np.testing.assert_array_equal(m.running_var.numpy(),
                                      v["batch_stats"]["var"])


@pytest.mark.parametrize("norm", ["ain", "abr"])
def test_norm_keeps_the_input_dtype_with_float32_statistics(norm):
    """bf16 in, bf16 out; the statistics and the running stats in float32,
    equal to the float32 norm's of the same (rounded) input."""
    cls, _ = NORMS[norm]
    rs = np.random.RandomState(3)
    v = _variables(rs)
    x = torch.from_numpy(rs.randn(2, C, 5, 5).astype(np.float32)).bfloat16()
    m16, m32 = _port(cls, v, "leaky_relu", True), _port(cls, v,
                                                        "leaky_relu", True)
    y16, y32 = m16(x), m32(x.float())
    assert y16.dtype == torch.bfloat16 and m16.running_var.dtype == \
        torch.float32
    torch.testing.assert_close(y16, y32.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(m16.running_mean, m32.running_mean, rtol=0,
                               atol=0)


def test_abr_r_and_d_carry_no_gradient():
    """With the running stats equal to the batch's, r = 1 and d = 0, so
    ABR's output equals ABN's; the scale and bias gradients then also
    equal ABN's, which they would not if r and d were differentiated."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(4, C, 6, 6).astype(np.float32))
    xx = x.permute(1, 0, 2, 3).reshape(C, -1)
    n = xx.shape[1]
    mods = [cls(C) for cls in (ABR, ABN)]
    for m in mods:
        m.running_mean.copy_(xx.mean(1))
        m.running_var.copy_(xx.var(1, unbiased=False) * n / (n - 1))
        with torch.no_grad():
            m.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                              .manual_seed(0))
        (m(x) * torch.linspace(-1, 1, x.numel()).view(x.shape)).sum() \
            .backward()
    abr, abn = mods
    for a, b in ((abr.weight.grad, abn.weight.grad),
                 (abr.bias.grad, abn.bias.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flag", ["abr", "iabr", "ain", "iabn_sync", "iabn",
                                  "anything"])
def test_norm_factory_maps_as_jax(flag):
    want = {JaxABR: ABR, JaxAIN: AIN}.get(jax_norm_factory(flag), ABN)
    assert norm_factory(flag) is want


@pytest.mark.parametrize("norm_act,cls", [("abr", ABR), ("ain", AIN)])
def test_cli_alternative_norm(tmp_path, norm_act, cls):
    """--norm_act abr / ain trains step 0 through the CLI on the mini-VOC
    (the port of tests/test_cli_voc.py's abr case; the ABR run with
    --remat) and validates: every body and head norm is of the flag's
    class, ABR's running stats stay frozen and AIN's move."""
    root = str(tmp_path)
    _write_fake_voc(root, n_images=8, size=48)   # 4 with the base class
    made = []
    remat = ["--remat", "true"] if cls is ABR else []
    try:
        assert _run(root, STEP0 + ["--name", "n", "--norm_act", norm_act,
                                   "--batch_size", "4"] + remat,
                    rec=made.append) == 0
        (r,) = _results(root, "n")
        assert np.isfinite(r["map"])
        model = made[0].model
        assert model.body.remat == bool(remat)
        norms = [m for m in model.body.modules() if hasattr(m, "running_var")]
        assert norms and all(type(m) is cls for m in norms)
        assert type(model.head.red_bn) is cls
        moved = [not torch.equal(m.running_var, torch.ones_like(
            m.running_var)) for m in norms]
        assert (not any(moved)) if cls is ABR else all(moved)
    finally:
        shutil.rmtree(tmp_path / "ck", ignore_errors=True)
