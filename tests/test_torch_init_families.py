"""Fresh initialisation of the port against the JAX package, on the CPU.

Upstream sets two inits explicitly, and both packages draw them: the ASPP
head's convolutions take xavier-normal with the leaky-ReLU(0.01) gain, the
PeakGenerator's ``extra_conv4`` normal(0, sqrt(2 / new)) with a zero bias.
Every other layer of the port takes torch's default, which is where the
JAX package starts under ``--torch_init true`` (its
``models/torch_init.torch_family_init``). Each weight's std is held within
10 % of the JAX draw's; biases that start at zero, and the norm layers'
ones and zeros, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl4wsis_tpu.models import make_model as jax_make_model
from cl4wsis_tpu.models.torch_init import DEFAULT_SKIP, torch_family_init
from cl4wsis_tpu.wss import PeakGenerator as JaxPG
from cl4wsis_tpu.wss import PseudoLabeler as JaxPL
from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler

STD_RTOL = 0.10


def _std(t) -> float:
    return float(np.asarray(t, np.float64).std())


def _port_keys(params):
    return convert_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, params)})


@pytest.fixture(scope="module")
def fresh():
    """The VOC 15-5 step-1 model without the instance branch and its
    PseudoLabeler, fresh: JAX's init as drawn, JAX's init after
    torch_family_init (the --torch_init start), and the port's."""
    jm = jax_make_model((16, 5), "resnet101", 16, 512, branch="none")
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)), train=False))()
    plv = JaxPL(num_classes=21).init(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 4, 4, 2048)), train=False)
    tree = torch_family_init({"model": v["params"],
                              "pseudolabeler": plv["params"]},
                             jax.random.PRNGKey(77), skip_paths=DEFAULT_SKIP)
    torch.manual_seed(0)
    port = make_model((16, 5), "resnet101", 16, 512, branch="none")
    pl = PseudoLabeler(21)
    return {"drawn": _port_keys(v["params"]),
            "torch_init": _port_keys(tree["model"]),
            "pl_torch_init": _port_keys(tree["pseudolabeler"]),
            "port": {k: v.detach() for k, v in port.state_dict().items()},
            "pl": {k: v.detach() for k, v in pl.state_dict().items()}}


def _weights(sd, prefix=""):
    return sorted(k for k, v in sd.items()
                  if k.startswith(prefix) and k.endswith(".weight")
                  and v.dim() == 4)


def test_aspp_head_is_xavier_normal_as_in_jax(fresh):
    """The head's seven convolutions: JAX's explicit init as drawn, and the
    port's, within 10 % in std; both far from torch's default (which read
    2.45-3.27x smaller before the port set the init)."""
    keys = _weights(fresh["port"], "head.")
    assert len(keys) == 7, keys
    for k in keys:
        want, got = _std(fresh["drawn"][k]), _std(fresh["port"][k])
        fan = np.prod(fresh["port"][k].shape[1:])
        default = 1.0 / np.sqrt(3.0 * fan)     # kaiming-uniform(a=sqrt(5))
        assert abs(got / want - 1) < STD_RTOL, (k, got, want)
        assert want / default > 2.0, (k, want, default)


def test_every_conv_std_matches_jax_torch_init(fresh):
    """Every convolution of the model (body, head, classifiers) and of the
    PseudoLabeler against the JAX package's --torch_init start."""
    for sd, ref in ((fresh["port"], fresh["torch_init"]),
                    (fresh["pl"], fresh["pl_torch_init"])):
        keys = _weights(sd)
        assert set(keys) == set(_weights(ref))
        for k in keys:
            got, want = _std(sd[k]), _std(ref[k])
            assert abs(got / want - 1) < STD_RTOL, (k, got, want)
    assert len(_weights(fresh["port"], "body.")) == 104


def test_norm_layers_start_as_in_jax(fresh):
    """ABN weights 1, biases 0, running mean 0 and var 1, exactly."""
    drawn = fresh["drawn"]
    bn = [k for k, v in fresh["port"].items() if v.dim() == 1
          and not k.startswith("cls.")]
    assert len(bn) > 400
    for k in bn:
        if k in drawn:
            assert torch.equal(fresh["port"][k], drawn[k]), k
        else:
            want = 1.0 if k.endswith("running_var") else 0.0
            assert bool((fresh["port"][k] == want).all()), k


def test_peakgenerator_extra_conv4_init_matches_jax():
    """PeakGenerator(20, 15): 5 x 5 weights, pooled over 40 seeds on each
    side, std within 10 % (both near sqrt(2 / 5)); the bias exactly 0."""
    init = jax.jit(lambda key: JaxPG(num_classes=20, old_classes=15).init(
        key, jnp.zeros((1, 4, 4, 21)), train=True)["params"]["extra_conv4"])
    jax_w, port_w = [], []
    for seed in range(40):
        p = init(jax.random.PRNGKey(seed))
        assert not np.asarray(p["bias"]).any()
        jax_w.append(np.asarray(p["kernel"]).ravel())
        torch.manual_seed(seed)
        conv = PeakGenerator(20, 15).extra_conv4
        assert conv.weight.shape == (5, 5, 1, 1)
        assert torch.equal(conv.bias, torch.zeros(5))
        port_w.append(conv.weight.detach().numpy().ravel())
    want, got = _std(np.concatenate(jax_w)), _std(np.concatenate(port_w))
    assert abs(got / want - 1) < STD_RTOL, (got, want)
    assert abs(got / np.sqrt(2 / 5) - 1) < STD_RTOL
