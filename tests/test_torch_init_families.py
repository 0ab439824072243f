"""Fresh initialisation of the port against the JAX package, on the CPU.

Upstream sets two inits explicitly, and both packages draw them: the ASPP
head's convolutions take xavier-normal with the leaky-ReLU(0.01) gain, the
PeakGenerator's ``extra_conv4`` normal(0, sqrt(2 / new)) with a zero bias.
Every other layer of the port is built in torch's default family, which is
where the JAX package starts under ``--torch_init true`` (its
``models/torch_init.torch_family_init``). By default both packages start
those layers in flax's family: the port's trainer re-draws them with
``models/flax_init.flax_family_init``, held here per tensor against the
JAX package's own ``model.init`` (std, truncation bound, zero biases) and
in the pooled shape by a two-sample KS test, which the torch-family start
must fail. Each weight's std is held within 10 % of the JAX draw's; biases
that start at zero, and the norm layers' ones and zeros, exactly. The
trainer's wiring (which start each flag gives, the new classifier rows of
an incremental step, the PseudoLabeler, and the ``--torch_init true``
start bit for bit) is held on tiny ResNet-18 trainers.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from cl4wsis_tpu.models import make_model as jax_make_model
from cl4wsis_tpu.models.torch_init import DEFAULT_SKIP, torch_family_init
from cl4wsis_tpu.wss import PeakGenerator as JaxPG
from cl4wsis_tpu.wss import PseudoLabeler as JaxPL
from cl4wsis_tpu_torch.cl import tasks
from cl4wsis_tpu_torch.cl.ckpt import convert_jax_variables
from cl4wsis_tpu_torch.cli import config
from cl4wsis_tpu_torch.models import make_model
from cl4wsis_tpu_torch.models.flax_init import (TRUNC_STD, fan_in,
                                                flax_family_init)
from cl4wsis_tpu_torch.models.flax_init import DEFAULT_SKIP as PORT_SKIP
from cl4wsis_tpu_torch.train.trainer import Trainer
from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler
from torch_one_thread import one_torch_thread  # noqa: F401

STD_RTOL = 0.10
MIN_NUMEL = 1024       # the std is held on tensors of at least this size
KS_P = 1e-3            # the pooled shape's two-sample KS p-value floor
KS_N = 1 << 18         # values drawn from each pool for the KS test


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
            "pl_drawn": _port_keys(plv["params"]),
            "port": {k: v.detach() for k, v in port.state_dict().items()},
            "pl": {k: v.detach() for k, v in pl.state_dict().items()},
            "port_flax": _flax_start(port, seed=0),
            "pl_flax": _flax_start(pl, seed=1)}


def _flax_start(module, seed):
    """The port's default start of `module`: a copy, re-drawn in flax's
    families as the trainer does, as a state dict."""
    m = flax_family_init(copy.deepcopy(module),
                         torch.Generator().manual_seed(seed))
    return {k: v.detach() for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def fresh_ins():
    """The VOC 15-5 step-1 model with the instance branch (the Panoptic
    decoder's depthwise-separable convolutions, the centre and offset
    classifiers) on a ResNet-101 of one block a stage: JAX's init as
    drawn, the port's constructor and the port's flax start."""
    kw = dict(backbone_structure=(1, 1, 1, 1))
    jm = jax_make_model((16, 5), "resnet101", 16, 64, **kw)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)), train=False))()
    torch.manual_seed(0)
    port = make_model((16, 5), "resnet101", 16, 64, **kw)
    return {"drawn": _port_keys(v["params"]),
            "port": {k: v.detach() for k, v in port.state_dict().items()},
            "port_flax": _flax_start(port, seed=2)}


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


# ------------------------------------------------- flax's families

def _skipped(key):
    return any(p in PORT_SKIP for p in key.split("."))


def _checked(sd):
    """The conv and linear weights outside the skipped subtrees."""
    return sorted(k for k, v in sd.items() if k.endswith(".weight")
                  and v.dim() in (2, 4) and not _skipped(k))


def _std_misfits(sd, drawn):
    """The checked weights of at least MIN_NUMEL values whose std is off
    the JAX draw's of the same key by STD_RTOL or more."""
    bad = []
    for k in _checked(sd):
        if sd[k].numel() >= MIN_NUMEL:
            got, want = _std(sd[k]), _std(drawn[k])
            if abs(got / want - 1) >= STD_RTOL:
                bad.append((k, got, want))
    return bad


def _ks_p(sd, drawn, seed=0):
    """Two-sample KS p-value of the pooled w * sqrt(fan_in) * TRUNC_STD of
    every checked weight (a standard normal truncated to (-2, 2) in flax's
    family), KS_N values drawn from each pool."""
    keys = _checked(sd)
    scale = [np.sqrt(fan_in(sd[k])) * TRUNC_STD for k in keys]
    rs = np.random.RandomState(seed)
    pools = []
    for d in (sd, drawn):
        pool = np.concatenate([np.asarray(d[k], np.float64).ravel() * c
                               for k, c in zip(keys, scale)])
        pools.append(pool[rs.randint(0, pool.size, KS_N)])
    return stats.ks_2samp(*pools).pvalue


FLAX_CASES = {"model": ("fresh", "port", "port_flax", "drawn"),
              "pseudolabeler": ("fresh", "pl", "pl_flax", "pl_drawn"),
              "instance": ("fresh_ins", "port", "port_flax", "drawn")}


def _case(request, name):
    fixture, built, flax, drawn = FLAX_CASES[name]
    f = request.getfixturevalue(fixture)
    return f[built], f[flax], f[drawn]


@pytest.mark.parametrize("name", list(FLAX_CASES))
def test_flax_start_matches_jax_init_per_tensor(request, name):
    """The port's default start against the JAX package's model.init: each
    checked weight of >= MIN_NUMEL values at the JAX draw's std within
    STD_RTOL; every checked weight inside flax's truncation bound
    2 sqrt(1 / fan_in) / TRUNC_STD; every conv bias exactly 0; the skipped
    subtrees (the ASPP head, extra_conv4) as the port's constructor drew
    them, bit for bit."""
    built, flax, drawn = _case(request, name)
    keys = _checked(flax)
    assert set(keys) == set(_checked(drawn))
    assert sum(flax[k].numel() >= MIN_NUMEL for k in keys) >= 3
    assert not _std_misfits(flax, drawn)
    drawn_now = set(keys)
    for k in keys:
        bound = 2.0 * (1.0 / fan_in(flax[k])) ** 0.5 / TRUNC_STD
        assert float(flax[k].abs().max()) <= bound + 1e-6, k
        bias = k[:-len("weight")] + "bias"
        if bias in flax:
            assert not flax[bias].any(), bias
            drawn_now.add(bias)
    # the skipped subtrees and the norm layers: the constructor's
    kept = set(flax) - drawn_now
    assert any(_skipped(k) for k in kept) == (name != "pseudolabeler")
    for k in kept:
        assert torch.equal(flax[k], built[k]), k


def test_depthwise_fan_in_is_flaxs():
    """fan_in of a depthwise 5x5 conv is 25 (in / groups * kh * kw), as
    flax's HWIO (5, 5, 1, C) kernel with feature_group_count gives it."""
    conv = torch.nn.Conv2d(320, 320, 5, groups=320, bias=False)
    assert fan_in(conv.weight) == 25
    assert fan_in(torch.nn.Linear(7, 3).weight) == 7
    flax_family_init(conv, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(_std(conv.weight.detach()), 0.2,
                               rtol=STD_RTOL / 2)


@pytest.mark.parametrize("name", list(FLAX_CASES))
def test_flax_start_shape_passes_ks(request, name):
    """The pooled values of the port's default start and of the JAX draw
    come from one distribution: two-sample KS p > KS_P."""
    _, flax, drawn = _case(request, name)
    assert _ks_p(flax, drawn) > KS_P


@pytest.mark.parametrize("name", list(FLAX_CASES))
def test_family_checks_reject_the_torch_start(request, name):
    """Power: the port's torch-family start (its constructor's draw, the
    --torch_init true start) fails both the std check and the KS test."""
    built, _, drawn = _case(request, name)
    assert len(_std_misfits(built, drawn)) >= 3
    assert _ks_p(built, drawn) < KS_P


def test_flax_draw_leaves_the_global_stream():
    """The draw takes its own generator: torch's global stream goes on as
    if nothing had been drawn."""
    m = torch.nn.Conv2d(8, 8, 3)
    torch.manual_seed(5)
    want = torch.rand(4)
    torch.manual_seed(5)
    flax_family_init(m, torch.Generator().manual_seed(0))
    assert torch.equal(torch.rand(4), want)


# ---------------------------------------------- the trainer's wiring

TINY = ["--synthetic", "true", "--tiny", "true", "--backbone", "resnet18",
        "--dataset", "voc", "--task", "15-5", "--batch_size", "2",
        "--crop_size", "64", "--dtype", "float32", "--device", "cpu",
        "--name", "fam"]
PHASES = {"step 0": ["--step", "0", "--bce", "true"],
          "phase 1": ["--step", "1", "--weakly", "true", "--phase", "1"],
          "phase 2": ["--step", "1", "--weakly", "true", "--phase", "2"]}


def _cfg(run, torch_init, *extra):
    flag = ["--torch_init", "true"] if torch_init else []
    return config.parse_config(TINY + PHASES[run] + flag + list(extra))


def _family(sd, keys):
    """'flax' or 'torch': the start family of the conv weights `keys` (and
    their biases) by the pooled w * sqrt(fan_in), whose std is 1 in flax's
    family (truncated at 2 / TRUNC_STD) and 1 / sqrt(3) in torch's
    (uniform on +-1); None if neither."""
    pool = np.concatenate([np.asarray(sd[k], np.float64).ravel()
                           * np.sqrt(fan_in(sd[k])) for k in keys])
    biases = [sd[k[:-len("weight")] + "bias"] for k in keys
              if k[:-len("weight")] + "bias" in sd]
    std, top = pool.std(), np.abs(pool).max()
    if abs(std - 1) < STD_RTOL and top <= 2 / TRUNC_STD + 1e-5 and all(
            not b.any() for b in biases):
        return "flax"
    if abs(std * 3 ** 0.5 - 1) < STD_RTOL and top <= 1 + 1e-5 and all(
            b.any() for b in biases):
        return "torch"
    return None


@pytest.fixture(scope="module")
def step0_starts():
    """The step-0 trainer's model at default flags and with --torch_init
    true, as state dicts."""
    return {ti: Trainer(_cfg("step 0", ti), 1).model.state_dict()
            for ti in (False, True)}


@pytest.mark.parametrize("torch_init", [False, True])
def test_trainer_start_follows_torch_init(step0_starts, torch_init):
    """Step 0 at default flags starts in flax's families, with
    --torch_init true in torch's: the body, the decoder, the classifiers;
    the ASPP head keeps its xavier-normal draw in both."""
    sd = step0_starts[torch_init]
    want = "torch" if torch_init else "flax"
    parts = {p: [k for k in _checked(sd) if k.startswith(p)]
             for p in ("body.", "decoder.", "cls.", "instance_head.")}
    for p, keys in parts.items():
        assert keys and _family(sd, keys) == want, p
    head = [k for k in sd if k.startswith("head.")]
    assert head
    for k in head:
        assert torch.equal(sd[k], step0_starts[not torch_init][k]), k


@pytest.mark.parametrize("torch_init", [False, True])
def test_new_rows_and_pseudolabeler_keep_the_start(tmp_path, torch_init):
    """VOC 15-5 step 1 after load_step_ckpt of a step-0 checkpoint: the
    new classifier group (phase 1) and the new centre-classifier rows
    (phase 2) are in the start's family, as is the phase-1 PseudoLabeler;
    what came from the checkpoint is the checkpoint's."""
    want = "torch" if torch_init else "flax"
    t0 = Trainer(_cfg("step 0", torch_init), 1)
    path = str(tmp_path / "step0")
    t0.save(path, 0)
    s0 = t0.model.state_dict()
    for run, new in (("phase 1", "cls.1.weight"),
                     ("phase 2", "instance_head.classifier.center.cls.1."
                                 "weight")):
        t = Trainer(_cfg(run, torch_init), 1)
        t.load_step_ckpt(path)
        sd = t.model.state_dict()
        assert _family(sd, [new]) == want, (run, new)
        for k in s0:
            if k in sd and sd[k].shape == s0[k].shape:
                assert torch.equal(sd[k], s0[k]), (run, k)
        if run == "phase 1":
            pl = t.pseudolabeler.state_dict()
            assert _family(pl, _checked(pl)) == want


def test_torch_init_start_is_the_constructors_bit_for_bit():
    """Under --torch_init true the phase-1 trainer's model, old model,
    PseudoLabeler and PeakGenerator are what make_model and the modules'
    constructors draw under torch.manual_seed(seed), in that order."""
    cfg = _cfg("phase 1", True, "--seed", "7")
    t = Trainer(cfg, 1)
    fin = t.cfg
    mk = dict(backbone=fin.backbone, output_stride=fin.output_stride,
              crop_size=fin.crop_size, branch=fin.branch,
              norm_act=fin.norm_act, backbone_structure=(1, 1, 1, 1))
    torch.manual_seed(7)
    built = [make_model(tasks.get_per_task_classes("voc", "15-5", 1), **mk),
             make_model(tasks.get_per_task_classes("voc", "15-5", 0), **mk)]
    built.append(PseudoLabeler(21, in_channels=built[0].body.out_channels))
    built.append(PeakGenerator(20, 15, alpha=fin.pam_alpha))
    for m, want in zip((t.model, t.model_old, t.pseudolabeler,
                        t.peakgenerator), built):
        got, ref = m.state_dict(), want.state_dict()
        assert got.keys() == ref.keys()
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
