"""torch_family_init: distribution-golden vs real torch layers, path rules."""

import jax
import jax.numpy as jnp
import numpy as np

from cl4wsis_tpu.models.torch_init import torch_family_init
from torch_one_thread import one_torch_thread  # noqa: F401


def _moments(a):
    a = np.asarray(a, np.float64).ravel()
    return a.mean(), a.std(), np.abs(a).max()


def test_default_matches_torch_conv2d_reset_parameters():
    """Kernel+bias stats match torch nn.Conv2d defaults: U(+-1/sqrt(fan_in)),
    i.e. kaiming_uniform(a=sqrt(5)) — transcription golden below."""
    import torch

    cin, cout, k = 64, 128, 3
    t = torch.nn.Conv2d(cin, cout, k)
    tw, tb = t.weight.detach().numpy(), t.bias.detach().numpy()

    params = {"conv": {"kernel": jnp.zeros((k, k, cin, cout)),
                       "bias": jnp.zeros((cout,))}}
    out = torch_family_init(params, jax.random.PRNGKey(0))
    fan_in = k * k * cin
    bound = 1.0 / np.sqrt(fan_in)
    # torch draws from the same family: bounds agree
    assert np.abs(tw).max() <= bound + 1e-7
    assert np.abs(tb).max() <= bound + 1e-7
    _, sw, mw = _moments(out["conv"]["kernel"])
    assert mw <= bound + 1e-7
    # std of U(-b, b) is b/sqrt(3); 73k samples -> tight
    np.testing.assert_allclose(sw, bound / np.sqrt(3), rtol=0.02)
    _, _, mb = _moments(out["conv"]["bias"])
    assert mb <= bound + 1e-7


def test_he_normal_paths_match_torch_kaiming_normal():
    import torch

    cin, cout, k = 256, 256, 3
    w = torch.empty(cout, cin, k, k)
    torch.nn.init.kaiming_normal_(w)
    params = {"gci": {"conv1": {"kernel": jnp.zeros((k, k, cin, cout))}}}
    out = torch_family_init(params, jax.random.PRNGKey(1),
                            he_normal_paths=("gci",))
    _, s_ours, _ = _moments(out["gci"]["conv1"]["kernel"])
    _, s_torch, _ = _moments(w.numpy())
    np.testing.assert_allclose(s_ours, s_torch, rtol=0.02)
    np.testing.assert_allclose(s_ours, np.sqrt(2.0 / (k * k * cin)), rtol=0.02)


def test_pseudolabeler_gets_torch_default_family():
    """Round-5 ADVICE fix: the reference PseudoLabeler (wss/modules.py:322-333)
    has NO explicit init — torch's default kaiming-uniform(a=sqrt(5)) — so by
    default its convs must be U(+-1/sqrt(fan_in)), not kaiming-normal."""
    cin, cout, k = 256, 64, 3
    params = {"pseudolabeler": {"conv1": {"kernel":
                                          jnp.zeros((k, k, cin, cout))}}}
    out = torch_family_init(params, jax.random.PRNGKey(3))
    kern = np.asarray(out["pseudolabeler"]["conv1"]["kernel"], np.float64)
    bound = 1.0 / np.sqrt(k * k * cin)
    assert np.abs(kern).max() <= bound + 1e-7  # uniform family, not normal
    np.testing.assert_allclose(kern.std(), bound / np.sqrt(3), rtol=0.03)


def test_skip_paths_and_non_kernel_leaves_untouched():
    params = {
        "seg_head": {"c": {"kernel": jnp.ones((3, 3, 8, 8))}},
        "peakgenerator": {"extra_conv4": {"kernel": jnp.ones((1, 1, 4, 4))}},
        "norm": {"scale": jnp.ones((8,)), "bias": jnp.zeros((8,))},
        "head": {"kernel": jnp.zeros((1, 1, 8, 4)), "bias": jnp.zeros((4,))},
    }
    out = torch_family_init(params, jax.random.PRNGKey(2))
    np.testing.assert_array_equal(out["seg_head"]["c"]["kernel"], 1.0)
    np.testing.assert_array_equal(
        out["peakgenerator"]["extra_conv4"]["kernel"], 1.0)
    # norm scale/bias: no sibling kernel -> untouched (BN init agrees anyway)
    np.testing.assert_array_equal(out["norm"]["scale"], 1.0)
    np.testing.assert_array_equal(out["norm"]["bias"], 0.0)
    # plain head re-sampled, nonzero
    assert np.abs(np.asarray(out["head"]["kernel"])).max() > 0
    assert np.abs(np.asarray(out["head"]["bias"])).max() > 0


def test_trainer_flag_changes_scale():
    """--torch_init shrinks fresh backbone kernels to torch's 1/3 variance."""
    from cl4wsis_tpu.cli.config import Config
    from cl4wsis_tpu.train.trainer import Trainer

    def build(ti):
        cfg = Config(dataset="voc", task="15-5", step=0, name="T",
                     batch_size=2, crop_size=32, epochs=1, synthetic=True,
                     tiny=True, torch_init=ti, dtype="float32")
        cfg.finalize()
        return Trainer(cfg, iters_per_epoch=1)

    v_def = build(False).variables["params"]
    v_ti = build(True).variables["params"]
    k_def = np.asarray(
        jax.tree_util.tree_leaves(v_def["body"])[0], np.float64)
    def first_kernel(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        for path, leaf in flat:
            if getattr(path[-1], "key", "") == "kernel":
                return np.asarray(leaf, np.float64), path
        raise AssertionError("no kernel leaf")
    k_def, p1 = first_kernel(v_def["body"])
    k_ti, p2 = first_kernel(v_ti["body"])
    assert p1 == p2 and k_def.shape == k_ti.shape
    fan_in = int(np.prod(k_def.shape[:-1]))
    # flax default: lecun normal, std 1/sqrt(fan); torch: U std 1/sqrt(3 fan)
    np.testing.assert_allclose(k_def.std(), 1 / np.sqrt(fan_in), rtol=0.25)
    np.testing.assert_allclose(k_ti.std(), 1 / np.sqrt(3 * fan_in), rtol=0.25)
    assert np.abs(k_ti).max() <= 1 / np.sqrt(fan_in) + 1e-7
