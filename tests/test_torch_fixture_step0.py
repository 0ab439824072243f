"""The painted-fixture protocol's step 0 (the flags of
scripts/run_rebuild_fixture_torch.py) against the JAX package's on the
CPU: the fixture's first epoch through the port's loader, the tiny model
from the same weights, the two step-0 train steps with the protocol's
optimizer and schedule; then one step of each from JAX's state after that
epoch, carried into the port with its Adam moments, count and step
(cl4wsis_tpu_torch.cl.ckpt.convert_jax_adam). One JAX run, compiled once,
serves every test here."""

import numpy as np
import pytest

from fixture_curves import (BATCHES_PER_EPOCH, KEYS, carried_step,
                            dropout_stats, fixture_batches, init_variables,
                            jax_fresh_state, jax_model, jax_step, jax_steps,
                            port_losses, write_fixture)
from test_torch_step0 import UPDATE_RTOL
from torch_one_thread import one_torch_thread  # noqa: F401

# The protocol's step 0 (Adam 3e-4, poly over 250 epochs of 12 batches,
# BCE, sigma 6) on the fixture's first epoch, from the same weights, with
# the decoder's dropout off in both. The steps are ill-conditioned in
# float32 (every BN on 4 images; see tests/test_torch_step0.py): the
# first step's loss agrees to 1e-6, later ones part by up to ~10 % in the
# center term; the first epoch's means agree within 0.4 % (a learning
# rate 1.5x the protocol's reads 7.8 %), and over 10 epochs the epoch
# means hold within 4.3 %, neither package ahead from one run to the next
# (tests/fixture_curves.py steps).
EPOCH_RTOL = 0.02
# One step from JAX's state after the epoch: Adam's moments carry 12 steps
# of history, so the port's update reads at most 0.0039 of JAX's and its
# moments part by at most 0.0023 (one or two torch threads). With fresh
# moments in the port the update reads 4.77 and the moments 1.04 / 0.99;
# with Adam's step one ahead the update reads 0.0054, which only the
# step counts show.
MOMENT_RTOL = 0.02


@pytest.fixture(scope="module")
def epoch_run(tmp_path_factory):
    """The fixture's first epoch and the batch after it, JAX's losses over
    the epoch from its init, and its state after the epoch."""
    root = str(tmp_path_factory.mktemp("fixture"))
    write_fixture(root)
    batches = fixture_batches(root, BATCHES_PER_EPOCH + 1)
    jm = jax_model()
    variables = init_variables(jm)
    tx, state = jax_fresh_state(variables)
    step = jax_step(jm, tx)
    want, state = jax_steps(step, state, batches[:-1])
    return {"batches": batches, "want": want, "variables": variables,
            "step": step, "state": state}


def test_step0_on_the_fixture_tracks_jax(epoch_run):
    want = epoch_run["want"]
    got = port_losses(epoch_run["batches"][:-1], epoch_run["variables"])
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-6)
    for k in KEYS:
        g, w = (np.mean([m[k] for m in ms]) for ms in (got, want))
        assert abs(g / w - 1) < EPOCH_RTOL, (k, g, w)


def test_step_from_a_carried_jax_state_matches_jax(epoch_run):
    """JAX's weights, BN statistics, Adam moments, count and step after
    the epoch go into the port; one step in each on the next batch: every
    parameter tensor's update within UPDATE_RTOL of JAX's, both moments
    within MOMENT_RTOL, both step counts and Adam's at 13."""
    r = carried_step(epoch_run["step"], epoch_run["state"],
                     epoch_run["batches"][-1], BATCHES_PER_EPOCH)
    assert r["steps"] == {"jax": 13, "jax_adam_count": 13, "port": 13,
                          "port_adam": [13.0]}
    over = {k: v for k, v in r["readings"].items() if not v <= UPDATE_RTOL}
    assert not over, over
    for name, errs in r["moments"].items():
        assert set(errs) == set(r["readings"]), name
        over = {k: v for k, v in errs.items() if not v <= MOMENT_RTOL}
        assert not over, (name, over)
    np.testing.assert_allclose(*r["loss"], rtol=1e-4)
    print(f"largest update reading {max(r['readings'].values()):.4g}")


def test_decoder_dropout_keeps_and_scales_as_flax():
    """The ASPP projection's dropout (p 0.5) on 2^20 ones: each package
    keeps a share within 5 standard deviations of 0.5 and scales what it
    keeps to exactly 2."""
    for name, s in dropout_stats().items():
        assert abs(s["keep"] - 0.5) < 5 * 0.5 / 2 ** 10, (name, s)
        assert s["kept"] == [2.0], (name, s)
