"""The comparison that decides ``correct``, at a tiny size on the CPU with
the real cells' limits: the float8 control fails them, and so does each
fault a cell can have, planted in the program under a whole run (for the
data-parallel cell, whose other ranks are processes of their own, the
faults of all ranks are planted in the reference in the program's place,
and the unchanged state in rank 0 under a whole run)."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests import tiny
from benchmark.tests.tiny import DP, PHASE2, VALIDATE

SEEDS = (3, 4, 5)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _run(root, name, seed=11):
    from benchmark.harness import runner
    return runner.run(root, name, seed, 0.5, False, "cpu",
                      cell=tiny.cell(root, name))


@pytest.mark.parametrize("name", [PHASE2, VALIDATE])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(root, name, seed):
    """The reference in float8 in the program's place fails one of the
    cell's numbers."""
    from benchmark.harness import compare
    cell = tiny.cell(root, name)
    drv = cell.driver().Driver(cell.config, cell.traffic, seed,
                               torch.device("cpu"))
    drv.setup()
    drv.sample_run()
    drv.release()
    got = drv.control_readings("fp8")
    checks = compare.judge(got, {k: v for k, v in cell.limits.items()
                                 if k in got})
    assert not compare.passed(checks), checks


def test_sound_run_passes(root):
    for name in (PHASE2, VALIDATE):
        assert _run(root, name)["correct"] is True


def test_state_unchanged_fails(root, monkeypatch):
    from cl4wsis_tpu_torch.train import state as state_mod

    def unchanged(self):
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
    monkeypatch.setattr(state_mod.TrainState, "apply_gradients", unchanged)
    res = _run(root, PHASE2)
    assert res["correct"] is False
    assert float(res["checks"]["change_gap"]["value"]) > \
        res["checks"]["change_gap"]["limit"]


def test_half_batch_fails(root, monkeypatch):
    from cl4wsis_tpu_torch.train import phase2
    real = phase2.make_phase2_train_step

    def halving(*a, **kw):
        step = real(*a, **kw)

        def half(state, batch, gen=None):
            return step(state, {k: v[:len(v) // 2] for k, v in batch.items()},
                        gen)
        return half
    monkeypatch.setattr(phase2, "make_phase2_train_step", halving)
    assert _run(root, PHASE2)["correct"] is False


def test_altered_answer_fails(root, monkeypatch):
    from cl4wsis_tpu_torch.train import eval as eval_mod
    real = eval_mod.get_ins_map

    def altered(*a, **kw):
        out = dict(real(*a, **kw))
        out["label"] = out["label"].clone()
        out["label"][0] += 1
        return out
    monkeypatch.setattr(eval_mod, "get_ins_map", altered)
    res = _run(root, VALIDATE)
    assert res["correct"] is False
    assert 0 < float(res["checks"]["post_diff"]["value"]) < float("inf")


def test_dp_exchange_left_out_fails(root):
    """Four gloo ranks: the sound program passes; the gradient exchange
    left out fails. (On the card the float8 control fails none of this
    driver's numbers, which keeps its cell out of the benchmark until its
    comparison separates the control: PERF.md, Open questions.)"""
    from benchmark.harness import compare
    cell = tiny.cell(root, DP)
    drv = cell.driver().Driver(cell.config, cell.traffic, 7,
                               torch.device("cpu"))
    try:
        drv.setup()
        drv.release()
        assert compare.passed(compare.judge(drv.check(), cell.limits))
        for kind in ("no_exchange",):
            got = drv.control_readings(kind)
            assert not compare.passed(compare.judge(got, cell.limits)), \
                (kind, got)
    finally:
        drv.close()


def test_dp_state_unchanged_fails(root, monkeypatch):
    """Rank 0 sums its gradients with the others but never updates."""
    from cl4wsis_tpu_torch.core import dist
    from cl4wsis_tpu_torch.train import state as state_mod

    def unchanged(self):
        dist.sum_grads(p for g in self.optimizer.param_groups
                       for p in g["params"])
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
    monkeypatch.setattr(state_mod.TrainState, "apply_gradients", unchanged)
    res = _run(root, DP)
    assert res["correct"] is False
