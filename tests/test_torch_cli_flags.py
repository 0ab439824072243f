"""The port's CLI flags against the JAX package's parser
(tests/test_cli_flags.py's counterpart): every reference flag parses to the
same Config as in JAX, explicit bool values parse, and the flags that
upstream parses but never reads change nothing. The one field that differs
by design is ``--device``, a real field of the port (the JAX package
ignores it)."""

import dataclasses

import pytest

from cl4wsis_tpu.cli.config import parse_config as jax_parse_config
from cl4wsis_tpu_torch.cli.config import Config, parse_config
from tests.test_cli_flags import REFERENCE_FLAGS
from torch_one_thread import one_torch_thread  # noqa: F401

INERT = ["--crop_val", "--unce", "--pl_ckpt", "x.pth", "--icarl_importance",
         "2.0", "--icarl_disjoint"]


def _same_as_jax(cfg, jax_cfg):
    """Every field the two Configs share, equal (device aside)."""
    fields = {f.name for f in dataclasses.fields(jax_cfg)}
    for f in dataclasses.fields(cfg):
        if f.name != "device":
            assert f.name in fields, f.name
            assert getattr(cfg, f.name) == getattr(jax_cfg, f.name), f.name


def _reference_argv():
    argv = []
    for name, value in REFERENCE_FLAGS:
        argv.append(f"--{name}")
        if value is not None:
            argv.append(value)
    return argv


def test_every_reference_flag_parses_as_in_jax():
    argv = _reference_argv()
    cfg = parse_config(argv)
    assert isinstance(cfg, Config)
    _same_as_jax(cfg, jax_parse_config(argv))
    _same_as_jax(cfg.finalize(100), jax_parse_config(argv).finalize(100))
    assert cfg.seed == 42 and cfg.pretrained is False
    assert cfg.weakly is True and cfg.print_interval == 10
    assert cfg.sample_num == 8 and cfg.device == "0"


@pytest.mark.parametrize("argv", [
    ["--weakly", "true", "--flac", "false", "--overlap", "1", "--bce", "0"],
    ["--weakly", "--flac", "--overlap", "false", "--bce", "yes",
     "--no_pretrained", "--val_flip", "t", "--init_balanced", "no"],
])
def test_explicit_bool_values_parse_as_in_jax(argv):
    cfg = parse_config(argv)
    _same_as_jax(cfg, jax_parse_config(argv))
    assert cfg.weakly is True


@pytest.mark.parametrize("stage", [
    [], ["--step", "1", "--weakly", "--phase", "1"],
    ["--step", "2", "--weakly", "--phase", "2", "--task", "10-5"]])
def test_inert_flags_change_nothing(stage):
    """With the inert flags every finalized field but the inert ones is as
    without them, and as JAX's."""
    base = parse_config(stage).finalize(10)
    inert = parse_config(stage + INERT).finalize(10)
    _same_as_jax(inert, jax_parse_config(stage + INERT).finalize(10))
    names = {"crop_val", "unce", "pl_ckpt", "icarl_importance",
             "icarl_disjoint"}
    for f in dataclasses.fields(base):
        if f.name not in names:
            assert getattr(base, f.name) == getattr(inert, f.name), f.name
