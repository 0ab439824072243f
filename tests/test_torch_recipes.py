"""The port's recipe scripts against the JAX package's, on the CPU.

``scripts/run_torch.sh``, ``run_10-5_torch.sh`` and ``coco_torch.sh`` are
``run.sh``, ``run_10-5.sh`` and ``coco.sh`` with the port's CLI. Each pair
runs under ``bash`` in a temporary directory with a stub ``python`` first
on ``PATH`` that writes its argv, one stage a line, and exits 0. The argv
lists must be equal stage for stage but for the module, and each stage's
argv, parsed and finalized by each package's ``Config``, equal in every
field both dataclasses share but ``device``.

``run.sh`` at overlap 0 stops before phase 2: it sets phase 2's
checkpoint path in a command substitution whose test fails under ``set
-e``. The port's script sets the path in a statement of its own and runs
phase 2 from ``checkpoints/step/voc-15-5/OURS_1``, which is where the
port's (and the JAX package's) phase 1 writes at ``--overlap false``.
"""

import dataclasses
import os
import stat
import subprocess

import pytest

from cl4wsis_tpu.cli import config as jax_config
from cl4wsis_tpu_torch.cli import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODULE = "cl4wsis_tpu.cli.main"
PORT_MODULE = "cl4wsis_tpu_torch.cli.main"
STUB = """#!/bin/sh
for a in "$@"; do printf '%s\\t' "$a"; done >> "$ARGV_LOG"
printf '\\n' >> "$ARGV_LOG"
"""
# (JAX script, the port's, arguments, stages)
RECIPES = [("run.sh", "run_torch.sh", ["1"], 3),
           ("run.sh", "run_torch.sh", ["0"], 3),
           ("run_10-5.sh", "run_10-5_torch.sh", [], 5),
           ("coco.sh", "coco_torch.sh", [], 3)]


def _stages(script, args, tmp):
    """The argv of every `python` call `script` makes, in order, and the
    script's exit code."""
    bin_dir = tmp / "bin"
    bin_dir.mkdir(exist_ok=True)
    stub = bin_dir / "python"
    stub.write_text(STUB)
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    log = tmp / f"{script}.{'-'.join(args)}.argv"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               ARGV_LOG=str(log))
    rc = subprocess.run(["bash", os.path.join(REPO, "scripts", script),
                         *args], cwd=tmp, env=env, timeout=60).returncode
    return [line.split("\t")[:-1]
            for line in log.read_text().splitlines()], rc


def _finalized(cfg):
    return dataclasses.asdict(cfg.finalize())


@pytest.mark.parametrize("jax_script,port_script,args,n", RECIPES,
                         ids=["run-ov", "run-no-ov", "run_10-5", "coco"])
def test_recipe_matches_the_jax_script(tmp_path, jax_script, port_script,
                                       args, n):
    want, jax_rc = _stages(jax_script, args, tmp_path)
    got, rc = _stages(port_script, args, tmp_path)
    assert rc == 0 and len(got) == n
    if args == ["0"] and jax_rc != 0:
        # run.sh's stop (module docstring): its stages so far, and the
        # port's phase 2 is overlap 1's at --overlap false
        assert len(want) == n - 1
        ov, _ = _stages(port_script, ["1"], tmp_path)
        last = [a.replace("voc-15-5-ov/", "voc-15-5/") for a in ov[-1]]
        last[last.index("--overlap") + 1] = "false"
        assert got[-1] == last
        want.append(got[-1][:1] + [JAX_MODULE] + got[-1][2:])
    assert jax_rc == 0 or args == ["0"]
    assert len(want) == n
    for i, (w, g) in enumerate(zip(want, got)):
        assert w[:2] == ["-m", JAX_MODULE] and g[:2] == ["-m", PORT_MODULE], i
        assert w[2:] == g[2:], (i, w, g)
        jc = _finalized(jax_config.parse_config(w[2:]))
        pc = _finalized(config.parse_config(g[2:]))
        shared = (set(jc) & set(pc)) - {"device"}
        assert len(shared) > 60
        diff = {k: (jc[k], pc[k]) for k in shared if jc[k] != pc[k]}
        assert not diff, (i, diff)
        assert pc["device"] == "cuda"


def test_recipes_name_the_ports_cli():
    """Every `python` call of the port's scripts is the port's CLI: the
    scripts set `run` once and mention no JAX module."""
    for _, script, _, _ in RECIPES:
        text = open(os.path.join(REPO, "scripts", script)).read()
        assert f'run="python -m {PORT_MODULE}"' in text, script
        assert JAX_MODULE not in text, script
