"""The port's real-data parity kit (scripts/run_realdata_parity_torch.py)
against the JAX package's (scripts/run_realdata_parity.py), on the CPU: the
pieces that only fail after days of compute. Each stage's argv is the JAX
kit's with the port's module, and its finalized config equal in every
shared field but ``device``; the readiness rows are the JAX kit's; the
readiness check refuses an ImageNet file that does not cover the step-0
body; the metric regexes, the parity table and the stage runner; one tiny
``--run port`` on a painted mini-VOC through the rehearsal seam."""

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from cl4wsis_tpu.cli import config as jax_config
from cl4wsis_tpu_torch.cli import config
from cl4wsis_tpu_torch.data.fixture import write_fake_iabn, write_fake_voc
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import run_realdata_parity as jax_kit  # noqa: E402

KIT_PATH = os.path.join(REPO, "scripts", "run_realdata_parity_torch.py")
_spec = importlib.util.spec_from_file_location("run_realdata_parity_torch",
                                               KIT_PATH)
kit = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kit)

JAX_MODULE = "cl4wsis_tpu.cli.main"
PORT_MODULE = "cl4wsis_tpu_torch.cli.main"
# the rehearsal: a ResNet-18 of one block a stage at 48^2 on the CPU
REHEARSAL = ("--tiny true --backbone resnet18 --device cpu --dtype float32 "
             "--crop_size 48 --crop_size_val 48 --kernel 15 --val_kernel 15 "
             "--batch_size 4")


def _args(task="15-5", scale=1.0, n=1, stage_args="", root="w"):
    return types.SimpleNamespace(
        task=task, data_root=os.path.join(root, "data"),
        pretrained_dir=os.path.join(root, "pretrained"),
        workdir=os.path.join(root, "work"), num_workers=0, seed=7,
        epochs_scale=scale, nproc_per_node=n, stage_args=stage_args,
        run="check")


def _finalized(parse, argv):
    return dataclasses.asdict(parse(argv).finalize())


@pytest.mark.parametrize("scale", [1.0, 0.01])
@pytest.mark.parametrize("task", kit.TASKS)
def test_stage_argv_and_configs_match_the_jax_kit(task, scale):
    a = _args(task, scale)
    want, got = jax_kit.rebuild_cmds(a), kit.port_cmds(a)
    assert len(got) == len(want) == 3
    for i, (w, g) in enumerate(zip(want, got)):
        assert w[:3] == [sys.executable, "-m", JAX_MODULE], i
        assert g[:3] == [sys.executable, "-m", PORT_MODULE], i
        assert w[3:] == g[3:], (i, w, g)
        jc = _finalized(jax_config.parse_config, w[3:])
        pc = _finalized(config.parse_config, g[3:])
        shared = (set(jc) & set(pc)) - {"device"}
        assert len(shared) > 60
        assert not {k: (jc[k], pc[k]) for k in shared if jc[k] != pc[k]}, i
        assert pc["device"] == "cuda"
    epochs = [int(g[g.index("--epochs") + 1]) for g in got]
    full = [200, 30, 50] if task == "coco-voc" else [100, 40, 50]
    assert epochs == [max(1, int(e * scale)) for e in full]
    assert scale == 1 or epochs in ([1, 1, 1], [2, 1, 1])


def test_torchrun_form_and_the_seam():
    """--nproc_per_node 4 runs each stage under torchrun with the
    multi-host switch at 16 / 4 a process; the seam appends its flags to
    every stage and may not move the checkpoint hand-off."""
    one, four = kit.port_cmds(_args()), kit.port_cmds(_args(n=4))
    for o, f in zip(one, four):
        assert f[:9] == ["env", "CL4WSIS_MULTIHOST=1", sys.executable, "-m",
                         "torch.distributed.run", "--nproc_per_node", "4",
                         "-m", PORT_MODULE]
        assert f[f.index("--batch_size") + 1] == "4"
        assert o[o.index("--batch_size") + 1] == "16"
        rest = f[9:]
        rest[rest.index("--batch_size") + 1] = "16"
        assert rest == o[3:]
    with pytest.raises(ValueError):
        kit.port_cmds(_args(n=3))
    seamed = kit.port_cmds(_args(stage_args="--tiny true --device cpu"))
    assert all(s == o + ["--tiny", "true", "--device", "cpu"]
               for s, o in zip(seamed, one))
    for flag in ("--checkpoint x", "--seg_ckpt=y", "--name Z"):
        with pytest.raises(ValueError):
            kit.port_cmds(_args(stage_args=flag))


@pytest.mark.parametrize("task", kit.TASKS)
def test_readiness_rows_match_the_jax_kit(task):
    assert kit.requirements(task, "d", "p") == \
        jax_kit.requirements(task, "d", "p")


def _fabricate(root, task="15-5"):
    """Every row of the layout as a tiny file or directory, and the
    rehearsal's ImageNet file covering its body; returns the args and the
    file's path."""
    a = _args(task, stage_args=REHEARSAL, root=str(root))
    cfg = kit.step0_config(a)
    rows = kit.requirements(task, a.data_root, a.pretrained_dir,
                            cfg.backbone)
    for _, path, _ in rows[:-1]:
        if os.path.splitext(path)[1]:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            open(path, "w").close()
        else:
            os.makedirs(path, exist_ok=True)
    write_fake_iabn(rows[-1][1], kit.body_shapes(cfg), seed=1)
    return a, rows[-1][1]


def _status(report):
    return report["rows"][-1]["status"], report["rows"][-1].get("coverage")


def test_readiness_covers_the_body(tmp_path, capsys):
    """Ready with a covering file; a file without one body key, with one
    tensor of the wrong shape or absent is not, and the port run refuses
    to start."""
    a, path = _fabricate(tmp_path)
    good = kit.check(a)
    status, cov = _status(good)
    assert good["ready"] and status == "OK"
    assert cov["covered"] == cov["body"] == 60 and cov["n_missing"] == 0
    assert cov["n_ignored"] == 0
    assert '"covered": 60' in capsys.readouterr().out
    blob = torch.load(path, weights_only=False)
    sd = blob["state_dict"]

    key = "module.mod3.block1.convs.conv2.weight"
    torch.save(dict(blob, state_dict={k: v for k, v in sd.items()
                                      if k != key}), path)
    bad = kit.check(a)
    status, cov = _status(bad)
    assert not bad["ready"] and status == "MISMATCH"
    assert cov["missing"] == ["body.mod3.block1.convs.conv2.weight"]

    torch.save(dict(blob, state_dict=dict(sd, **{key: sd[key][:, :1]})),
               path)
    bad = kit.check(a)
    status, cov = _status(bad)
    assert not bad["ready"] and status == "MISMATCH"
    assert cov["n_wrong_shape"] == 1 and cov["wrong_shape"][0][0] == \
        "body.mod3.block1.convs.conv2.weight"

    os.rename(path, path + ".old")
    bad = kit.check(a)
    assert not bad["ready"] and _status(bad) == ("MISSING", None)
    assert kit.main(["--run", "port", "--task", "15-5", "--data_root",
                     a.data_root, "--pretrained_dir", a.pretrained_dir,
                     "--workdir", a.workdir, "--stage_args", REHEARSAL,
                     "--out", str(tmp_path / "o.json")]) == 1
    assert "ABORT" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "o.json")


def test_metric_regexes_read_the_ports_cli():
    cli = "[val e9] mAP@[.5:.95]=0.1000 mAP@.5=0.2000\n" \
          "[test] mAP@[.5:.95]=0.3145 mAP@.5=0.5312"
    assert kit._last_match(kit._MAP_RES, cli) == 0.3145
    assert kit._last_match(kit._MAP50_RES, cli) == 0.5312
    js = json.dumps({"type": "results", "map": 0.125, "map50": 0.25})
    assert kit._last_match(kit._MAP_RES, js) == 0.125
    assert kit._last_match(kit._MAP50_RES, js) == 0.25
    assert kit._last_match(kit._MAP50_RES, cli + "\n" + js) == 0.25
    assert kit._last_match(kit._MAP50_RES, js + "\n" + cli) == 0.5312
    assert kit._last_match(kit._MAP50_RES, "[test] Val_CAM MeanIoU=0.1") \
        is None


def test_parity_table_and_the_gate():
    """The other column from a JAX-kit JSON's rebuild entries: delta in
    points, the 0.5-pt gate, a stage without a number on either side."""
    port = [{"stage": 0, "map50": 0.5312}, {"stage": 1, "map50": None},
            {"stage": 2, "map50": 0.3001}]
    jax_json = {"rebuild": [{"stage": 0, "map50": 0.5290},
                            {"stage": 1, "map50": None},
                            {"stage": 2, "map50": 0.3101}]}
    table = kit.parity_table(port, jax_json["rebuild"], "rebuild")
    assert table[0] == {"stage": 0, "port_map50": 0.5312,
                        "rebuild_map50": 0.529, "delta_pts": 0.22,
                        "within_0.5pt": True}
    assert "delta_pts" not in table[1]
    assert table[2]["delta_pts"] == -1.0 and not table[2]["within_0.5pt"]


def test_run_stages_survives_timeout(tmp_path):
    cmds = [[sys.executable, "-c",
             "print('mAP@.5=0.4000', flush=True); import time; "
             "time.sleep(60)"],
            [sys.executable, "-c", "print('never runs')"]]
    res = kit.run_stages(cmds, str(tmp_path / "t"), timeout=3)
    assert len(res) == 1 and res[0]["rc"] == -1 and res[0]["map50"] == 0.4
    with open(tmp_path / "t_stage0.log") as f:
        assert "timed out after 3s" in f.read()


@pytest.fixture
def kit_root(tmp_path):
    """The kit's root, its checkpoints removed after the test (~250 MB)."""
    yield tmp_path
    shutil.rmtree(tmp_path / "work" / "rb_ckpt", ignore_errors=True)


def test_tiny_port_run_on_a_painted_mini_voc(kit_root, monkeypatch):
    """--run port at --epochs_scale 0.01 through the seam: three stages,
    rc 0, each stage's mAP read from its output equal to its JSONL record
    (phase 1 validates the CAM mIoU and has none), the checkpoints where
    the next stage reads them, and the parity table against a fabricated
    JAX-kit JSON."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    a, _ = _fabricate(kit_root)
    write_fake_voc(a.data_root, n_images=8, size=48, paint=True)
    against = kit_root / "jax.json"
    against.write_text(json.dumps({"rebuild": [
        {"stage": 0, "map50": 0.0}, {"stage": 1, "map50": None},
        {"stage": 2, "map50": 0.0}]}))
    out = kit_root / "port.json"
    rc = kit.main(["--run", "port", "--task", "15-5", "--data_root",
                   a.data_root, "--pretrained_dir", a.pretrained_dir,
                   "--workdir", a.workdir, "--num_workers", "0",
                   "--epochs_scale", "0.01", "--stage_args", REHEARSAL,
                   "--against", str(against), "--out", str(out)])
    res = json.loads(out.read_text())
    assert rc == 0, res["port"]
    assert [r["rc"] for r in res["port"]] == [0, 0, 0]
    logged = res["port_logged"]
    assert [(r["step"], r["phase"]) for r in logged] == [(0, None), (1, 1),
                                                         (1, 2)]
    for r, lg in zip(res["port"], logged):
        fin = lg["final"]
        if lg["phase"] == 1:
            assert r["map50"] is None and "Mean IoU" in fin
            continue
        assert r["map50"] == float(f"{fin['map50']:.4f}")
        assert r["map"] == float(f"{fin['map']:.4f}")
    ck = os.path.join(a.workdir, "rb_ckpt", "step", "voc-15-5-ov")
    assert os.path.exists(os.path.join(ck, "RB_0"))
    assert os.path.exists(os.path.join(ck, "RB_1"))
    assert [r["stage"] for r in res["parity_table"]] == [0, 1, 2]
    assert res["parity_table"][0]["port_map50"] == res["port"][0]["map50"]


def test_the_kit_imports_no_jax():
    code = ("import importlib.util, sys; "
            f"s = importlib.util.spec_from_file_location('k', {KIT_PATH!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            "print(sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'cl4wsis_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
