"""The benchmark's cells on the card: one short untraced run of each,
correct. Runs only where CUDA is available (decided inside the test):

    python3 -m pytest benchmark/tests/test_bench_cuda.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark.tests.tiny import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["r101-voc15-5.phase2",
                                  "wrn38-cocovoc.validate"])
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          name, "--seed", "424242", "--seconds", "5"],
                         capture_output=True, text=True, timeout=900,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().split("\n")[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
