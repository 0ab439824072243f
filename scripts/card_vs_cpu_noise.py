#!/usr/bin/env python3
"""The CPU's own noise in chip_smoke.py's phase-1 card-against-CPU update
reading.

chip_smoke.py holds one tiny phase-1 step on the card against the same
step on the CPU by a per-tensor update reading (``chip_smoke.update_reading``,
limit ``CPU_TOL``). This script runs that step on the CPU once as it is and
24 times with its images perturbed by 1e-7 relative noise (one seeded draw
each), and prints the worst reading of each draw against the unperturbed
run: how much of the limit the step's own float32 conditioning takes.

    python3 scripts/card_vs_cpu_noise.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from cl4wsis_tpu_torch.data.synthetic import synthetic_batches  # noqa: E402

EPS = 1e-7
DRAWS = 24


def run(image=None):
    """One tiny phase-1 step on the CPU; (parameters before, state after,
    parameter names)."""
    module, call = chip_smoke.tiny_phase1("cpu", image)
    before = {k: v.detach().clone() for k, v in module.state_dict().items()}
    call()
    return (before, {k: v.detach().clone() for k, v in
                     module.state_dict().items()},
            [k for k, _ in module.named_parameters()])


def main() -> int:
    image = next(synthetic_batches(4, 64, 4, seed=6))["image"]
    before, ref, params = run()
    vals = []
    for seed in range(DRAWS):
        noise = np.random.RandomState(seed).randn(*image.shape)
        _, got, _ = run((image * (1 + EPS * noise)).astype(np.float32))
        worst = max((chip_smoke.update_reading(before[k], ref[k], got[k]), k)
                    for k in params)
        vals.append(worst[0])
        print(f"draw {seed}: worst reading {worst[0]:.6f} ({worst[1]})",
              flush=True)
    print(f"phase 1, eps {EPS}, {DRAWS} draws: readings min {min(vals):.6f}, "
          f"median {float(np.median(vals)):.6f}, max {max(vals):.6f} "
          f"(card-against-CPU limit "
          f"{chip_smoke.CPU_TOL['parameter updates (relative)']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
