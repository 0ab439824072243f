"""Minimal end-to-end example of the PyTorch port: train step 0 on
synthetic data, then evaluate instance mAP (the counterpart of
``examples/train_synthetic.py``).

Run: python examples/train_synthetic_torch.py [steps] [--device cpu]
(on the card unless --device cpu; 300 steps by default).
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cl4wsis_tpu_torch.data.synthetic import synthetic_batches  # noqa: E402
from cl4wsis_tpu_torch.models import make_model  # noqa: E402
from cl4wsis_tpu_torch.train import schedule  # noqa: E402
from cl4wsis_tpu_torch.train.eval import (make_eval_forward,  # noqa: E402
                                          validate_instances)
from cl4wsis_tpu_torch.train.step0 import (init_state,  # noqa: E402
                                           make_step0_train_step)


def main(steps: int = 300, device: str = "cuda") -> dict:
    torch.manual_seed(0)
    model = make_model((3,), crop_size=64, backbone_structure=(1, 1, 1, 1))
    step = make_step0_train_step(model, sigma=3, max_inst=8, device=device,
                                 dtype="float32")
    state = init_state(model, "adam",
                       schedule.make_schedule("poly", 1e-3, max(steps, 1)))

    gen = torch.Generator(device).manual_seed(1)
    batches = synthetic_batches(16, 64, n_classes=2, seed=0)
    for i in range(steps):
        b = next(batches)
        batch = {k: torch.from_numpy(b[k]).to(device)
                 for k in ("image", "seg", "inst")}
        m = step(state, batch, gen)
        if i % 50 == 0:
            print(f"step {i}: loss={float(m['loss']):.3f}")

    samples = []
    for b in synthetic_batches(1, 64, n_classes=2, seed=999, n_batches=16):
        seg, inst = b["seg"][0], b["inst"][0]
        ids = [k for k in np.unique(inst) if k != 0]
        if ids:
            samples.append({
                "image": b["image"],
                "gt_masks": np.stack([inst == k for k in ids]),
                "gt_labels": np.array([int(seg[inst == k][0]) - 1
                                       for k in ids])})
    fwd = make_eval_forward(model, 2, device=torch.device(device),
                            dtype=torch.float32, val_kernel=15)
    res = validate_instances(fwd, samples)
    print(f"mAP@[.5:.95]={res['map']:.3f}  mAP@.5={res['map50']:.3f}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", type=int, nargs="?", default=300)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.steps, a.device)
