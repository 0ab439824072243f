"""Run `chip_smoke.py`'s VOC 15-1 chain (synthetic data, through step 2)
several times on the card, with the label-factory surgery on its step-2
phase 2, and print one JSON line a run: the trained pseudolabeler's
new-class channel before the surgery (its share of pixels above 0 and
the lowest of the images' peaks), the bias the surgery added to it and
the pseudo threshold it chose with the images under it, or the error
that stopped the chain; `chip_smoke.py`'s own log line before it gives
the valid pseudo slots of each step.

    python scripts/chain_surgery_card.py --runs 5                # lift
    python scripts/chain_surgery_card.py --runs 4 --surgery cam  # +0.5

``--surgery lift`` is the one `chip_smoke.py` applies
(`choose_pseudo_thresh(..., lift=True)`); ``cam`` instead raises the
peak generator's bias by 0.5 and lifts nothing, as `chip_smoke.py` did
before. Card runs differ in their trained weights (the training
reductions are not deterministic), so the runs show how often a surgery
fires. It needs one CUDA device.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def channel_stats(model, pl, pg, batches):
    """The new-class channels of the pseudolabeler on `batches`: share of
    pixels above 0 and the lowest per-image peak."""
    new = pg.num_classes - pg.old_classes
    pos, peaks = [], []
    for batch in batches:
        x = batch["image"].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            body = model.forward_seg(x, interpolate=False)[1]["body"]
            z = pl(body)[:, -new:].float()
        pos.append(float((z > 0).float().mean()))
        peaks.append(float(z.amax(dim=(2, 3)).min()))
    return {"share_above_0": sum(pos) / len(pos), "lowest_peak": min(peaks)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--surgery", choices=("lift", "cam"), default="lift")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chain_surgery_card: no CUDA device", file=sys.stderr)
        return 1
    real_choose = cs.choose_pseudo_thresh
    seen = {}

    def choose(model, pl, pg, batches, old=cs.OLD, lift=False):
        seen.update(channel_stats(model, pl, pg, batches))
        bias = pl.cls.bias.detach().clone()
        if args.surgery == "cam":
            with torch.no_grad():
                pg.extra_conv4.bias += 0.5
            lift = False
        try:
            thresh, (images, _) = out = real_choose(model, pl, pg, batches,
                                                    old, lift)
            seen.update(thresh=thresh, images=images)
            return out
        finally:
            seen["lift"] = [v for v in (pl.cls.bias.detach() -
                                        bias).tolist() if v]

    cs.choose_pseudo_thresh = choose
    cs.kernels.lib()
    fired = 0
    for i in range(args.runs):
        seen.clear()
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            try:
                cs.multistep_chain(root, "15-1", cs.CHAIN_COMMON,
                                   "15-1 chain", real=False, surgery=True)
                error = None
            except AssertionError as e:
                error = str(e)
        fired += error is None
        print(json.dumps({"run": i, "surgery": args.surgery, **seen,
                          "error": error,
                          "s": round(time.perf_counter() - t, 1)}),
              flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"surgery": args.surgery, "runs": args.runs,
                      "fired": fired}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
