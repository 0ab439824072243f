"""Phase-2 training traffic: ``train/phase2.make_phase2_train_step``'s
``step(state, batch, gen)`` back to back over device-resident synthetic
batches, drawn from the seed (the traffic's ``n_batches``, every new class
labelled in every image), with the pseudo-threshold surgery so that the
label factory fires in every batch.

Set-up builds the step, its models and Adam's state once, drives it
through the traffic's first ``check_steps`` steps (batches 0, 1, 2, ...;
their losses, the first gradient as Adam holds it and the parameters'
change over them kept) and ``warmup_steps`` in all, and hands that same
step and state to the window. A tap records what the compared steps
decided (the label factory's arguments and results, the soft seg) and
their first network outputs. After the window the reference follows
those steps from the same weights, batches and dropout draws, in float32
with TF32 off, taking the program's decisions and computing everything
else itself; the recorded factory calls are replayed through the plain
factory, which must give the same results bit for bit."""

from __future__ import annotations

import contextlib
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import compare, surgery, weights, work
from benchmark.harness import tap as tap_mod
from benchmark.harness.tap import Tap
from benchmark.harness.synthetic import synthetic_batches
from benchmark.reference import build as ref_build
from benchmark.reference import phase2 as ref_phase2
from benchmark.reference import schedule as ref_schedule


class Driver:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.b = cfg["batch_size"]
        self.old = sum(cfg["classes"][:-1])
        self.pick = None
        with torch.device("meta"):
            self.spec = weights.spec_of(ref_build.phase2_modules(cfg))

    # -------------------------------------------------- inputs of both sides
    def _batches(self):
        n_things = sum(self.cfg["classes"]) - 1
        out = []
        for b in synthetic_batches(self.b, self.cfg["crop_size"], n_things,
                                   weights.sub_seed(self.seed, "batches"),
                                   self.mix["n_batches"]):
            l1h = b["l1h"][:, 1:].copy()
            l1h[:, self.old - 1:] = 1.0
            out.append({"image": torch.from_numpy(b["image"]).to(self.dev),
                        "l1h": torch.from_numpy(l1h).to(self.dev)})
        return out

    def _state(self) -> Dict[str, torch.Tensor]:
        st = weights.seeded_state(self.spec,
                                  weights.sub_seed(self.seed, "weights"),
                                  self.dev)
        surgery.lift_pg(st)
        if self.pick is not None:
            surgery.lift_seg(st, len(self.cfg["classes"]), self.pick)
        return st

    def _load(self, mods: Dict[str, torch.nn.Module]) -> None:
        st = self._state()
        for name, m in mods.items():
            m.to_empty(device=self.dev)
            m.load_state_dict(weights.split(st, name))
            m.eval()

    def _gen(self) -> torch.Generator:
        return torch.Generator(device=self.dev).manual_seed(
            weights.sub_seed(self.seed, "dropout"))

    def _optimizer(self, opt_mod, model):
        o = self.cfg["optimizer"]
        return (opt_mod.make_optimizer(model, "adam",
                                       group_scale=o["group_scale"]),
                opt_mod.make_schedule("poly", o["lr"], o["max_iters"]))

    @staticmethod
    def _first_steps(step, state, batches, gen, n, tap=None) -> Dict:
        """Run `n` steps on batches 0..n-1 under `tap` (if given); return
        their losses, the first gradient as Adam holds it, the parameters'
        change, and what the tap recorded."""
        opt = state.optimizer
        train = [(k, p) for k, p in state.model.named_parameters()
                 if p.requires_grad]
        before = {k: p.detach().clone() for k, p in train}
        losses, grads = [], None
        with tap or contextlib.nullcontext():
            for i in range(n):
                m = step(state, batches[i], gen)
                losses.append(float(m["loss"]))
                if i == 0:
                    beta1 = opt.param_groups[0]["betas"][0]
                    grads = {k: opt.state[p].get("exp_avg",
                                                 torch.zeros_like(p))
                             .detach() / (1 - beta1) for k, p in train}
        change = {k: p.detach() - before[k] for k, p in train}
        out = {"losses": losses, "grads": grads, "change": change}
        if tap is not None:
            out.update(calls=tap.calls, **tap.first)
        return out

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from cl4wsis_tpu_torch.models import make_model
        from cl4wsis_tpu_torch.train import phase2, schedule
        from cl4wsis_tpu_torch.train.state import TrainState
        from cl4wsis_tpu_torch.wss import PeakGenerator, PseudoLabeler

        cfg, mix = self.cfg, self.mix
        self.batches = self._batches()
        with ref_build.no_tf32():
            with torch.device("meta"):
                mods = ref_build.phase2_modules(cfg)
            self._load(mods)
            self.thresh, self.pick, _ = surgery.choose_pseudo_thresh(
                mods["model"], mods["pl"], mods["pg"], self.batches,
                self.old)
        del mods
        self._free()

        classes, tot = tuple(cfg["classes"]), sum(cfg["classes"])
        kw = dict(backbone=cfg["backbone"],
                  output_stride=cfg["output_stride"],
                  crop_size=cfg["crop_size"],
                  backbone_structure=tuple(cfg["blocks"]))
        with torch.device("meta"):
            mods = {"model": make_model(classes, **kw),
                    "old": make_model(classes[:-1], **kw),
                    "pl": PseudoLabeler(tot,
                                        in_channels=cfg["body_channels"]),
                    "pg": PeakGenerator(tot - 1, self.old - 1)}
        self._load(mods)
        opt, sched = self._optimizer(schedule, mods["model"])
        self.state = TrainState(mods["model"], opt, sched)
        self.step = phase2.make_phase2_train_step(
            mods["model"], mods["old"], mods["pl"], mods["pg"], self.old,
            pseudo_thresh=self.thresh, device=self.dev.type,
            dtype=cfg["dtype"], **cfg["phase2"])
        self.mods = mods
        self.gen = self._gen()
        self.got = self._first_steps(
            self.step, self.state, self.batches, self.gen,
            mix["check_steps"], Tap(phase2, mods["old"], mods["pg"]))
        for i in range(mix["check_steps"], mix["warmup_steps"]):
            self.step(self.state, self.batches[i % len(self.batches)],
                      self.gen)
        self.next = mix["warmup_steps"]

    def sample_run(self) -> None:
        """Nothing: set-up already ran the compared steps."""

    def _batch(self):
        b = self.batches[self.next % len(self.batches)]
        self.next += 1
        return b

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _peak_reset(self) -> None:
        self._sync()
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    def _peak(self) -> int:
        return (torch.cuda.max_memory_allocated()
                if self.dev.type == "cuda" else 0)

    def window(self, seconds: float) -> Dict:
        """Steps back to back until `seconds` have passed on the host clock
        at a step's launch; every step's time from CUDA events recorded
        between steps on the device."""
        cuda = self.dev.type == "cuda"
        import gc
        gc.collect()
        self._peak_reset()
        marks, losses = [], []
        t0 = time.perf_counter()
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        while True:
            m = self.step(self.state, self._batch(), self.gen)
            losses.append(m["loss"])
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            else:
                marks.append(time.perf_counter())
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        if cuda:
            step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            step_ms = list(np.diff([t0] + marks) * 1e3)
        n = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        q = np.percentile(step_ms, [50, 90, 95, 99, 100])
        print(f"phase2 window: {n} steps in {elapsed:.3f} s; step ms "
              f"p50/p90/p95/p99/max {' / '.join(f'{v:.3f}' for v in q)}",
              file=sys.stderr)
        return {"metrics": {"train_img_s": n * self.b / elapsed,
                            "step_ms_p95": float(np.percentile(step_ms, 95))},
                "attempted": n, "failed": failed, "peak_bytes": self._peak()}

    def traced(self):
        """The traffic's ``trace_steps`` steps under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        n = self.mix["trace_steps"]
        self._peak_reset()
        losses = []
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                losses.append(self.step(self.state, self._batch(),
                                        self.gen)["loss"])
            self._sync()
            window_s = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        w = {"attempted": n, "failed": failed, "peak_bytes": self._peak(),
             "images": n * self.b, "steps": n,
             "flops": n * work.phase2_flops(self.cfg),
             "kernel_bytes": n * work.phase2_kernel_bytes(self.cfg)}
        return prof, window_s, w

    def _free(self) -> None:
        import gc
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def release(self) -> None:
        """Drop the program's step, models and optimizer state; keep the
        compared steps' readings and the batches."""
        del self.step, self.state, self.mods, self.gen
        self._free()

    # ---------------------------------------------------------- reference
    def _reference(self, precision: str, follow=None, half: bool = False):
        """The compared steps through the reference at `precision`: its own
        decisions, recorded by a tap (`follow` None), or those of `follow`,
        a run it follows, with its own first outputs recorded. With `half`,
        each step is given the first half of its batch (a fault)."""
        with ref_build.no_tf32():
            with torch.device("meta"):
                mods = ref_build.phase2_modules(self.cfg)
            self._load(mods)
            for m in mods.values():
                ref_build.set_precision(m, precision)
            opt, sched = self._optimizer(ref_schedule, mods["model"])
            state = ref_phase2.TrainState(mods["model"], opt, sched)
            record: Dict = {}
            step = ref_phase2.make_phase2_train_step(
                mods["model"], mods["old"], mods["pl"], mods["pg"], self.old,
                pseudo_thresh=self.thresh, device=self.dev.type,
                follow=None if follow is None else [
                    {"soft": c["args"]["soft"], "fac": c["fac"]}
                    for c in follow["calls"]],
                record=record, **self.cfg["phase2"])
            batches = self.batches
            if half:
                batches = [{k: v[:len(v) // 2] for k, v in b.items()}
                           for b in batches]
            tap = (Tap(ref_phase2, mods["old"], mods["pg"])
                   if follow is None else None)
            out = self._first_steps(step, state, batches, self._gen(),
                                    self.mix["check_steps"], tap)
            out["record"] = record
        del mods, state, step, opt
        self._free()
        return out

    CONTROLS = ("fp8", "half_batch")
    WITNESSES = ("bf16",)

    def control_readings(self, kind: str) -> Dict[str, float]:
        """The compared numbers of the reference in the program's place:
        in float8 (the control), given half of each batch (a fault), or in
        bfloat16 (a witness of what the configuration's precision costs)."""
        got = (self._reference("fp32", half=True) if kind == "half_batch"
               else self._reference(kind))
        return self.readings(got)

    def readings(self, got: Dict, ref: Dict = None) -> Dict[str, float]:
        """The numbers compared between `got`, a recorded run (the
        program's, or the reference's in its place), and the float32
        reference following its decisions (`ref`, made here if None)."""
        if ref is None:
            try:
                ref = self._reference("fp32", follow=got)
            except ref_phase2.FollowMismatch:
                return dict.fromkeys(("loss_gap", "grad_gap", "change_gap",
                                      "net_gap"), math.inf)
        live = compare.live_leaves(ref["grads"])
        first, rec = got["calls"][0]["args"], ref["record"]
        outs = {"soft": (first["soft"], rec["soft"]),
                "center": (first["center"], rec["center"]),
                "offset": (first["offset"], rec["offset"]),
                "cam": (got["cam"], rec["cam"])}
        outs.update({f"old.{k}": (got["old"][k], rec["old"][k])
                     for k in rec["old"]})
        gaps = {k: compare.out_gap({k: a.float()}, {k: b.float().cpu()})
                for k, (a, b) in outs.items()}
        r = {"loss_gap": compare.loss_gap(got["losses"], ref["losses"]),
             "grad_gap": compare.median_gap(got["grads"], ref["grads"],
                                            live),
             "grad_gap.worst": compare.norm_gap(got["grads"], ref["grads"],
                                                live),
             "change_gap": compare.norm_gap(got["change"], ref["change"],
                                            live),
             "net_gap": max(gaps.values())}
        r.update({f"net_gap.{k}": v for k, v in gaps.items()})
        self.detail = {
            "grad": compare.worst_leaves(got["grads"], ref["grads"], live),
            "change": compare.worst_leaves(got["change"], ref["change"],
                                           live),
            "losses": [got["losses"], ref["losses"]]}
        if not all(math.isfinite(v) for v in got["losses"]):
            r["loss_gap"] = math.inf
        return r

    def factory_diff(self, got: Dict) -> float:
        """Elements in which the program's label factory results differ
        from the reference's plain factory on the same arguments."""
        n = 0
        with torch.no_grad():
            for c in got["calls"]:
                args = ref_phase2._to(c["args"], self.dev)
                want = ref_phase2.label_factory(**args)
                a, b = tap_mod.flat(c["fac"]), tap_mod.flat(want)
                if [k for k, _ in a] != [k for k, _ in b]:
                    return math.inf
                n += sum(compare.post_diff({"x": x}, {"x": y})
                         for (_, x), (_, y) in zip(a, b))
        return float(n)

    def check(self) -> Dict[str, float]:
        r = self.readings(self.got)
        r["factory_diff"] = self.factory_diff(self.got)
        return r
