"""Instance-validation traffic: ``train/eval.make_eval_forward`` on the
configuration's model in eval mode, called one image at a time as the
port's CLI calls it in instance validation (``cli.main.
make_instance_forward``), its answer copied to the host as
``validate_instances`` copies it.

Images are painted from the seed at the traffic's VOC val sizes, resized
to a short side of the configuration's ``crop_size_val``; the target is
the original size, so the forward takes the unbucketed exact path. A
cycle is one image of every size, in an order drawn from the seed, so
every seed does the same work; the window runs whole cycles.

The reference compares a sample of the window's answers, drawn from the
seed: the model's outputs (captured by a forward hook) against the
reference's float32 forward of the same image, and the program's answer
against the reference's post-processing of those same outputs."""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import compare, painted, weights, work
from benchmark.reference import build as ref_build
from benchmark.reference.eval_post import postproc

ANSWER = ("ins_map", "valid", "label", "score", "truncated")


class Driver:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.ev = cfg["eval"]
        self.n_things = sum(cfg["classes"]) - 1
        self.targets = [(h, w) for w, h in mix["sizes_wh"]]
        self.inputs = [painted.resized_hw(w, h, self.ev["crop_size_val"])
                       for w, h in mix["sizes_wh"]]
        rs = np.random.RandomState(weights.sub_seed(seed, "order") % 2 ** 32)
        self.rs = rs
        with torch.device("meta"):
            self.spec = weights.spec_of({"model": ref_build.model(
                cfg, cfg["classes"])})

    def _weights(self, module: torch.nn.Module) -> None:
        st = weights.seeded_state(self.spec,
                                  weights.sub_seed(self.seed, "weights"),
                                  self.dev)
        module.to_empty(device=self.dev)
        module.load_state_dict(weights.split(st, "model"))
        module.eval()

    def _cycle(self, j: int) -> List[Tuple[int, int]]:
        """(size, pool image) of the j-th cycle's images."""
        while len(self.orders) <= j:
            self.orders.append(self.rs.permutation(len(self.inputs)))
        return [(int(s), j % self.mix["per_size"]) for s in self.orders[j]]

    def setup(self) -> None:
        from cl4wsis_tpu_torch.models import make_model
        from cl4wsis_tpu_torch.train.eval import make_eval_forward

        cfg, mix, ev = self.cfg, self.mix, self.ev
        gen = torch.Generator(device=self.dev).manual_seed(
            weights.sub_seed(self.seed, "images"))
        self.pool = [[painted.painted_image(h, w, mix["objects"], gen,
                                            self.dev).cpu()
                      for _ in range(mix["per_size"])]
                     for h, w in self.inputs]
        self.orders: List[np.ndarray] = []
        picks = self.rs.choice(mix["sample_from_cycles"],
                               mix["sample_cycles"], replace=False)
        self.sample = {j * len(self.inputs) + i for j in picks
                       for i in range(len(self.inputs))}
        with torch.device("meta"):
            model = make_model(tuple(cfg["classes"]), cfg["backbone"],
                               cfg["output_stride"], cfg["crop_size"],
                               backbone_structure=tuple(cfg["blocks"]))
        self._weights(model)
        if self.dev.type == "cuda":
            model.to(memory_format=torch.channels_last)
        self.model = model
        self.capture, self.captured = False, None

        def hook(_module, _inp, out):
            if self.capture:
                self.captured = {k: v.detach().clone() for k, v in out.items()}
        self.handle = model.register_forward_hook(hook)
        self.fwd = make_eval_forward(
            model, self.n_things, device=self.dev,
            dtype=torch.bfloat16 if cfg["dtype"] == "bfloat16"
            else torch.float32,
            val_flip=ev["val_flip"], val_thresh=ev["val_thresh"],
            val_kernel=ev["val_kernel"], beta=ev["beta"],
            max_ctr=ev["max_ctr"], max_cluster=ev["max_cluster"])
        self.answers: Dict[int, Dict] = {}
        for j in range(mix["warmup_cycles"]):
            for s, p in self._cycle(j):
                self._answer(s, p)
        self.orders = []             # the window's cycles start afresh

    def _answer(self, s: int, p: int) -> Dict[str, torch.Tensor]:
        out = self.fwd(self.pool[s][p], self.targets[s])
        return {k: out[k].cpu() for k in ANSWER}

    def _peak_reset(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def _peak(self) -> int:
        return (torch.cuda.max_memory_allocated()
                if self.dev.type == "cuda" else 0)

    def _run(self, cycles_or_seconds, by_time: bool):
        n, j = 0, 0
        t0 = time.perf_counter()
        while True:
            for s, p in self._cycle(j):
                self.capture = n in self.sample
                ans = self._answer(s, p)
                if self.capture:
                    self.answers[n] = {"answer": ans, "raw": self.captured,
                                       "image": (s, p)}
                    self.capture, self.captured = False, None
                n += 1
            j += 1
            if by_time:     # and never before the sampled cycles have run
                if time.perf_counter() - t0 >= cycles_or_seconds and \
                        j >= self.mix["sample_from_cycles"]:
                    break
            elif j >= cycles_or_seconds:
                break
        return n, time.perf_counter() - t0

    def sample_run(self) -> None:
        """The traffic's traced cycles without a profiler: the sampled
        answers of a run that measures nothing (calibration)."""
        self._run(self.mix["trace_cycles"], False)

    def window(self, seconds: float) -> Dict:
        self._peak_reset()
        n, elapsed = self._run(seconds, True)
        return {"metrics": {"infer_img_s": n / elapsed}, "attempted": n,
                "failed": 0, "peak_bytes": self._peak()}

    def traced(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._peak_reset()
        with profile(activities=acts) as prof:
            n, window_s = self._run(self.mix["trace_cycles"], False)
        per = n // len(self.inputs)
        flops = work.eval_flops(self.cfg, self.inputs)
        w = {"attempted": n, "failed": 0, "peak_bytes": self._peak(),
             "images": n, "steps": n,
             "flops": per * sum(flops.values()),
             "kernel_bytes": per * sum(work.eval_kernel_bytes(self.cfg, h, w)
                                       for h, w in self.targets)}
        return prof, window_s, w

    def release(self) -> None:
        self.handle.remove()
        del self.fwd, self.model, self.handle
        import gc
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _post(self, raw: Dict[str, torch.Tensor], s: int):
        ev = self.ev
        return postproc(raw, self.targets[s], self.n_things,
                        val_thresh=ev["val_thresh"],
                        val_kernel=ev["val_kernel"], beta=ev["beta"],
                        max_ctr=ev["max_ctr"], max_cluster=ev["max_cluster"])

    def _outputs(self, precision: str) -> Dict[int, Dict]:
        """The reference model's outputs on every sampled image."""
        out = {}
        with ref_build.no_tf32(), torch.no_grad():
            with torch.device("meta"):
                model = ref_build.model(self.cfg, self.cfg["classes"])
            self._weights(model)
            ref_build.set_precision(model, precision)
            for n, a in self.answers.items():
                s, p = a["image"]
                x = self.pool[s][p].to(self.dev).permute(0, 3, 1, 2)
                out[n] = {k: v.float()
                          for k, v in model(x, interpolate=False).items()}
        return out

    def readings(self, got: Dict[int, Dict], ref: Dict[int, Dict]
                 ) -> Dict[str, float]:
        if not got or set(got) != set(ref):
            return {"out_gap": math.inf, "post_diff": math.inf}
        gaps = {k: max(compare.out_gap({k: got[n][k].float()}, {k: ref[n][k]})
                       for n in ref) for k in next(iter(ref.values()))}
        return {"out_gap": max(gaps.values()),
                **{f"out_gap.{k}": v for k, v in gaps.items()}}

    CONTROLS = ("fp8",)
    WITNESSES = ("bf16",)

    def control_readings(self, kind: str) -> Dict[str, float]:
        """The reference in the program's place in float8 (the control) or
        bfloat16 (a witness of what the configuration's precision costs)."""
        return self.readings(self._outputs(kind), self._outputs("fp32"))

    def check(self) -> Dict[str, float]:
        r = self.readings({n: a["raw"] for n, a in self.answers.items()},
                          self._outputs("fp32"))
        diff = 0
        with torch.no_grad():
            for a in self.answers.values():
                want = self._post(a["raw"], a["image"][0])
                diff += compare.post_diff(
                    a["answer"], {k: want[k] for k in ANSWER})
        r["post_diff"] = float(diff) if self.answers else math.inf
        return r
