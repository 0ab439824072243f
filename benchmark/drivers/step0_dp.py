"""Data-parallel step-0 traffic: ``train/step0.make_step0_train_step``
under the port's ``core/dist`` over the mix's ``world`` ranks, one card a
rank, NCCL (gloo on the CPU). The benchmark starts the ranks itself: rank
0 is the process that runs the cell, and it spawns, drives and stops the
others. Each rank trains on its rows of a global batch drawn from the
seed (the configuration's batch a rank), with the recipe's Adam.

Set-up builds each rank's step and state once, drives them through the
mix's first ``check_steps`` steps (kept for the comparison) and its
``warmup_steps``, and times the last warm-up steps; the window then runs
the number of steps that lasts about ``--seconds`` on every rank, timed
on rank 0's host clock between two barriers. The reference follows the
compared steps on every rank, in float32 with TF32 off, with its ABN
statistics and gradients summed over the same ranks: each step's global
loss, the first gradient and the parameters' change on rank 0, and the
model's outputs in the first step on rank 0 (a forward hook), against the
reference's."""

from __future__ import annotations

import contextlib
import math
import multiprocessing as mp
import os
import socket
import time
import traceback
from datetime import timedelta
from typing import Dict, List

import torch
import torch.distributed as tdist

from benchmark.harness import compare, weights, work
from benchmark.harness.synthetic import synthetic_batches
from benchmark.reference import build as ref_build
from benchmark.reference import dist as ref_dist
from benchmark.reference import schedule as ref_schedule
from benchmark.reference import step0 as ref_step0
from benchmark.reference.phase2 import TrainState as RefTrainState

GROUP_TIMEOUT = timedelta(seconds=120)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _device(kind: str, rank: int, world: int) -> torch.device:
    if kind == "cuda":
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    # ranks on the CPU share its cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    return torch.device("cpu")


def _join(rank: int, world: int, port: int, dev: torch.device) -> None:
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    tdist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
        timeout=GROUP_TIMEOUT, **kw)


def _worker(rank, world, port, cfg, mix, seed, kind, conn) -> None:
    """Ranks 1..: join the group, then run the calls rank 0 sends."""
    try:
        dev = _device(kind, rank, world)
        _join(rank, world, port, dev)
        me = Rank(cfg, mix, seed, dev)
        while True:
            name, args = conn.recv()
            if name == "stop":
                break
            conn.send(("ok", getattr(me, name)(*args)))
    except Exception:   # reported to rank 0, which raises it
        conn.send(("error", traceback.format_exc()))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        conn.close()


class Rank:
    """One rank's part of the run."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, dev: torch.device):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.classes = (cfg["classes"][0],)
        self.b = cfg["batch_size"]
        with torch.device("meta"):
            self.spec = weights.spec_of(
                {"model": ref_build.model(cfg, self.classes)})
        self.ref = None

    # ------------------------------------------------------------ inputs
    def _batches(self) -> List[Dict[str, torch.Tensor]]:
        r, w = tdist.get_rank(), tdist.get_world_size()
        out = []
        for b in synthetic_batches(self.b * w, self.cfg["crop_size"],
                                   self.classes[0] - 1,
                                   weights.sub_seed(self.seed, "batches"),
                                   self.mix["n_batches"]):
            out.append({k: torch.from_numpy(
                b[k][r * self.b:(r + 1) * self.b]).to(self.dev)
                for k in ("image", "seg", "inst")})
        return out

    def _load(self, model: torch.nn.Module) -> None:
        st = weights.seeded_state(self.spec,
                                  weights.sub_seed(self.seed, "weights"),
                                  self.dev)
        model.to_empty(device=self.dev)
        model.load_state_dict(weights.split(st, "model"))

    def _gen(self) -> torch.Generator:
        return torch.Generator(device=self.dev).manual_seed(
            weights.sub_seed(self.seed, "dropout"))

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        tdist.barrier()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _global(self, x: float) -> float:
        t = torch.tensor([x], dtype=torch.float64,
                         device=self.dev if self.dev.type == "cuda"
                         else "cpu")
        tdist.all_reduce(t)
        return float(t)

    def _first_steps(self, step, state, batches, n, gen) -> Dict:
        """`n` steps on batches 0..n-1: the global losses, the first
        gradient as Adam holds it and the parameters' change."""
        opt = state.optimizer
        train = [(k, p) for k, p in state.model.named_parameters()
                 if p.requires_grad]
        before = {k: p.detach().clone() for k, p in train}
        first: Dict = {}

        def keep(_module, _inp, out):   # returns None: the output stays
            if not first:
                first.update({k: v.detach().float().cpu()
                              for k, v in out.items()})
        hook = state.model.register_forward_hook(keep)
        losses, grads = [], None
        try:
            for i in range(n):
                m = step(state, batches[i], gen)
                losses.append(self._global(float(m["loss"])))
                if i == 0:
                    beta1 = opt.param_groups[0]["betas"][0]
                    grads = {k: opt.state[p].get("exp_avg",
                                                 torch.zeros_like(p))
                             .detach() / (1 - beta1) for k, p in train}
        finally:
            hook.remove()
        change = {k: p.detach() - before[k] for k, p in train}
        return {"losses": losses, "grads": grads, "change": change,
                "out": first}

    # ----------------------------------------------------------- program
    def setup(self) -> float:
        """Returns the seconds a step took over the last warm-up steps."""
        from cl4wsis_tpu_torch.models import make_model
        from cl4wsis_tpu_torch.train import schedule, step0
        from cl4wsis_tpu_torch.train.state import TrainState

        cfg, mix, s0 = self.cfg, self.mix, self.cfg["step0"]
        self.batches = self._batches()
        with torch.device("meta"):
            model = make_model(self.classes, cfg["backbone"],
                               cfg["output_stride"], cfg["crop_size"],
                               backbone_structure=tuple(cfg["blocks"]))
        self._load(model)
        opt = schedule.make_optimizer(model, "adam")
        self.state = TrainState(model, opt, schedule.make_schedule(
            "poly", s0["lr"], s0["max_iters"]))
        self.step = step0.make_step0_train_step(
            model, seg_loss=s0["seg_loss"], sigma=s0["sigma"],
            max_inst=s0["max_inst"], device=str(self.dev),
            dtype=cfg["dtype"])
        self.gen = self._gen()
        self.got = self._first_steps(self.step, self.state, self.batches,
                                     mix["check_steps"], self.gen)
        self.next = mix["check_steps"]
        timed = []
        for i in range(mix["check_steps"], mix["warmup_steps"]):
            self._sync()
            t = time.perf_counter()
            self.step(self.state, self._batch(), self.gen)
            self._sync()
            timed.append(time.perf_counter() - t)
        return min(timed)

    def _batch(self) -> Dict[str, torch.Tensor]:
        b = self.batches[self.next % len(self.batches)]
        self.next += 1
        return b

    def _peak_reset(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)

    def _peak(self) -> int:
        return (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else 0)

    def _steps(self, n: int):
        losses = []
        self._sync()
        t0 = time.perf_counter()
        for _ in range(n):
            losses.append(self.step(self.state, self._batch(),
                                    self.gen)["loss"])
        self._sync()
        elapsed = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return elapsed, failed

    def window(self, n: int) -> Dict:
        import gc
        gc.collect()
        self._peak_reset()
        elapsed, failed = self._steps(n)
        return {"elapsed": elapsed, "failed": failed, "peak": self._peak()}

    def traced(self, n: int):
        from torch.profiler import ProfilerActivity, profile
        from benchmark.harness.trace import Trace, chrome_events
        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._peak_reset()
        with profile(activities=acts) as prof:
            elapsed, failed = self._steps(n)
        out = {"elapsed": elapsed, "failed": failed, "peak": self._peak()}
        if tdist.get_rank() == 0:
            out["prof"] = prof
        else:
            out["busy_s"] = Trace(chrome_events(prof), elapsed).busy_s()
        return out

    def release(self) -> None:
        del self.step, self.state, self.gen
        import gc
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------- reference
    def _reference(self, precision: str, half: bool = False,
                   exchange: bool = True) -> Dict:
        s0 = self.cfg["step0"]
        with ref_build.no_tf32():
            with torch.device("meta"):
                model = ref_build.model(self.cfg, self.classes)
            self._load(model)
            ref_build.set_precision(model, precision)
            opt = ref_schedule.make_optimizer(model, "adam")
            state = RefTrainState(model, opt, ref_schedule.make_schedule(
                "poly", s0["lr"], s0["max_iters"]))
            step = ref_step0.make_step0_train_step(
                model, seg_loss=s0["seg_loss"], sigma=s0["sigma"],
                max_inst=s0["max_inst"], device=str(self.dev))
            batches = self.batches
            if half:
                batches = [{k: v[:len(v) // 2] for k, v in b.items()}
                           for b in batches]
            real = ref_dist.sum_grads
            if not exchange:
                ref_dist.sum_grads = lambda params: None
            try:
                out = self._first_steps(step, state, batches,
                                        self.mix["check_steps"], self._gen())
            finally:
                ref_dist.sum_grads = real
        del model, state, step, opt
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def _readings(self, got: Dict) -> Dict[str, float]:
        if self.ref is None:
            self.ref = self._reference("fp32")
        ref = self.ref
        live = compare.live_leaves(ref["grads"])
        r = {"loss_gap": compare.loss_gap(got["losses"], ref["losses"]),
             "grad_gap": compare.median_gap(got["grads"], ref["grads"],
                                            live),
             "grad_gap.worst": compare.norm_gap(got["grads"], ref["grads"],
                                                live),
             "change_gap": compare.norm_gap(got["change"], ref["change"],
                                            live)}
        if got["out"] and set(got["out"]) == set(ref["out"]) and all(
                got["out"][k].shape == ref["out"][k].shape
                for k in ref["out"]):
            gaps = {k: compare.out_gap({k: got["out"][k]}, {k: ref["out"][k]})
                    for k in ref["out"]}
            r["out_gap"] = max(gaps.values())
            r.update({f"out_gap.{k}": v for k, v in gaps.items()})
        else:
            r["out_gap"] = math.inf
        if not all(math.isfinite(v) for v in got["losses"]):
            r["loss_gap"] = math.inf
        return r

    def check(self) -> Dict[str, float]:
        return self._readings(self.got)

    def control_readings(self, kind: str) -> Dict[str, float]:
        got = {"fp8": lambda: self._reference("fp8"),
               "bf16": lambda: self._reference("bf16"),
               "half_batch": lambda: self._reference("fp32", half=True),
               "no_exchange": lambda: self._reference("fp32",
                                                      exchange=False),
               }[kind]()
        return self._readings(got)

    def sample_run(self) -> None:
        """Nothing: set-up already ran the compared steps."""


class Driver:
    """Rank 0's side: it runs its own Rank and forwards every call to the
    other ranks' processes, which it starts in `setup` and stops in
    `close`."""

    CONTROLS = ("fp8", "half_batch", "no_exchange")
    WITNESSES = ("bf16",)

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.kind = cfg, mix, seed, device.type
        self.world = mix["world"]
        self.b = cfg["batch_size"]
        self.procs, self.pipes = [], []

    def _all(self, name: str, *args) -> List:
        for c in self.pipes:
            c.send((name, args))
        mine = getattr(self.me, name)(*args)
        out = [mine]
        for r, c in enumerate(self.pipes, 1):
            status, val = c.recv()
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{val}")
            out.append(val)
        return out

    def setup(self) -> None:
        if self.kind == "cuda":
            from cl4wsis_tpu_torch.ops import kernels
            kernels.build()    # once, before the ranks load it
        port = _free_port()
        ctx = mp.get_context("spawn")
        for r in range(1, self.world):
            a, b = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(
                r, self.world, port, self.cfg, self.mix, self.seed,
                self.kind, b), daemon=True)
            p.start()
            self.procs.append(p)
            self.pipes.append(a)
        dev = _device(self.kind, 0, self.world)
        _join(0, self.world, port, dev)
        self.me = Rank(self.cfg, self.mix, self.seed, dev)
        self.step_s = max(self._all("setup"))

    def window(self, seconds: float) -> Dict:
        n = max(1, math.ceil(seconds / self.step_s))
        res = self._all("window", n)
        return {"metrics": {"train_img_s": n * self.b * self.world /
                            res[0]["elapsed"]},
                "attempted": n, "failed": sum(r["failed"] for r in res),
                "peak_bytes": max(r["peak"] for r in res)}

    def traced(self):
        n = self.mix["trace_steps"]
        res = self._all("traced", n)
        prof, window_s = res[0]["prof"], res[0]["elapsed"]
        w = {"attempted": n, "failed": sum(r["failed"] for r in res),
             "peak_bytes": max(r["peak"] for r in res),
             "images": n * self.b, "steps": n,
             "busy_others": [r["busy_s"] for r in res[1:]],
             "flops": n * self.world * work.step0_flops(self.cfg),
             "kernel_bytes": n * work.step0_kernel_bytes(self.cfg)}
        return prof, window_s, w

    def release(self) -> None:
        self._all("release")

    def sample_run(self) -> None:
        """Nothing: set-up already ran the compared steps."""

    def check(self) -> Dict[str, float]:
        return self._all("check")[0]

    def control_readings(self, kind: str) -> Dict[str, float]:
        return self._all("control_readings", kind)[0]

    def close(self) -> None:
        """Stop the other ranks, leave the group with them (every rank
        destroys it at once), and wait for each process to end."""
        for c in self.pipes:
            with contextlib.suppress(OSError, BrokenPipeError):
                c.send(("stop", ()))
        if tdist.is_initialized():
            tdist.destroy_process_group()
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self.procs, self.pipes = [], []
