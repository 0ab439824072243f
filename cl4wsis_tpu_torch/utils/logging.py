"""Experiment logging and step timing (counterpart of
``cl4wsis_tpu/utils/logging.py``).

`Logger` keeps the JAX logger's surface (add_scalar with an `intermediate`
stream, commit() batching, config and result records) backed by a JSONL
file, with wandb, offline, only where the package is importable.
``add_image`` waits for ``utils/visualize`` (ROADMAP queue 1, item 9).

`StepTimer` times steps on the host clock after a device synchronise and
traces a range of steps with ``torch.profiler`` into a Chrome trace.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


class Logger:
    def __init__(self, logdir: str, name: Optional[str] = None,
                 summary: bool = True):
        self.logdir = logdir
        self.name = name or "experiment"
        self._epoch_buf: Dict[str, Any] = {}
        self._inter_buf: Dict[str, Any] = {}
        self._jsonl = None
        self._wandb = None
        if summary:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, f"{self.name}.jsonl"), "a")
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:  # pragma: no cover - not installed here
                self._wandb = wandb.init(project="cl4wsis_tpu", name=self.name,
                                         dir=logdir, resume="allow",
                                         mode="offline")

    def add_scalar(self, tag: str, value: Any, step: Optional[int] = None,
                   intermediate: bool = False):
        buf = self._inter_buf if intermediate else self._epoch_buf
        buf[tag] = float(value)
        if step is not None:
            buf["step"] = step

    def add_config(self, cfg: Any):
        blob = cfg if isinstance(cfg, dict) else vars(cfg)
        self._write({"type": "config", **_jsonable(blob)})

    def add_results(self, results: Dict):
        self._write({"type": "results", **_jsonable(results)})

    def add_image(self, tag: str, image, step: Optional[int] = None):
        raise NotImplementedError(
            "Logger.add_image comes with utils/visualize (ROADMAP queue 1, "
            "item 9)")

    def commit(self, intermediate: bool = False):
        buf = self._inter_buf if intermediate else self._epoch_buf
        if buf:
            self._write({"type": "inter" if intermediate else "epoch",
                         "t": time.time(), **buf})
            if self._wandb is not None:  # pragma: no cover
                self._wandb.log(buf)
        buf.clear()

    def info(self, msg: str):
        print(msg, flush=True)

    def debug(self, msg: str):
        print(msg, flush=True)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()

    def _write(self, obj: Dict):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(obj) + "\n")
            self._jsonl.flush()


def _jsonable(d: Dict) -> Dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out


class StepTimer:
    """Host-clock step times, each ending in a device synchronise, and a
    ``torch.profiler`` trace of steps 2-4 (`TRACE_STEPS`) written to
    `trace_dir` as a Chrome trace (the trace stops at the range's end or at
    :meth:`close`, whichever comes first)."""

    TRACE_STEPS = range(2, 5)

    def __init__(self, trace_dir: Optional[str] = None,
                 device: torch.device = torch.device("cpu")):
        self.trace_dir = trace_dir
        self.device = torch.device(device)
        self.times = []
        self._prof = None
        self._first = self._last = None
        self._t0 = None

    def start_step(self, step: int):
        if self.trace_dir and step == self.TRACE_STEPS.start:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._first = step
        self._t0 = time.perf_counter()

    def end_step(self, step: int):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times.append(time.perf_counter() - self._t0)
        self._last = step
        if self._prof is not None and step >= self.TRACE_STEPS.stop - 1:
            self._stop_trace(step)

    def close(self):
        """Stop a trace still open (an epoch shorter than the range)."""
        if self._prof is not None:
            self._stop_trace(self._last)

    def _stop_trace(self, last: int):
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.trace_dir, f"trace_steps_{self._first}-{last}.json"))

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times[1:] or self.times)
        return {"mean_s": float(t.mean()), "p50_s": float(np.median(t)),
                "max_s": float(t.max())}
