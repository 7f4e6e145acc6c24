"""Tracing and per-step timing utilities for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/utils/profiling.py`:

  * `trace(logdir)` — context manager around `torch.profiler` (the host,
    and the card's kernels where there is one) that writes a Chrome trace
    of everything inside to `<logdir>/trace.json` (chrome://tracing,
    Perfetto); it yields the profiler, whose device kernels
    `tools/timing.device_kernels` reads.
  * `StepTimer` — records per-step wall times (waiting on the result's
    device) and reports p50/p90/mean; used by the int8 quality protocol.
  * `annotate(name)` — `torch.profiler.record_function`, so that pipeline
    stages show up named in the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _wait(out) -> None:
    """Waits for the devices of the CUDA tensors in `out` (a tensor or a
    list, tuple or dict of them); a CPU tensor is ready when it returns."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _wait(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _wait(v)


class StepTimer:
    """Wall-clock step timer with percentile reporting.

    with timer.step() as holder:  # waits on the result you put in holder
        out = step_fn(...)
        holder["out"] = out
    """

    def __init__(self, skip_first: int = 1):
        self.times: List[float] = []
        self.skip_first = skip_first
        self._seen = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        holder = {}
        yield holder
        if "out" in holder:
            _wait(holder["out"])
        self._seen += 1
        if self._seen > self.skip_first:
            self.times.append(time.perf_counter() - t0)

    def record(self, seconds: float):
        self._seen += 1
        if self._seen > self.skip_first:
            self.times.append(seconds)

    def stats(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "mean_ms": float(arr.mean() * 1e3),
            "min_ms": float(arr.min() * 1e3),
        }
