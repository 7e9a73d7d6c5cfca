"""Tracing / profiling utilities.

The reference has no profiling at all — only tqdm bars and BLAS thread
pinning (``evaluation_vit.py:3-5,128,239``; SURVEY.md §5).  Here:

* ``trace(dir)``: context manager around ``jax.profiler`` emitting a
  TensorBoard/XProf trace of the wrapped region;
* ``annotate(name)``: named trace region (shows up on the device timeline);
* ``StepTimer``: steady-state step timing; each step ends in
  ``jax.block_until_ready`` on its result, since dispatch is asynchronous;
* ``throughput_report``: fields/sec summary dict for logs and bench.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region on the device timeline (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


class StepTimer:
    """Steady-state step timing with warmup exclusion.  Put the step's
    output in ``out["result"]`` so the timer waits for the device."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times = []
        self._count = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        out = {}
        yield out
        if "result" in out:
            jax.block_until_ready(out["result"])
        dt = time.perf_counter() - t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    def p50(self) -> float:
        return float(np.percentile(self.times, 50)) if self.times else float("nan")


def throughput_report(timer: StepTimer, items_per_step: int,
                      unit: str = "fields") -> Dict[str, float]:
    mean = timer.mean()
    return {
        f"{unit}_per_sec": items_per_step / mean if mean else float("nan"),
        "step_ms_mean": mean * 1e3,
        "step_ms_p50": timer.p50() * 1e3,
        "steps_measured": len(timer.times),
    }
