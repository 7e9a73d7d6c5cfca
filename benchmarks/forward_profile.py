"""Forward decomposition + serving latency on one GPU.

Numbers that frame the training-step and serving economics:

* eval-mode forward at the train batch (B=4) — the irreducible forward;
* training-mode forward (+ dropout sampling + BN-stat collection) — the
  delta is the cost of training-mode extras;
* B=1 latency of one full 12-lead forecast at the shipped 12hr config in
  fast mode, as a plain jit and as the ``Forecaster`` path (params
  pre-cast on the device, donated input buffer, host cast + transfer
  included).

(The full train step is measured by benchmarks/train_step.py; the
per-stage split comes from a profiler trace, benchmarks/trace_forward.py.)

Warm-up calls are discarded and every timed call ends in
``jax.block_until_ready``; the median is reported.  Needs an accelerator.

Usage:  python benchmarks/forward_profile.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

from vit_grid_model_tpu.core.config import shipped_12hr_model_config  # noqa: E402
from vit_grid_model_tpu.models.metnet3 import (metnet3_apply,  # noqa: E402
                                               metnet3_init)


def timeit(fn, iters=20, warm=3):
    """Median wall ms of ``fn()`` ended by ``jax.block_until_ready``."""
    for _ in range(warm):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def main():
    from vit_grid_model_tpu.evaluation.serving import Forecaster
    from vit_grid_model_tpu.utils.peaks import accelerator_fields

    device = accelerator_fields("forward_profile")
    rng = np.random.default_rng(0)
    out = {"metric": "forward_profile_ms"}

    # train geometry (13 -> 12, hidden 128), --fast numerics, B=4
    cfg = dataclasses.replace(
        shipped_12hr_model_config(pm25_mean=22.5, pm25_std=15.5),
        dropout=0.1, compute_dtype="bfloat16", fuse_lead_stem=True)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    x = jax.device_put(rng.random((4, 25, 24, 82, 67),
                                  dtype=np.float32) * 50)
    ts = jax.device_put(np.tile(np.asarray([2023., 1., 15., 6.],
                                           np.float32), (4, 25, 1)))
    efwd = jax.jit(lambda p, a, b: metnet3_apply(p, a, b, cfg))
    out["eval_fwd_b4"] = timeit(lambda: efwd(params, x, ts))

    key = jax.random.PRNGKey(1)
    tfwd = jax.jit(lambda p, a, b: metnet3_apply(p, a, b, cfg,
                                                 training=True, rng=key))
    out["train_fwd_b4"] = timeit(lambda: tfwd(params, x, ts))

    # serving latency: shipped 12hr config, fast mode, B=1
    x1 = jax.device_put(rng.random((1, 25, 24, 82, 67),
                                   dtype=np.float32) * 50)
    ts1 = np.tile(np.asarray([2023., 1., 15., 6.], np.float32), (1, 25, 1))
    out["serving_b1_jit"] = timeit(
        lambda: efwd(params, x1, jax.device_put(ts1)))

    # the Forecaster path, host input included: cast, transfer, forward,
    # readback
    f = Forecaster(params, shipped_12hr_model_config(22.5, 15.5))
    x1h = rng.random((1, 25, 24, 82, 67), dtype=np.float32) * 50
    out["serving_b1_forecaster"] = timeit(lambda: f.predict(x1h, ts1))
    out.update(device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
