"""Flagship train-step benchmark: plain bf16 vs the ``--fast`` configurations.

Measures the steady-state training step (hidden 128, 13 -> 12 leads, bf16,
dropout 0.1 — the shipped 12hr architecture with the reconstructed Focal-R
trainer, SURVEY.md §3.5) in three configurations:

* ``xla``: bf16 compute, the per-lead stem;
* ``fast``: + the fused lead stem;
* ``fast_nhwc``: + host-prepared NHWC input, what ``train_vit --fast`` runs.

The batch is staged on the device first, warm-up steps are discarded, and
every timed step ends in ``jax.block_until_ready``.  MFU divides the HLO
flop count of one step by the step time and the device's bf16 peak
(``utils/peaks.py``).  Needs an accelerator.

Usage:  python benchmarks/train_step.py [--batch 4] [--steps 20]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODES = ("xla", "fast", "fast_nhwc")


def _cfg(mode: str):
    from vit_grid_model_tpu.core.config import MetNet3Config

    return MetNet3Config(
        window_size=25, n_variables=24, n_start_channels=128,
        end_lead_time=12, pm25_mean=22.5, pm25_std=15.5, dropout=0.1,
        compute_dtype="bfloat16", fuse_lead_stem=mode != "xla",
        nhwc_input=mode == "fast_nhwc")


def train_step_flops(batch_size: int) -> float:
    """HLO flop count of one full train step (fwd + bwd + AdamW), lowered
    (not compiled) on the CPU backend from abstract shapes — the same
    currency bench.py uses for inference MFU."""
    import jax
    import jax.numpy as jnp

    from vit_grid_model_tpu.core.config import TrainConfig
    from vit_grid_model_tpu.models.metnet3 import metnet3_init
    from vit_grid_model_tpu.train.trainer import (build_train_step,
                                                  init_train_state)

    cfg = _cfg("xla")
    tc = TrainConfig(learning_rate=1e-4, total_steps=1000, warmup_steps=10,
                     batch_size=batch_size)
    with jax.default_device(jax.devices("cpu")[0]):
        state = jax.eval_shape(
            lambda k: init_train_state(metnet3_init(k, cfg), tc),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
        batch = {
            "x": jax.ShapeDtypeStruct((batch_size, 25, 24, 82, 67),
                                      jnp.float32),
            "timestamps": jax.ShapeDtypeStruct((batch_size, 25, 4),
                                               jnp.float32),
            "targets": jax.ShapeDtypeStruct((batch_size, 12, 82, 67),
                                            jnp.float32),
        }
        cost = build_train_step(cfg, tc).lower(state, batch).cost_analysis()
    return float(cost.get("flops", 0.0))


def run(batch_size: int, steps: int, warmup: int = 3, modes=MODES):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vit_grid_model_tpu.core.config import TrainConfig
    from vit_grid_model_tpu.data.assembly import model_input_to_nhwc
    from vit_grid_model_tpu.models.metnet3 import metnet3_init
    from vit_grid_model_tpu.train.trainer import (build_train_step,
                                                  init_train_state)
    from vit_grid_model_tpu.utils.peaks import accelerator_fields, peaks_for

    device = accelerator_fields("train_step")
    peak = peaks_for(device["device_kind"]).bf16_flops
    rng = np.random.default_rng(0)
    batch_host = {
        "x": rng.random((batch_size, 25, 24, 82, 67), dtype=np.float32) * 50,
        "timestamps": np.tile(
            np.asarray([2023.0, 1.0, 15.0, 6.0], np.float32),
            (batch_size, 25, 1)),
        "targets": rng.random((batch_size, 12, 82, 67), dtype=np.float32) * 60,
    }
    batch_nhwc_host = dict(batch_host, x=model_input_to_nhwc(
        batch_host["x"], 14, jnp.bfloat16).copy())

    results = {}
    for mode in modes:
        cfg = _cfg(mode)
        tc = TrainConfig(learning_rate=1e-4, total_steps=1000,
                         warmup_steps=10, batch_size=batch_size)
        params = metnet3_init(jax.random.PRNGKey(0), cfg)
        state = init_train_state(jax.tree.map(jnp.asarray, params), tc)
        step = build_train_step(cfg, tc)
        batch = jax.block_until_ready(jax.device_put(
            batch_nhwc_host if cfg.nhwc_input else batch_host))
        for _ in range(warmup):
            state, m = jax.block_until_ready(step(state, batch))
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = jax.block_until_ready(step(state, batch))
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        results[mode] = ms
        print(f"{mode:10s}: {ms:7.2f} ms/step "
              f"({batch_size / (ms / 1e3):6.1f} samples/s)  "
              f"loss={float(m['loss']):.4f}", flush=True)
    flops = train_step_flops(batch_size)
    out = {"metric": "train_ms_per_step", "batch": batch_size,
           **results, "train_step_tflop": flops / 1e12}
    for k, ms in results.items():
        out[f"{k}_mfu"] = flops / (ms / 1e3) / peak
    out.update(device)
    print(json.dumps(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--modes", type=str, default=",".join(MODES),
                    help="comma-separated subset of %s" % (MODES,))
    args = ap.parse_args()
    run(args.batch, args.steps, modes=tuple(args.modes.split(",")))
