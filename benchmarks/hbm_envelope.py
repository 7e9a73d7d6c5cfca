"""Device-memory envelope: the largest batch per mode that fits the card.

Sweeps the flagship 12hr inference forward and the ``--fast`` train step
upward in batch size until XLA reports RESOURCE_EXHAUSTED, and prints the
largest batch that runs, the first that does not, and the memory JAX may
use on the device (``memory_stats()["bytes_limit"]``, which depends on
``XLA_PYTHON_CLIENT_MEM_FRACTION``).  The runtime guard that turns the raw
allocator dump into an actionable message lives in ``utils/hbm.py``.
Needs an accelerator.

Usage: python benchmarks/hbm_envelope.py [--mode infer|train|both]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_grid_model_tpu.core.config import MetNet3Config  # noqa: E402
from vit_grid_model_tpu.models.metnet3 import (metnet3_apply,  # noqa: E402
                                               metnet3_init)
from vit_grid_model_tpu.utils.hbm import is_oom_error  # noqa: E402


def _cfg(**kw):
    return MetNet3Config(
        window_size=25, n_variables=24, n_start_channels=128,
        end_lead_time=12, pm25_mean=22.5, pm25_std=15.5,
        compute_dtype="bfloat16", fuse_lead_stem=True, **kw)


def try_infer(B: int) -> bool:
    cfg = _cfg()
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray(np.random.default_rng(0).random(
        (B, 25, 24, 82, 67), dtype=np.float32) * 50, jnp.bfloat16)
    ts = jnp.tile(jnp.asarray([2023., 1., 15., 6.]), (B, 25, 1))
    try:
        jax.block_until_ready(jax.jit(
            lambda p, a, b: metnet3_apply(p, a, b, cfg))(params, x, ts))
        return True
    except Exception as e:                      # noqa: BLE001
        if is_oom_error(e):
            return False
        raise


def try_train(B: int) -> bool:
    from vit_grid_model_tpu.core.config import TrainConfig
    from vit_grid_model_tpu.train.trainer import (build_train_step,
                                                  init_train_state)

    cfg = _cfg(dropout=0.1)
    tc = TrainConfig()
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    state = init_train_state(params, tc)
    step = build_train_step(cfg, tc)
    rng = np.random.default_rng(0)
    batch = {
        "x": jnp.asarray(rng.random((B, 25, 24, 82, 67), np.float32) * 50,
                         jnp.bfloat16),
        "timestamps": jnp.tile(jnp.asarray([2023., 1., 15., 6.]),
                               (B, 25, 1)),
        "targets": jnp.asarray(rng.random((B, 12, 82, 67), np.float32) * 40),
    }
    try:
        jax.block_until_ready(step(state, batch))
        return True
    except Exception as e:                      # noqa: BLE001
        if is_oom_error(e):
            return False
        raise


def sweep(fn, batches):
    last_ok, first_fail = None, None
    for B in batches:
        ok = fn(B)
        print(f"# B={B}: {'ok' if ok else 'OOM'}", flush=True)
        if ok:
            last_ok = B
        else:
            first_fail = B
            break
    return last_ok, first_fail


def main():
    from vit_grid_model_tpu.utils.peaks import accelerator_fields

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("infer", "train", "both"),
                    default="both")
    args = ap.parse_args()
    device = accelerator_fields("hbm_envelope")
    stats = jax.devices()[0].memory_stats() or {}
    out = {"metric": "device_memory_envelope",
           "bytes_limit": stats.get("bytes_limit")}
    if args.mode in ("infer", "both"):
        ok, fail = sweep(try_infer, (32, 64, 128, 256, 384, 512, 768, 1024))
        out["infer_max_batch"], out["infer_oom_batch"] = ok, fail
    if args.mode in ("train", "both"):
        ok, fail = sweep(try_train, (4, 8, 16, 32, 48, 64, 96, 128))
        out["train_fast_max_batch"], out["train_fast_oom_batch"] = ok, fail
    out.update(device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
