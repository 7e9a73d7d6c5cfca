"""Host staging A/B: native fused repack vs the numpy path, pooled both
sides — the executable form of the "staging repack gone native"
measurement.

Measures `sim_stack_to_model_input`'s two implementations on the flagship
B=25 eval batch (the `evaluation_vit.py:248-249` reshape contract,
385 MB f32), for f32 and for the fast-mode fused bf16 cast.  Interleaved
reps + median so this shared VM's run-to-run noise (up to 1.5x) doesn't
pick the winner.

Usage: PYTHONPATH=. python benchmarks/host_staging.py
"""
from __future__ import annotations

import json
import time

import numpy as np

import jax.numpy as jnp

from vit_grid_model_tpu.data import native
from vit_grid_model_tpu.data.bufferpool import POOL


def main():
    b, h, w, t, bc = 25, 82, 67, 25, 28
    sim = np.random.default_rng(0).random(
        (b, h, w, t * bc), np.float32) * 60
    shape = (b, t, bc - 4, h, w)

    def native_repack(dtype):
        out = POOL.get(shape, dtype)
        assert native.repack_model_input_native(sim, t, out)
        return out

    def numpy_repack(dtype):
        out32 = POOL.get(shape, np.float32)
        x = sim.reshape(b, h, w, t, -1).transpose(0, 3, 4, 1, 2)[:, :, :-4]
        np.copyto(out32, x)
        if dtype == np.float32:
            return out32
        out = POOL.get(shape, dtype)           # the round-2 two-step cast
        np.copyto(out, out32, casting="same_kind")
        return out

    if not native.available():
        print(json.dumps({"metric": "host_staging_ms", "error":
                          "native library unavailable"}))
        return

    def nhwc_repack(dtype):
        # round-4 device-layout staging (MetNet3Config.nhwc_input): a pure
        # streaming channel-subset copy — no axis permutation at all
        from vit_grid_model_tpu.data.assembly import sim_stack_to_nhwc_input

        return sim_stack_to_nhwc_input(sim, t, 14, dtype)

    cases = [("native_f32", native_repack, np.float32),
             ("native_bf16_fused", native_repack, jnp.bfloat16),
             ("numpy_f32", numpy_repack, np.float32),
             ("numpy_two_step_bf16", numpy_repack, jnp.bfloat16),
             ("nhwc_f32", nhwc_repack, np.float32),
             ("nhwc_bf16_fused", nhwc_repack, jnp.bfloat16)]
    times = {k: [] for k, _, _ in cases}
    for _ in range(2):                          # warm (fault-in) the pool
        for _, fn, dt in cases:
            x = fn(dt)
            del x
    for _ in range(6):                          # interleaved measurement
        for k, fn, dt in cases:
            t0 = time.perf_counter()
            x = fn(dt)
            times[k].append(time.perf_counter() - t0)
            del x

    med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in times.items()}
    print(json.dumps({
        "metric": "host_staging_ms_b25_flagship",
        **{k: round(v, 1) for k, v in med.items()},
        "native_speedup_f32": round(med["numpy_f32"] / med["native_f32"], 2),
        "native_speedup_bf16": round(
            med["numpy_two_step_bf16"] / med["native_bf16_fused"], 2),
    }))


if __name__ == "__main__":
    main()
