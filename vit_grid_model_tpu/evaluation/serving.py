"""Persistent serving entry: lowest-latency single-forecast path.

The eval driver (``evaluation/driver.py``) is throughput-shaped: big
batches, async staging, metrics.  Serving wants the opposite — one (or few)
samples, minimum wall-clock to a forecast.  ``Forecaster`` holds everything
hot so ``predict`` does only: host cast (bf16 halves the host->device
bytes) -> device_put -> the compiled forward -> readback.

Latency levers applied (timed by ``benchmarks/forward_profile.py``):

* params are pre-cast to the compute dtype ON DEVICE once at construction —
  ``metnet3_apply`` otherwise casts the whole tree inside every call;
* the forward is compiled and run once at construction, so compilation
  is paid up front, not on the first request;
* the input buffer is donated — XLA reuses its memory for activations;
* fast mode (bf16 + fused lead stem) by default; ``fast=False`` serves the
  config exactly as given.

No reference counterpart (the reference ships evaluation only); this
completes the production-serving surface of the rebuild.
"""

from __future__ import annotations

import dataclasses
import numpy as np

import jax
import jax.numpy as jnp

from vit_grid_model_tpu.core.config import MetNet3Config


class Forecaster:
    """Hold a compiled forward + device-resident params for serving.

    >>> f = Forecaster(params, cfg)          # compiles + warms up
    >>> fields = f.predict(x, timestamps)    # (B, L, H, W) float32 numpy
    """

    def __init__(self, params, cfg: MetNet3Config, *,
                 batch_size: int = 1, fast: bool = True,
                 warmup: int = 2):
        from vit_grid_model_tpu.models.metnet3 import metnet3_apply

        if fast:
            cfg = dataclasses.replace(
                cfg, compute_dtype="bfloat16", fuse_lead_stem=True)
        self.cfg = cfg
        self.batch_size = batch_size
        self._dtype = jnp.dtype(cfg.compute_dtype)
        # pre-cast the tree once; metnet3_apply's in-trace cast then no-ops
        self._params = jax.device_put(jax.tree.map(
            lambda a: a.astype(self._dtype)
            if hasattr(a, "dtype") and a.dtype == jnp.float32 else a,
            params))

        def fwd(p, x, ts):
            return metnet3_apply(p, x, ts, self.cfg)

        # donate the input buffer: its memory is reused for activations
        self._fwd = jax.jit(fwd, donate_argnums=(1,))
        # compile and run once now, not on request 1
        T = cfg.window_size
        zt = jnp.zeros((batch_size, max(T, 7), 4), jnp.float32)
        for _ in range(max(1, warmup)):
            # fresh buffer per call: the previous one was donated
            zx = jnp.zeros((batch_size, T, cfg.n_variables,
                            cfg.input_height, cfg.input_width), self._dtype)
            out = self._fwd(self._params, zx, zt)
        np.asarray(out)

    def predict(self, x, timestamps) -> np.ndarray:
        """x: (B, T, C, H, W) host array; timestamps: (B, T', 4).
        Returns (B, L, H, W) float32 PM2.5 fields."""
        from vit_grid_model_tpu.data.bufferpool import POOL

        x = np.asarray(x)
        if x.dtype != self._dtype:
            # pooled cast: a fresh per-request allocation pays first-touch
            # page faults on every request
            out = POOL.get(x.shape, self._dtype)
            np.copyto(out, x, casting="same_kind")
            x = out
        xd = jax.device_put(x)
        td = jax.device_put(np.asarray(timestamps, np.float32))
        return np.asarray(self._fwd(self._params, xd, td))
