"""Benchmark: grid-inference throughput of the shipped 12hr MaxViT MetNet3.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} naming
the platform, device kind, device count, card name and power limit it ran
on.  It needs an accelerator: on a machine whose JAX finds only the CPU it
exits non-zero and prints no result.

Baseline (BASELINE.json): >=10x the PyTorch-CPU grid-inference throughput of
the reference implementation.  The reference measures 1.233 grid-fields/sec
on one CPU core (torch 2.13, B=1, steady state, the reference MetNet3 at the
shipped 12hr architecture), so the baseline target is 12.33 fields/sec;
``vs_baseline`` = value / 12.33.  Re-measure with
``python bench.py --measure-torch``.

Timing: the input is staged in device memory; after a warm-up every call is
timed on its own and ended by ``jax.block_until_ready``; the rate is taken
from the median call.  Compilation is reported separately as set-up.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TORCH_CPU_FIELDS_PER_SEC = 1.233     # measured, see module docstring
TARGET_MULTIPLIER = 10.0
METRIC = "grid_fields_per_sec_per_chip_12hr_maxvit_infer"


def model_cost(cfg, B, precision):
    """Analytic (HLO-derived) FLOPs and bytes of ONE forward at batch B.

    Lowered (not compiled) on the CPU backend from abstract shapes: the HLO
    flop count does not depend on the backend, and no arrays are made.
    'bytes accessed' comes from the UNFUSED HLO — an upper bound on real
    device-memory traffic (XLA fusion removes most intermediate round-trips).
    """
    import dataclasses

    import jax
    import jax.numpy as jnp

    from vit_grid_model_tpu.models.metnet3 import metnet3_apply, metnet3_init

    cfg_std = dataclasses.replace(cfg, nhwc_input=False)
    with jax.default_device(jax.devices("cpu")[0]):
        params = jax.eval_shape(
            lambda k: metnet3_init(k, cfg_std),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
        x = jax.ShapeDtypeStruct((B, 25, 24, 82, 67), jnp.float32)
        ts = jax.ShapeDtypeStruct((B, 25, 4), jnp.float32)

        def forward(p, xx, tt):
            with jax.default_matmul_precision(precision):
                return metnet3_apply(p, xx, tt, cfg_std)

        cost = jax.jit(forward).lower(params, x, ts).cost_analysis()
    return float(cost.get("flops", 0.0)), float(
        cost.get("bytes accessed", 0.0))


def measure_torch_cpu() -> float:
    import types

    sys.path.insert(0, "/root/reference/src")
    import torch

    torch.Tensor.cuda = lambda self, *a, **k: self
    mod = types.ModuleType("ipdb")
    mod.set_trace = lambda *a, **k: None
    sys.modules["ipdb"] = mod
    import metnet3 as ref

    torch.manual_seed(0)
    tm = ref.MetNet3(input_size_sample=(25, 24, 82, 67),
                     n_start_channels=128, end_lead_time=12,
                     pm25_boundaries=[15, 35, 75],
                     pm10_boundaries=[15, 35, 75],
                     pm25_mean=22.5, pm25_std=15.5)
    tm.eval()
    x = torch.rand(1, 25, 24, 82, 67) * 50
    ts = torch.tensor([[[2023., 1., 15., 6.]] * 25])
    with torch.no_grad():
        tm(x, timestamps=ts)
        t0 = time.time()
        tm(x, timestamps=ts)
        dt = time.time() - t0
    return 12 / dt


def time_calls(fn, iters: int, warmup: int = 3):
    """Per-call wall times (s) of ``fn()``, each ended by
    ``jax.block_until_ready``, after ``warmup`` untimed calls."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=["float32", "bfloat16", "int8"],
                    help="int8 = bf16 compute + int8 resnet convs (PTQ, "
                         "ops/quantize.py), calibrated on the bench input; "
                         "reports the RMSE delta vs the bf16 path")
    ap.add_argument("--precision", type=str, default="default")
    ap.add_argument("--fuse-lead-stem", action="store_true", default=True)
    ap.add_argument("--no-fuse-lead-stem", dest="fuse_lead_stem",
                    action="store_false")
    ap.add_argument("--nhwc", action="store_true", default=True,
                    help="stage the input host-prepared in the device "
                         "layout (cfg.nhwc_input; what the production "
                         "fast-mode staging does); bit-exact vs the "
                         "compute-dtype-staged standard path "
                         "(tests/test_nhwc_input.py).  bf16 only.")
    ap.add_argument("--no-nhwc", dest="nhwc", action="store_false")
    ap.add_argument("--measure-torch", action="store_true")
    args = ap.parse_args()

    if args.measure_torch:
        print(json.dumps({"torch_cpu_fields_per_sec": measure_torch_cpu()}))
        return

    import dataclasses

    from vit_grid_model_tpu.core.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vit_grid_model_tpu.core.config import MetNet3Config
    from vit_grid_model_tpu.models.metnet3 import metnet3_apply, metnet3_init
    from vit_grid_model_tpu.utils.peaks import accelerator_fields, peaks_for

    device = accelerator_fields(METRIC)
    peaks = peaks_for(device["device_kind"])

    int8 = args.dtype == "int8"
    compute_dtype = "bfloat16" if int8 else args.dtype
    nhwc = args.nhwc and compute_dtype == "bfloat16" and not int8
    cfg = MetNet3Config(
        window_size=25, n_variables=24, n_start_channels=128,
        end_lead_time=12, pm25_mean=22.5, pm25_std=15.5,
        compute_dtype=compute_dtype, fuse_lead_stem=args.fuse_lead_stem,
        int8_convs=int8)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    B = args.batch
    x = jax.random.uniform(jax.random.PRNGKey(1),
                           (B, 25, 24, 82, 67)) * 50.0
    ts = jnp.tile(jnp.asarray([2023.0, 1.0, 15.0, 6.0]), (B, 25, 1))
    if nhwc:
        # host-prepared device layout, exactly what production fast-mode
        # staging emits (data/assembly.py::sim_stack_to_nhwc_input): the
        # same bf16-rounded values, channels-last, zero-padded.
        from vit_grid_model_tpu.models.metnet3 import pad_values
        cfg = dataclasses.replace(cfg, nhwc_input=True)
        H, W = cfg.input_height, cfg.input_width
        le, ri, to, bo = pad_values(H, W, cfg.pad_multiple)
        xp = np.zeros((B, H + to + bo, W + le + ri, 25 * 24), np.float32)
        xp[:, to:to + H, le:le + W] = (
            np.asarray(x, np.float32).reshape(B, 25 * 24, H, W)
            .transpose(0, 2, 3, 1))
        x = jnp.asarray(xp, jnp.bfloat16)

    int8_rmse_delta = None
    if int8:
        from vit_grid_model_tpu.ops.quantize import quantize_metnet3_int8

        cfg_bf16 = dataclasses.replace(cfg, int8_convs=False)
        params = quantize_metnet3_int8(params, cfg_bf16, [(x, ts)])
        # accuracy gate: RMSE delta vs the bf16 path on the same input
        y_bf16 = jax.jit(lambda p, a, b: metnet3_apply(
            p, a, b, cfg_bf16))(params, x, ts)
        y_int8 = jax.jit(lambda p, a, b: metnet3_apply(
            p, a, b, cfg))(params, x, ts)
        int8_rmse_delta = float(np.sqrt(np.mean(
            (np.asarray(y_int8, np.float64)
             - np.asarray(y_bf16, np.float64)) ** 2)))

    def forward(p, xx, tt):
        with jax.default_matmul_precision(args.precision):
            return metnet3_apply(p, xx, tt, cfg)

    t0 = time.perf_counter()
    fwd = jax.jit(forward).lower(params, x, ts).compile()
    compile_s = time.perf_counter() - t0
    times = time_calls(lambda: fwd(params, x, ts), args.iters)
    dt = float(np.median(times))
    fields_per_sec = B * cfg.end_lead_time / dt

    # MFU from the HLO cost model of the same math (int8 keeps the bf16
    # flop basis and peak: its MFU is directly comparable with bf16's)
    flops, mem_bytes = model_cost(
        dataclasses.replace(cfg, int8_convs=False), B, args.precision)
    peak = peaks.matmul_peak(args.dtype, args.precision)

    baseline = TORCH_CPU_FIELDS_PER_SEC * TARGET_MULTIPLIER
    print(json.dumps({
        "metric": METRIC,
        "value": fields_per_sec,
        "unit": "fields/sec",
        "vs_baseline": fields_per_sec / baseline,
        "batch": B,
        "dtype": args.dtype,
        "precision": args.precision,
        "step_ms_median": dt * 1e3,
        "step_ms_min": min(times) * 1e3,
        "step_ms_max": max(times) * 1e3,
        "calls_timed": len(times),
        "compile_s": compile_s,
        "mfu": flops / dt / peak,
        "tflops_per_sec": flops / dt / 1e12,
        "peak_tflops": peak / 1e12,
        "peak_source": peaks.source,
        "gflops_per_field": flops / (B * cfg.end_lead_time) / 1e9,
        # UNFUSED-HLO byte count: an upper bound on device-memory traffic
        "unfused_intensity_flop_per_byte": flops / max(mem_bytes, 1.0),
        **({"int8_rmse_delta_vs_bf16_ugm3": int8_rmse_delta}
           if int8_rmse_delta is not None else {}),
        **device,
    }))


if __name__ == "__main__":
    main()
