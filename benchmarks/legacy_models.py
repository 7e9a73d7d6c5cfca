"""Legacy model-family throughput: reference torch (CPU) vs this framework
(one GPU).

The reference ships no benchmark for the dormant family (SURVEY.md §6), so
this harness defines the comparison: identical weights (converted via
``core/torch_import``), identical inputs, realistic production geometry —
the full 82x67 grid for ``simulation_grid_model_v3`` (5,494 grid tokens,
the reference's hot loop per SURVEY §3.4, ``model.py:1446``) and a
550-station network for ``MultiAir`` (``model.py:251``).

Warm-up executions are discarded and every timed step ends in
``jax.block_until_ready``.  Needs the reference torch sources and an
accelerator.

Usage:  PYTHONPATH=. python benchmarks/legacy_models.py [--models m1,m2]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types

import numpy as np

REFERENCE_SRC = "/root/reference/src"


def _patch_reference():
    """Import-time patches for the GPU-assuming reference (same recipe as
    tests/conftest.py, inlined because conftest forces the CPU backend)."""
    if REFERENCE_SRC not in sys.path:
        sys.path.insert(0, REFERENCE_SRC)
    import torch

    torch.Tensor.cuda = lambda self, *a, **k: self
    if not hasattr(np, "Inf"):
        np.Inf = np.inf
    for name in ("ipdb",):
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.set_trace = lambda *a, **k: None
            sys.modules[name] = mod


def _time_torch(fn, iters, warmup=1):
    import torch

    with torch.no_grad():
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
    return (time.perf_counter() - t0) / iters


def _time_jax(fn, iters, warmup=3):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / iters


def bench_multiair(rng):
    import model as ref
    import torch

    import jax
    import jax.numpy as jnp
    from vit_grid_model_tpu.core.torch_import import convert_station_model
    from vit_grid_model_tpu.models.legacy.station import (StationModelSpec,
                                                          station_model_apply)

    B, T_in, T_out, korea, china, fd, h = 8, 7, 6, 400, 150, 12, 64
    stn = korea + china
    lats = rng.random(stn) * 5 + 33
    lons = rng.random(stn) * 5 + 125
    tm = ref.MultiAir(input_dim=T_in, lats=lats, lons=lons, feat_dim=fd,
                      hidden_dim=h, pm25_mean=20.0, pm25_std=10.0,
                      output_dim=T_out, prev_len=T_in, korea_stn_num=korea,
                      china_stn_num=china, normalization_method="RevIN")
    tm.eval()
    feats = torch.rand(B, T_in, stn, fd) * 30
    masks = torch.rand(B, T_in + T_out, stn) > 0.2
    raw_times = torch.stack([
        torch.randint(1, 13, (B, T_in + T_out)).float(),
        torch.randint(1, 29, (B, T_in + T_out)).float(),
        torch.randint(0, 24, (B, T_in + T_out)).float()], dim=-1)
    prev_vals = torch.rand(B, T_in, stn) * 30
    sat_outputs = torch.rand(B, stn, T_out) * 25
    sat_inputs = torch.rand(B, stn, 13)

    t_torch = _time_torch(
        lambda: tm(feats.clone(), masks, raw_times, prev_vals,
                   sat_outputs.clone(), sat_inputs.clone()), iters=3)

    spec = StationModelSpec(
        input_dim=T_in, feat_dim=fd, hidden_dim=h, pm25_mean=20.0,
        pm25_std=10.0, output_dim=T_out, prev_len=T_in, korea_stn_num=korea,
        china_stn_num=china, normalization_method="RevIN",
        variant="multiair")
    p = convert_station_model(
        {k: v.detach().numpy() for k, v in tm.state_dict().items()},
        "multiair", lats, lons)
    args = [jax.device_put(jnp.asarray(a.numpy()))
            for a in (feats, masks, raw_times, prev_vals, sat_outputs,
                      sat_inputs)]
    p = jax.device_put(p)
    step = jax.jit(lambda pp, *a: station_model_apply(pp, spec, *a))
    t_jax = _time_jax(lambda: step(p, *args), iters=10)
    return B, t_torch, t_jax


def bench_grid_v3(rng):
    import model as ref
    import torch

    import jax
    import jax.numpy as jnp
    from vit_grid_model_tpu.core.torch_import import convert_grid_model
    from vit_grid_model_tpu.models.legacy.grid import (GridModelSpec,
                                                       grid_model_apply)

    # full production grid: 82x67 = 5,494 grid tokens + 550 stations in the
    # joint per-step MHA — the reference's hot loop (model.py:1446)
    B, T_in, T_out, korea, china, fd, h = 1, 7, 6, 400, 150, 12, 32
    gh, gw = 82, 67
    stn = korea + china
    lats = rng.random(stn) * 5 + 33
    lons = rng.random(stn) * 5 + 125
    coords = rng.random((gh, gw, 2)) * 10 + 30
    tm = ref.simulation_grid_model_v3(
        input_dim=T_in, lats=lats, lons=lons, cmaq_coords=coords,
        feat_dim=fd, hidden_dim=h, pm25_mean=20.0, pm25_std=10.0,
        output_dim=T_out, prev_len=T_in, korea_stn_num=korea,
        china_stn_num=china, normalization_method="Standard")
    tm.eval()
    feats = torch.rand(B, T_in, stn, fd) * 30
    masks = torch.rand(B, T_in + T_out, stn) > 0.2
    raw_times = torch.stack([
        torch.randint(1, 13, (B, T_in + T_out)).float(),
        torch.randint(1, 29, (B, T_in + T_out)).float(),
        torch.randint(0, 24, (B, T_in + T_out)).float()], dim=-1)
    prev_vals = torch.rand(B, T_in, gh, gw) * 30
    sim = torch.rand(B, gh, gw, (T_in + T_out) * ((fd // 2) * 4 + 4)) * 25

    t_torch = _time_torch(
        lambda: tm(feats.clone(), masks, raw_times, prev_vals.clone(),
                   sim.clone()), iters=2)

    spec = GridModelSpec(
        input_dim=T_in, feat_dim=fd, hidden_dim=h, pm25_mean=20.0,
        pm25_std=10.0, output_dim=T_out, prev_len=T_in, korea_stn_num=korea,
        china_stn_num=china, grid_shape=(gh, gw),
        normalization_method="Standard", version=3)
    p = convert_grid_model(
        {k: v.detach().numpy() for k, v in tm.state_dict().items()},
        3, lats, lons, coords)
    args = [jax.device_put(jnp.asarray(a.numpy()))
            for a in (feats, masks, raw_times, prev_vals, sim)]
    p = jax.device_put(p)
    step = jax.jit(lambda pp, *a: grid_model_apply(pp, spec, *a))
    t_jax = _time_jax(lambda: step(p, *args), iters=10)
    return B, t_torch, t_jax


def bench_simvp(rng):
    import model as ref
    import torch

    import jax
    import jax.numpy as jnp
    from vit_grid_model_tpu.core.torch_import import convert_simvp
    from vit_grid_model_tpu.models.simvp import SimVPSpec, simvp_apply

    # NOT the 82x67 production grid: the reference SimVP decoder crashes on
    # odd spatial sizes (stride-2 skip-connection shape mismatch,
    # model.py:243), so the comparison runs at the nearest even geometry.
    B, T, C, H, W = 4, 7, 12, 80, 64
    tm = ref.SimVP_adv(shape_in=(T, C, H, W), hid_S=16, hid_T=64, N_S=4,
                       N_T=4, groups=4)
    tm.eval()
    x = torch.randn(B, T, C, H, W)
    t_torch = _time_torch(lambda: tm(x), iters=3)

    spec = SimVPSpec(shape_in=(T, C, H, W), hid_s=16, hid_t=64, n_s=4,
                     n_t=4, groups=4)
    p = convert_simvp({k: v.detach().numpy()
                       for k, v in tm.state_dict().items()}, n_s=4, n_t=4)
    xj = jax.device_put(jnp.asarray(x.numpy()))
    p = jax.device_put(p)
    step = jax.jit(lambda pp, xx: simvp_apply(pp, spec, xx))
    t_jax = _time_jax(lambda: step(p, xj), iters=10)
    return B, t_torch, t_jax


BENCHES = {"multiair": bench_multiair, "grid_v3": bench_grid_v3,
           "simvp": bench_simvp}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", type=str, default=",".join(BENCHES))
    args = ap.parse_args()
    _patch_reference()
    from vit_grid_model_tpu.utils.peaks import accelerator_fields

    device = accelerator_fields("legacy_models")
    rng = np.random.default_rng(0)
    for name in args.models.split(","):
        B, t_torch, t_jax = BENCHES[name](rng)
        print(json.dumps({
            "metric": f"legacy_{name}_samples_per_sec",
            "torch_cpu": B / t_torch,
            "device": B / t_jax,
            "speedup": t_torch / t_jax,
            **device,
        }), flush=True)


if __name__ == "__main__":
    main()
