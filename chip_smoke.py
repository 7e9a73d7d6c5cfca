"""Smoke test of the main path on one NVIDIA GPU, at the shipped 12hr width.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-gpus   # four cards: the data-parallel paths

Everything runs in this one process, through the entry points a user calls
(each CLI's ``main(argv)`` in-process), on a synthetic data tree and random
weights made from fixed seeds:

* eval      ``cli/evaluation_vit.main``: ``--fast`` and the f32
            ``--precision highest`` path, batch 25, two batches;
* serving   ``evaluation/serving.Forecaster`` at B=1, five requests;
* train     ``cli/train_vit.main --fast``: three steps at batch 4, save,
            resume from ``*_state.npz``, one more step;
* generate  ``cli/generate_reanalysis.main`` over four windows;
* numerics  f32 "highest" on the card vs the CPU backend (B=1); the bf16
            fast path vs that f32 reference (B=2); f32 "default" (TF32)
            vs "highest" (B=2) — each against its stated bound;
* int8      the int8-conv forward compiled at full width, RMSE vs bf16.

``--four-gpus`` runs, in f32 "highest", data-parallel evaluation (a batch
that divides and a ragged tail), one data-parallel train step and
data-parallel generation on four cards, each against the same run on one.

A phase that fails stops the run with a non-zero exit.  The last line of
standard output is one JSON object naming the device; it is printed only
when every phase passed.  Without a GPU the script exits non-zero before
running anything.  Each phase is a function of its widths, so the tests run
them on the CPU at tiny widths.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import json
import os
import sys
import tempfile
import time
from datetime import datetime, timedelta

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

# (relative L2 bound, why) of each numeric comparison
BOUND_F32_VS_CPU = 1e-4       # same f32 math; only the summation order differs
BOUND_FAST_VS_F32 = 2e-2      # bf16 weights and activations (8-bit mantissa)
BOUND_TF32_VS_F32 = 1e-2      # TF32 matmul operands (10-bit mantissa)
BOUND_DATA_PARALLEL = 1e-5    # same f32 "highest" program, sharded
BOUND_DP_PARAMS = 1e-4        # params after one data-parallel step

EVAL_START = datetime(2023, 1, 2, 0)


@dataclasses.dataclass(frozen=True)
class Widths:
    """Model and window widths; the defaults are the shipped 12hr run
    (``core/config.py::shipped_12hr_model_config``)."""

    input_dim: int = 13
    output_dim: int = 12
    prev_len: int = 13
    hidden: int = 128
    heads: int = 32
    dim_head: int = 32

    def model_config(self, **kw):
        from vit_grid_model_tpu.core.config import MetNet3Config
        from vit_grid_model_tpu.data.synthetic import DEFAULT_FEAT_INFOS

        mean, std = DEFAULT_FEAT_INFOS["PM2.5"]
        return MetNet3Config(
            window_size=self.input_dim + self.output_dim, n_variables=24,
            n_start_channels=self.hidden, end_lead_time=self.output_dim,
            n_heads=self.heads, dim_head=self.dim_head,
            pm25_mean=mean, pm25_std=std, **kw)

    def cli_args(self):
        return ["--input_dim", str(self.input_dim),
                "--output_dim", str(self.output_dim),
                "--prev_len", str(self.prev_len),
                "--hidden_dim", str(self.hidden)]


SHIPPED = Widths()


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_tree(root: str, w: Widths, samples: int):
    """Synthetic data tree whose eval window holds ``samples`` samples.
    Returns (paths, start, end)."""
    from vit_grid_model_tpu.data import readers, synthetic

    end = EVAL_START + timedelta(hours=samples - 1)
    paths = synthetic.generate_tree(root, EVAL_START, end,
                                    prev_len=w.prev_len,
                                    output_dim=w.output_dim)
    readers.clear_caches()
    return paths, EVAL_START, end


def _data_args(paths):
    return ["--data_path", paths["data_path"],
            "--sim_data_path", paths["sim_data_path"],
            "--analysis_data_path", paths["analysis_data_path"]]


def _inputs(w: Widths, batch: int, seed: int):
    """A random CMAQ stack (B, T, C, H, W) and its timestamps."""
    rng = np.random.default_rng(seed)
    T = w.input_dim + w.output_dim
    x = (rng.random((batch, T, 24, 82, 67), dtype=np.float32) * 50.0)
    ts = np.tile(np.asarray([2023.0, 1.0, 15.0, 6.0], np.float32),
                 (batch, T, 1))
    return x, ts


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_eval(paths, start, end, w: Widths, *, fast: bool, batch: int,
               max_batches, log_dir: str, data_parallel: int = 1,
               name: str = "smoke") -> dict:
    """``cli/evaluation_vit.main``; returns the metric summary."""
    from vit_grid_model_tpu.cli import evaluation_vit

    argv = (_data_args(paths) + w.cli_args() + [
        "--test_start", start.isoformat(), "--test_end", end.isoformat(),
        "--batch_size", str(batch), "--log_dir", log_dir,
        "--model_name", name, "--data_parallel", str(data_parallel)]
        + (["--max_batches", str(max_batches)] if max_batches else [])
        + (["--fast"] if fast else ["--precision", "highest"]))
    summary = evaluation_vit.main(argv)
    for key in ("model", "persist"):
        check(np.isfinite(summary[key]["RMSE"]),
              f"non-finite {key} RMSE {summary[key]['RMSE']}")
    return summary


def phase_serving(params, w: Widths, *, requests: int = 5, seed: int = 3):
    """``Forecaster`` at B=1, fast mode; returns (outputs, latencies_s)."""
    from vit_grid_model_tpu.evaluation.serving import Forecaster

    cfg = w.model_config()
    t0 = time.perf_counter()
    f = Forecaster(params, cfg, batch_size=1, fast=True)
    setup = time.perf_counter() - t0
    outs, lat = [], []
    for i in range(requests):
        x, ts = _inputs(w, 1, seed + i)
        t0 = time.perf_counter()
        y = f.predict(x, ts)
        lat.append(time.perf_counter() - t0)
        check(y.shape == (1, w.output_dim, 82, 67), f"shape {y.shape}")
        check(bool(np.isfinite(y).all()), "non-finite forecast")
        outs.append(y)
    return outs, lat, setup


def phase_train(paths, start, end, w: Widths, ckpt_dir: str, *,
                steps: int = 3, batch: int = 4, fast: bool = True,
                data_parallel: int = 1, resume: bool = True):
    """``cli/train_vit.main``: ``steps`` steps, save, then (``resume``)
    resume from the saved state for one more.  Returns the metrics of the
    last step of each run and the final state."""
    from vit_grid_model_tpu.cli import train_vit

    name = f"smoke_dp{data_parallel}"
    common = (_data_args(paths) + w.cli_args() + [
        "--train_start", start.isoformat(), "--train_end", end.isoformat(),
        "--batch_size", str(batch), "--checkpoint_dir", ckpt_dir,
        "--model_name", name, "--log_every", "1", "--warmup_steps", "1",
        "--data_parallel", str(data_parallel)]
        + (["--fast"] if fast else []))
    state, m1 = train_vit.main(common + ["--steps", str(steps),
                                         "--checkpoint_every", str(steps)])
    check(int(state.step) == steps, f"step {int(state.step)} != {steps}")
    check(bool(np.isfinite(m1["loss"])), f"non-finite loss {m1['loss']}")
    state_path = os.path.join(ckpt_dir, f"{name}_state.npz")
    check(os.path.exists(state_path), f"no train state at {state_path}")
    check(os.path.exists(os.path.join(ckpt_dir, f"{name}.npz")),
          "no params checkpoint")
    if not resume:
        return m1, None, state
    state, m2 = train_vit.main(common + ["--steps", str(steps + 1),
                                         "--resume", state_path])
    check(int(state.step) == steps + 1,
          f"resumed to step {int(state.step)} != {steps + 1}")
    check(bool(np.isfinite(m2["loss"])), f"non-finite loss {m2['loss']}")
    return m1, m2, state


def phase_generate(paths, start, end, w: Widths, out_dir: str, *,
                   batch: int = 2, data_parallel: int = 1,
                   compute_dtype: str = "bfloat16",
                   precision: str = "default") -> np.ndarray:
    """``cli/generate_reanalysis.main``; returns the written fields in file
    order, (n_fields, 82, 67)."""
    from vit_grid_model_tpu.cli import generate_reanalysis

    argv = (_data_args(paths) + w.cli_args() + [
        "--start", start.isoformat(), "--end", end.isoformat(),
        "--out_dir", out_dir, "--batch_size", str(batch),
        "--data_parallel", str(data_parallel),
        "--compute_dtype", compute_dtype, "--precision", precision])
    n = generate_reanalysis.main(argv)
    files = sorted(glob.glob(os.path.join(out_dir, "*.npy")))
    check(n == len(files) and n > 0, f"{n} fields reported, "
          f"{len(files)} files written")
    fields = np.stack([np.load(f) for f in files])
    check(fields.shape[1:] == (82, 67), f"field shape {fields.shape}")
    check(bool(np.isfinite(fields).all()), "non-finite generated field")
    return fields


def _forward(cfg, precision: str):
    import jax

    from vit_grid_model_tpu.models.metnet3 import metnet3_apply

    def fwd(p, x, ts):
        with jax.default_matmul_precision(precision):
            return metnet3_apply(p, x, ts, cfg)

    return jax.jit(fwd)


def phase_numerics(params, w: Widths, *, device, ref_device, seed: int = 1):
    """The three numeric comparisons; returns their numbers."""
    import jax

    from vit_grid_model_tpu.data.assembly import model_input_to_nhwc

    cfg = w.model_config()
    out = {}
    # f32 "highest" on the card vs the CPU backend, same params and input
    x1, ts1 = _inputs(w, 1, seed)
    f32 = _forward(cfg, "highest")
    y_dev = np.asarray(f32(*jax.device_put((params, x1, ts1), device)))
    y_ref = np.asarray(f32(*jax.device_put((params, x1, ts1), ref_device)))
    out["f32_vs_cpu_rel_l2"] = rel_l2(y_dev, y_ref)
    check(out["f32_vs_cpu_rel_l2"] <= BOUND_F32_VS_CPU,
          f"f32 device vs CPU rel L2 {out['f32_vs_cpu_rel_l2']:.3e} > "
          f"{BOUND_F32_VS_CPU}")

    # the --fast path (bf16, fused stem, NHWC staging) vs f32 on the card
    x2, ts2 = _inputs(w, 2, seed + 1)
    p_dev = jax.device_put(params, device)
    y_f32 = np.asarray(f32(p_dev, *jax.device_put((x2, ts2), device)))
    cfg_fast = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                   fuse_lead_stem=True, nhwc_input=True)
    import jax.numpy as jnp

    x2n = model_input_to_nhwc(x2, cfg.pad_multiple, jnp.bfloat16).copy()
    y_fast = np.asarray(_forward(cfg_fast, "default")(
        p_dev, *jax.device_put((x2n, ts2), device)))
    out["fast_vs_f32_rel_l2"] = rel_l2(y_fast, y_f32)
    out["fast_vs_f32_rmse_ugm3"] = float(np.sqrt(np.mean(
        (y_fast.astype(np.float64) - y_f32) ** 2)))
    check(out["fast_vs_f32_rel_l2"] <= BOUND_FAST_VS_F32,
          f"fast vs f32 rel L2 {out['fast_vs_f32_rel_l2']:.3e} > "
          f"{BOUND_FAST_VS_F32}")

    # f32 at "default" precision (TF32 on Hopper) vs "highest"
    y_def = np.asarray(_forward(cfg, "default")(
        p_dev, *jax.device_put((x2, ts2), device)))
    out["default_vs_highest_rel_l2"] = rel_l2(y_def, y_f32)
    check(out["default_vs_highest_rel_l2"] <= BOUND_TF32_VS_F32,
          f"default vs highest rel L2 {out['default_vs_highest_rel_l2']:.3e}"
          f" > {BOUND_TF32_VS_F32}")
    return out


def phase_int8(params, w: Widths, *, batch: int = 2, seed: int = 5):
    """Calibrate, quantize and run the int8-conv forward; returns its RMSE
    against the bf16 path on the calibration input (ug/m3)."""
    import jax

    from vit_grid_model_tpu.ops.quantize import quantize_metnet3_int8

    cfg = w.model_config(compute_dtype="bfloat16", fuse_lead_stem=True)
    x, ts = _inputs(w, batch, seed)
    xd, tsd = jax.device_put((x, ts))
    qparams = quantize_metnet3_int8(params, cfg, [(xd, tsd)])
    y_bf16 = np.asarray(_forward(cfg, "default")(qparams, xd, tsd))
    y_int8 = np.asarray(_forward(
        dataclasses.replace(cfg, int8_convs=True), "default")(
            qparams, xd, tsd), np.float64)
    check(bool(np.isfinite(y_int8).all()), "non-finite int8 forward")
    return float(np.sqrt(np.mean((y_int8 - y_bf16) ** 2)))


def _summary_rel_diff(a: dict, b: dict) -> float:
    """Largest relative difference over every metric of two summaries."""
    worst = 0.0
    for name in ("model", "persist", "sim_21h", "sim_avg"):
        for metric, va in a[name].items():
            va, vb = float(va), float(b[name][metric])
            if np.isnan(va) and np.isnan(vb):
                continue
            worst = max(worst, abs(va - vb) / max(abs(vb), 1e-12))
    return worst


def phase_four_gpus(root: str, w: Widths, n_devices: int = 4):
    """Data-parallel eval, train step and generation on ``n_devices``
    against one device, all in f32 "highest"; returns their numbers."""
    import jax

    out = {}
    # eval: one batch that divides over the mesh plus a ragged tail
    batch = 2 * n_devices
    paths, start, end = make_tree(os.path.join(root, "tree_dp"), w,
                                  batch + n_devices // 2)
    logs = os.path.join(root, "logs")
    s1 = phase_eval(paths, start, end, w, fast=False, batch=batch,
                    max_batches=None, log_dir=logs, name="dp1")
    sn = phase_eval(paths, start, end, w, fast=False, batch=batch,
                    max_batches=None, log_dir=logs,
                    data_parallel=n_devices, name=f"dp{n_devices}")
    out["eval_summary_rel_diff"] = _summary_rel_diff(sn, s1)
    check(out["eval_summary_rel_diff"] <= BOUND_DATA_PARALLEL,
          f"dp eval summary differs by {out['eval_summary_rel_diff']:.3e}")

    # one data-parallel train step (f32, highest) vs one card
    with jax.default_matmul_precision("highest"):
        m1, _, st1 = phase_train(paths, start, end, w,
                                 os.path.join(root, "ck1"), steps=1,
                                 batch=n_devices, fast=False, resume=False)
        mn, _, stn = phase_train(paths, start, end, w,
                                 os.path.join(root, "ckn"), steps=1,
                                 batch=n_devices, fast=False, resume=False,
                                 data_parallel=n_devices)
    out["train_loss_rel_diff"] = (abs(mn["loss"] - m1["loss"])
                                  / abs(m1["loss"]))
    check(out["train_loss_rel_diff"] <= BOUND_DATA_PARALLEL,
          f"dp train loss differs by {out['train_loss_rel_diff']:.3e}")
    worst = 0.0
    for a, b in zip(jax.tree.leaves(st1.params), jax.tree.leaves(stn.params)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        worst = max(worst, float(np.abs(b - a).max()
                                 / (np.abs(a).max() + 1e-12)))
    out["train_params_rel_diff"] = worst
    check(worst <= BOUND_DP_PARAMS,
          f"dp train params differ by {worst:.3e}")

    # generation over the mesh vs one card
    g1 = phase_generate(paths, start, end, w, os.path.join(root, "gen1"),
                        batch=n_devices, compute_dtype="float32",
                        precision="highest")
    gn = phase_generate(paths, start, end, w, os.path.join(root, "genn"),
                        batch=n_devices, data_parallel=n_devices,
                        compute_dtype="float32", precision="highest")
    out["generate_rel_l2"] = rel_l2(gn, g1)
    check(out["generate_rel_l2"] <= BOUND_DATA_PARALLEL,
          f"dp generation differs by {out['generate_rel_l2']:.3e}")
    out["generated_fields"] = int(gn.shape[0])
    return out


# ---------------------------------------------------------------------------
# running the phases
# ---------------------------------------------------------------------------

class CompileLog:
    """Backend compile durations reported by JAX, per program."""

    def __init__(self):
        self.events = []

    def __call__(self, event: str, duration: float, **kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.events.append((kw.get("fun_name", "?"), duration))

    def since(self, mark: int) -> str:
        total = collections.Counter()
        for name, d in self.events[mark:]:
            total[name] += d
        big = [f"{n}={d:.1f}s" for n, d in total.most_common() if d >= 0.5]
        return ", ".join(big) or "none >= 0.5s"


def _run(compiles: CompileLog, fn):
    """(fn(), seconds, the compiles it caused)."""
    mark = len(compiles.events)
    t0 = time.perf_counter()
    result = fn()
    dt = time.perf_counter() - t0
    return result, dt, compiles.since(mark)


def run_one_gpu(root: str, w: Widths, compiles: CompileLog,
                log=print) -> None:
    import jax

    from vit_grid_model_tpu.models.metnet3 import metnet3_init

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    params = metnet3_init(jax.random.PRNGKey(0), w.model_config())
    paths, start, end = make_tree(os.path.join(root, "tree"), w, 52)
    logs = os.path.join(root, "logs")

    for fast in (True, False):
        label = "eval --fast" if fast else "eval --precision highest"
        s, dt, c = _run(compiles, lambda: phase_eval(
            paths, start, end, w, fast=fast, batch=25, max_batches=2,
            log_dir=logs, name="fast" if fast else "f32"))
        log(f"phase {label}: ok  B=25 x 2 batches  model RMSE "
            f"{s['model']['RMSE']!r}  persist RMSE {s['persist']['RMSE']!r}"
            f"  ({dt:.1f}s; compiles: {c})")

    num, dt, c = _run(compiles, lambda: phase_numerics(
        params, w, device=gpu, ref_device=cpu))
    log(f"phase numerics: ok  f32 highest card vs CPU (B=1) rel L2 "
        f"{num['f32_vs_cpu_rel_l2']!r} <= {BOUND_F32_VS_CPU}; fast bf16 vs "
        f"f32 (B=2) rel L2 {num['fast_vs_f32_rel_l2']!r} <= "
        f"{BOUND_FAST_VS_F32}, RMSE {num['fast_vs_f32_rmse_ugm3']!r} ug/m3;"
        f" f32 default (TF32) vs highest (B=2) rel L2 "
        f"{num['default_vs_highest_rel_l2']!r} <= {BOUND_TF32_VS_F32}  "
        f"({dt:.1f}s; compiles: {c})")

    (outs, lat, setup), dt, c = _run(compiles,
                                     lambda: phase_serving(params, w))
    log(f"phase serving: ok  {len(outs)} requests at B=1, latency ms "
        f"{[round(t * 1e3, 3) for t in lat]}, set-up {setup:.1f}s  "
        f"({dt:.1f}s; compiles: {c})")

    (m1, m2, _), dt, c = _run(compiles, lambda: phase_train(
        paths, start, end, w, os.path.join(root, "ckpt")))
    log(f"phase train --fast: ok  3 steps at B=4 loss {m1['loss']!r}; "
        f"resumed step 4 loss {m2['loss']!r}  ({dt:.1f}s; compiles: {c})")

    gen_end = start + timedelta(hours=3)
    fields, dt, c = _run(compiles, lambda: phase_generate(
        paths, start, gen_end, w, os.path.join(root, "gen")))
    log(f"phase generate: ok  {fields.shape[0]} fields over 4 windows, "
        f"mean {float(fields.mean())!r}  ({dt:.1f}s; compiles: {c})")

    rmse, dt, c = _run(compiles, lambda: phase_int8(params, w))
    log(f"phase int8: ok  int8-conv forward vs bf16 RMSE {rmse!r} ug/m3  "
        f"({dt:.1f}s; compiles: {c})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the data-parallel paths, on 4 cards "
                         "against 1")
    args = ap.parse_args(argv)

    from vit_grid_model_tpu.core.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    from jax import monitoring

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    need = 4 if args.four_gpus else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    from vit_grid_model_tpu.data import native
    from vit_grid_model_tpu.utils.peaks import card_name_and_power_limit

    print(f"device_kind: {devices[0].device_kind}  count: {len(devices)}  "
          f"native loader: {native.available()}", flush=True)
    compiles = CompileLog()
    monitoring.register_event_duration_secs_listener(compiles)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        if args.four_gpus:
            res, dt, c = _run(compiles,
                              lambda: phase_four_gpus(root, SHIPPED))
            print(f"phase four-gpus: ok  {json.dumps(res)}  "
                  f"({dt:.1f}s; compiles: {c})", flush=True)
        else:
            run_one_gpu(root, SHIPPED, compiles,
                        log=lambda s: print(s, flush=True))
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(card_name_and_power_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
