"""CLI: signature-compatible evaluation entry point.

Accepts every flag of the reference CLI (``evaluation_vit.py:694-721``) with
the same defaults, so ``vit_stn_exp.sh`` runs unmodified; the flags this
framework adds are additive.  ``--gpus`` is accepted for compatibility and
maps onto JAX device selection (``cpu`` forces the CPU backend).
"""

from __future__ import annotations

import argparse
import os
import sys
from datetime import datetime


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="evaluation MultiAir")
    # --- reference-compatible surface (defaults identical) ---
    p.add_argument("--seed", type=int, default=0, help="random seed")
    p.add_argument("--batch_size", type=int, default=24,
                   help="number of batch size")
    p.add_argument("--data_path", type=str,
                   default="../preprocessed_data_from_2016",
                   help="path of data")
    p.add_argument("--sim_data_path", type=str,
                   default="../../short_term/nier_preprocessed/CMAQ",
                   help="path of simulation data")
    p.add_argument("--analysis_data_path", type=str,
                   default="../analysis/CMAQ", help="path of analysis data")
    p.add_argument("--model_name", type=str, default="",
                   help="name of model to evaluate")
    p.add_argument("--gpus", type=str, default="0",
                   help="device id for execution (compat; 'cpu' forces CPU)")
    p.add_argument("--hidden_dim", type=int, default=128,
                   help="hidden dimension for LSTM")
    p.add_argument("--output_dim", type=int, default=6,
                   help="number of predictions")
    p.add_argument("--input_dim", type=int, default=7,
                   help="input window size")
    p.add_argument("--prev_len", type=int, default=7,
                   help="previous length for statistics of data")
    p.add_argument("--feat_dim", type=int, default=12,
                   help="feature dimension")
    # --- additions ---
    p.add_argument("--checkpoint", type=str, default=None,
                   help="torch .pkt or orbax dir; default "
                        "check_points/{model_name}.pkt like the reference")
    p.add_argument("--test_start", type=str, default="2023-01-01T00")
    p.add_argument("--test_end", type=str, default="2023-03-31T23")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic data tree (no external data)")
    p.add_argument("--synthetic_root", type=str, default="/tmp/vit_synth")
    p.add_argument("--precision", type=str, default="highest",
                   choices=["default", "high", "highest"],
                   help="matmul precision (highest = f32 parity)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--fast", action="store_true",
                   help="throughput mode: bf16 + fused stem + "
                        "host-prepared NHWC input staging (not for "
                        "checkpoint-parity scoring)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="devices on the mesh 'data' axis for data-parallel "
                        "evaluation (-1: all devices); the counterpart "
                        "of the reference's nn.DataParallel eval — results "
                        "are bit-identical to single-device")
    p.add_argument("--collect_valid_times", action="store_true",
                   help="reproduce reference quirk #19: collect encoded "
                        "sample times with last input hour == 6")
    p.add_argument("--parity_report", type=str, default=None, metavar="BASE",
                   help="after evaluating, diff the summary against a "
                        "baseline table and pass/fail the <=1e-3 model-RMSE "
                        "gate (BASELINE.json contract). BASE is a baseline "
                        "JSON path, or the literal 'reference' for the "
                        "shipped 12hr golden-log table — run with the real "
                        ".pkt + data to prove checkpoint parity in one "
                        "command. Exits 1 on gate failure.")
    p.add_argument("--parity_save", type=str, default=None, metavar="PATH",
                   help="write this run's summary as a parity-baseline JSON "
                        "(how a synthetic golden is generated)")
    return p


def force_cpu_backend(args) -> None:
    """``--gpus cpu`` compat: force + verify the CPU backend (env vars are
    pre-empted when a platform plugin registered itself at startup)."""
    if args.gpus != "cpu":
        return
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if any(d.platform != "cpu" for d in jax.devices()):
        raise RuntimeError("--gpus cpu requested but the CPU backend "
                           "could not be selected")


def build_configs(args):
    """Shared post-parse setup for the eval CLIs: synthetic-tree generation,
    DataConfig, --fast dtype/precision coupling, and the MetNet3Config.
    Mutates ``args`` (paths, compute_dtype, precision) like main() always
    did.  Returns (data_cfg, model_cfg, test_start, test_end)."""
    from vit_grid_model_tpu.core.config import (DataConfig, GridConfig,
                                                MetNet3Config)
    from vit_grid_model_tpu.evaluation import driver

    test_start = datetime.fromisoformat(args.test_start)
    test_end = datetime.fromisoformat(args.test_end)

    if args.synthetic:
        from vit_grid_model_tpu.data import synthetic

        paths = synthetic.generate_tree(
            args.synthetic_root, test_start, test_end,
            prev_len=args.prev_len, output_dim=args.output_dim)
        args.data_path = paths["data_path"]
        args.sim_data_path = paths["sim_data_path"]
        args.analysis_data_path = paths["analysis_data_path"]

    data_cfg = DataConfig(
        input_dim=args.input_dim, output_dim=args.output_dim,
        prev_len=args.prev_len, feat_dim=args.feat_dim, grid=GridConfig(),
        data_path=args.data_path, sim_data_path=args.sim_data_path,
        analysis_data_path=args.analysis_data_path)

    feat_infos = driver.load_feat_infos(args.data_path)
    if args.fast:
        args.compute_dtype = "bfloat16"
        args.precision = "default"
    model_cfg = MetNet3Config(
        window_size=args.input_dim + args.output_dim, n_variables=24,
        n_start_channels=args.hidden_dim, end_lead_time=args.output_dim,
        input_height=data_cfg.grid.height, input_width=data_cfg.grid.width,
        pm25_mean=feat_infos["PM2.5"][0], pm25_std=feat_infos["PM2.5"][1],
        compute_dtype=args.compute_dtype, fuse_lead_stem=args.fast,
        # fast mode stages the input host-prepared in the device layout:
        # the assembler's stack is already channels-last, so this skips
        # the (B,T,C,H,W)->NHWC relayout on the device with BIT-EXACT
        # results vs the bf16-staged standard path (tests/test_nhwc_input.py)
        nhwc_input=args.fast)
    return data_cfg, model_cfg, test_start, test_end


def load_model_params(args, model_cfg):
    """Resolve the checkpoint the reference way (``evaluation_vit.py:109``:
    ``check_points/{model_name}.pkt``): torch ``.pkt`` -> converter, orbax
    dir / ``.npz`` -> restore, otherwise random init for synthetic smoke
    runs.  Shared by the grid-eval and station-eval CLIs."""
    import jax

    ckpt = args.checkpoint or f"check_points/{args.model_name}.pkt"
    if os.path.exists(ckpt) and ckpt.endswith(".pkt"):
        from vit_grid_model_tpu.core.torch_import import convert_checkpoint

        params = convert_checkpoint(ckpt, model_cfg)
        print(f"loaded torch checkpoint: {ckpt}")
    elif os.path.isdir(ckpt) or ckpt.endswith(".npz"):
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"checkpoint not found: {ckpt}")
        from vit_grid_model_tpu.core.checkpoint import restore_params
        from vit_grid_model_tpu.models.metnet3 import metnet3_init

        params = restore_params(ckpt, metnet3_init(
            jax.random.PRNGKey(args.seed), model_cfg))
        print(f"loaded checkpoint: {ckpt}")
    else:
        from vit_grid_model_tpu.models.metnet3 import metnet3_init

        if args.checkpoint is not None:
            raise FileNotFoundError(f"checkpoint not found: {ckpt}")
        print(f"checkpoint {ckpt} not found; using random init "
              "(synthetic smoke mode)")
        params = metnet3_init(jax.random.PRNGKey(args.seed), model_cfg)
    return params


def main(argv=None) -> dict:
    """Run the evaluation; returns the metric summary (also logged)."""
    args = build_parser().parse_args(argv)
    force_cpu_backend(args)
    from vit_grid_model_tpu.core.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    import jax
    import numpy as np

    from vit_grid_model_tpu.evaluation import driver

    np.random.seed(args.seed)
    data_cfg, model_cfg, test_start, test_end = build_configs(args)
    params = load_model_params(args, model_cfg)

    mesh = None
    if args.data_parallel != 1:
        from vit_grid_model_tpu.parallel import mesh as meshlib

        mesh = meshlib.mesh_for_cli(args.data_parallel,
                                    batch_size=args.batch_size)

    print(f"devices: {jax.devices()}")
    print(args)
    metrics = driver.evaluate(
        params, model_cfg, data_cfg, model_name=args.model_name or "model",
        test_start=test_start, test_end=test_end,
        batch_size=args.batch_size, num_workers=args.num_workers,
        log_dir=args.log_dir, args_repr=str(args),
        matmul_precision=args.precision, max_batches=args.max_batches,
        mesh=mesh, collect_valid_times=args.collect_valid_times)
    summary = metrics.summary()
    print("model RMSE: {:.4f}  MAE: {:.4f}  R: {:.4f}".format(
        summary["model"]["RMSE"], summary["model"]["MAE"],
        summary["model"]["R"]))
    if args.parity_save:
        from vit_grid_model_tpu.evaluation import parity

        print(f"parity baseline saved: "
              f"{parity.save_baseline(args.parity_save, summary)}")
    if args.parity_report:
        from vit_grid_model_tpu.evaluation import parity

        lines, ok = parity.parity_report(
            summary, parity.load_baseline(args.parity_report))
        print("\n".join(lines))
        if not ok:
            sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
