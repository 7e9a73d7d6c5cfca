"""CLI: batched, data-parallel PM2.5 re-analysis generation."""

from __future__ import annotations

import argparse
from datetime import datetime


def main(argv=None) -> int:
    """Generate the fields; returns how many were written."""
    p = argparse.ArgumentParser(description="generate re-analysis fields")
    p.add_argument("--checkpoint", type=str, required=False, default=None)
    p.add_argument("--start", type=str, default="2023-01-01T00")
    p.add_argument("--end", type=str, default="2023-01-02T23")
    p.add_argument("--out_dir", type=str, default="reanalysis_out")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--sim_data_path", type=str, required=True)
    p.add_argument("--analysis_data_path", type=str, required=True)
    p.add_argument("--input_dim", type=int, default=13)
    p.add_argument("--output_dim", type=int, default=12)
    p.add_argument("--prev_len", type=int, default=13)
    p.add_argument("--feat_dim", type=int, default=12)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--data_parallel", type=int, default=-1,
                   help="-1: all devices")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--precision", type=str, default="default",
                   choices=["default", "high", "highest"],
                   help="matmul precision (highest = f32 parity)")
    args = p.parse_args(argv)
    from vit_grid_model_tpu.core.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    import jax

    from vit_grid_model_tpu.core.config import (DataConfig, GridConfig,
                                                MetNet3Config)
    from vit_grid_model_tpu.evaluation import driver as eval_driver
    from vit_grid_model_tpu.evaluation.generate import generate_reanalysis
    from vit_grid_model_tpu.parallel import mesh as meshlib

    data_cfg = DataConfig(
        input_dim=args.input_dim, output_dim=args.output_dim,
        prev_len=args.prev_len, feat_dim=args.feat_dim, grid=GridConfig(),
        data_path=args.data_path, sim_data_path=args.sim_data_path,
        analysis_data_path=args.analysis_data_path)
    feat_infos = eval_driver.load_feat_infos(args.data_path)
    model_cfg = MetNet3Config(
        window_size=data_cfg.total_steps, n_variables=24,
        n_start_channels=args.hidden_dim, end_lead_time=args.output_dim,
        input_height=data_cfg.grid.height, input_width=data_cfg.grid.width,
        pm25_mean=feat_infos["PM2.5"][0], pm25_std=feat_infos["PM2.5"][1],
        compute_dtype=args.compute_dtype, fuse_lead_stem=True,
        # bf16 generation stages host-prepared in the device layout —
        # bit-exact vs bf16 staging (tests/test_nhwc_input.py)
        nhwc_input=args.compute_dtype == "bfloat16")
    mesh = meshlib.mesh_for_cli(args.data_parallel,
                                batch_size=args.batch_size)

    if args.checkpoint and args.checkpoint.endswith(".pkt"):
        from vit_grid_model_tpu.core.torch_import import convert_checkpoint

        params = convert_checkpoint(args.checkpoint, model_cfg)
    elif args.checkpoint:
        from vit_grid_model_tpu.core.checkpoint import restore_params
        from vit_grid_model_tpu.models.metnet3 import metnet3_init

        params = restore_params(args.checkpoint, metnet3_init(
            jax.random.PRNGKey(0), model_cfg))
    else:
        from vit_grid_model_tpu.models.metnet3 import metnet3_init

        print("no checkpoint: random init (smoke mode)")
        params = metnet3_init(jax.random.PRNGKey(0), model_cfg)

    n = generate_reanalysis(
        params, model_cfg, data_cfg,
        start=datetime.fromisoformat(args.start),
        end=datetime.fromisoformat(args.end), out_dir=args.out_dir,
        batch_size=args.batch_size, mesh=mesh,
        matmul_precision=args.precision)
    print(f"wrote {n} fields to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
