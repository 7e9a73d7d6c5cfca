"""CLI: train MetNet3 on CMAQ->reanalysis data (or synthetic fixtures).

The reference ships no training entry point (SURVEY.md §3.5); this completes
the contract: ``Air_Simulation_Reanalysis_Dataset_v3``-style batches ->
MetNet3 forward -> Focal-R loss -> AdamW, jit-ed over a data-parallel mesh,
with orbax checkpoints that the evaluation CLI can load back.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train MetNet3")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--data_path", type=str,
                   default="../preprocessed_data_from_2016")
    p.add_argument("--sim_data_path", type=str,
                   default="../../short_term/nier_preprocessed/CMAQ")
    p.add_argument("--analysis_data_path", type=str, default="../analysis/CMAQ")
    p.add_argument("--model_name", type=str, default="vit_model")
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--output_dim", type=int, default=12)
    p.add_argument("--input_dim", type=int, default=13)
    p.add_argument("--prev_len", type=int, default=13)
    p.add_argument("--feat_dim", type=int, default=12)
    p.add_argument("--train_start", type=str, default="2022-01-01T00")
    p.add_argument("--train_end", type=str, default="2022-12-31T23")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--loss", type=str, default="focal_r",
                   choices=["focal_r", "mse", "mae", "huber"])
    p.add_argument("--focal_beta", type=float, default=0.2)
    p.add_argument("--focal_gamma", type=float, default=1.0)
    p.add_argument("--focal_focusing", type=str, default="canonical",
                   choices=["canonical", "sigmoid"],
                   help="Focal-R focusing factor: canonical "
                        "(2*sigmoid(beta|e|)-1)^gamma (authors' released "
                        "form, ->0 at e=0) or the legacy in-text sigmoid "
                        "form ([0.5,1); at most 2x down-weighting)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="float32")
    p.add_argument("--dropout", type=float, default=0.1,
                   help="attention/mbconv dropout rate (reference default)")
    p.add_argument("--fuse_lead_stem", action="store_true",
                   help="compute the lead-independent part of the stem conv "
                        "once per sample (exact up to float re-association)")
    p.add_argument("--fast", action="store_true",
                   help="throughput mode for training: bf16 + fused lead "
                        "stem + host-prepared NHWC input staging")
    p.add_argument("--shuffle_mode", choices=("samples", "batches", "buffer"),
                   default="samples",
                   help="'batches' shuffles CONSECUTIVE-index batches "
                        "instead of samples: keeps the union-assembly "
                        "fast path of the loader at the cost of coarse SGD "
                        "noise (window-neighbor samples co-occur).  "
                        "'buffer' keeps union assembly AND mixes batch "
                        "composition through a --shuffle_buffer-batch "
                        "reservoir (tf.data-style local shuffle)")
    p.add_argument("--shuffle_buffer", type=int, default=8,
                   help="reservoir size in batches for "
                        "--shuffle_mode buffer")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_root", type=str, default="/tmp/vit_synth_train")
    p.add_argument("--checkpoint_dir", type=str, default="check_points")
    p.add_argument("--checkpoint_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--resume", type=str, default=None,
                   help="a *_state.npz resumes the FULL train state "
                        "(optimizer moments, schedule step, PRNG, EMA) and "
                        "reseeds the shuffled data stream past consumed "
                        "batches; a params checkpoint restores weights only")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="exponential-moving-average decay for an EMA copy "
                        "of the params (0 disables); saved alongside as "
                        "{model_name}_ema.npz")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="devices on the mesh 'data' axis (-1: all); "
                        "batch_size must divide evenly")
    return p


def batches_from_dataset(dataset, data_cfg, batch_size, num_workers, seed,
                         shuffle_mode="samples", x_dtype=np.float32,
                         shuffle_buffer=8, nhwc=False, pad_multiple=14):
    """Adapt v3 dataset samples into train-step batches, looping epochs.

    ``x_dtype=bfloat16`` fuses the host-side compute-dtype cast into the
    (native) model-input repack — the step casts on device anyway, so
    half-size host buffers halve the dominant host->HBM transfer.
    ``nhwc``: stage host-prepared in the device layout instead
    (``MetNet3Config.nhwc_input``; bit-exact, tests/test_nhwc_input.py)."""
    from vit_grid_model_tpu.data.assembly import (sim_stack_to_model_input,
                                                  sim_stack_to_nhwc_input)
    from vit_grid_model_tpu.data.pipeline import BatchLoader

    shuffle = (shuffle_mode if shuffle_mode in ("batches", "buffer")
               else True)
    loader = BatchLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                         seed=seed, num_workers=num_workers,
                         shuffle_buffer=shuffle_buffer)
    while True:
        for (feats, masks, sim, curr, reanalysis, cls, raw_times,
             prev) in loader:
            x = (sim_stack_to_nhwc_input(sim, data_cfg.total_steps,
                                         pad_multiple, x_dtype)
                 if nhwc else
                 sim_stack_to_model_input(sim, data_cfg.total_steps,
                                          out_dtype=x_dtype))
            yield {
                "x": x,
                "timestamps": raw_times,
                "targets": reanalysis,
            }


def main(argv=None):
    """Train; returns ``(state, metrics)``: the final train state and the
    last step's metrics as floats (None when no step ran)."""
    args = build_parser().parse_args(argv)
    from vit_grid_model_tpu.core.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    import numpy as np
    import jax
    import jax.numpy as jnp

    from vit_grid_model_tpu.core.config import (DataConfig, GridConfig,
                                                MetNet3Config, TrainConfig)
    from vit_grid_model_tpu.core.checkpoint import save_params
    from vit_grid_model_tpu.data.datasets import AirSimulationReanalysisDatasetV3
    from vit_grid_model_tpu.data.timeutil import eval_time_list
    from vit_grid_model_tpu.evaluation import driver as eval_driver
    from vit_grid_model_tpu.models.metnet3 import metnet3_init
    from vit_grid_model_tpu.train.trainer import (build_train_step,
                                                  init_train_state,
                                                  train_loop)

    train_start = datetime.fromisoformat(args.train_start)
    train_end = datetime.fromisoformat(args.train_end)

    if args.synthetic:
        from vit_grid_model_tpu.data import synthetic

        paths = synthetic.generate_tree(
            args.synthetic_root, train_start, train_end,
            prev_len=args.prev_len, output_dim=args.output_dim)
        args.data_path = paths["data_path"]
        args.sim_data_path = paths["sim_data_path"]
        args.analysis_data_path = paths["analysis_data_path"]

    data_cfg = DataConfig(
        input_dim=args.input_dim, output_dim=args.output_dim,
        prev_len=args.prev_len, feat_dim=args.feat_dim, grid=GridConfig(),
        data_path=args.data_path, sim_data_path=args.sim_data_path,
        analysis_data_path=args.analysis_data_path)

    feat_infos = eval_driver.load_feat_infos(args.data_path)
    stations = eval_driver.load_stations(args.data_path)
    if args.fast:
        args.compute_dtype = "bfloat16"
        args.fuse_lead_stem = True
    model_cfg = MetNet3Config(
        window_size=data_cfg.total_steps, n_variables=24,
        n_start_channels=args.hidden_dim, end_lead_time=args.output_dim,
        input_height=data_cfg.grid.height, input_width=data_cfg.grid.width,
        pm25_mean=feat_infos["PM2.5"][0], pm25_std=feat_infos["PM2.5"][1],
        compute_dtype=args.compute_dtype, dropout=args.dropout,
        fuse_lead_stem=args.fuse_lead_stem,
        # fast mode stages host-prepared in the device layout — deletes the
        # on-chip input relayout, bit-exact (tests/test_nhwc_input.py)
        nhwc_input=args.fast)
    train_cfg = TrainConfig(
        learning_rate=args.lr, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, total_steps=args.steps,
        batch_size=args.batch_size, loss=args.loss,
        focal_beta=args.focal_beta, focal_gamma=args.focal_gamma,
        focal_focusing=args.focal_focusing,
        remat=args.remat, seed=args.seed, ema_decay=args.ema_decay)

    times = eval_time_list(train_start, train_end, args.prev_len,
                           args.output_dim)
    feats, masks = eval_driver.load_ground_obs(
        args.data_path, times, stations.total, args.feat_dim)
    dataset = AirSimulationReanalysisDatasetV3(
        times, feats, masks, input_dim=args.input_dim,
        output_dim=args.output_dim, prev_len=args.prev_len,
        korea_stn_num=stations.korea_stn_num,
        china_stn_num=stations.china_stn_num, cmaq_size=(82, 67),
        sim_data_path=args.sim_data_path,
        reanalysis_data_path=args.analysis_data_path, feat_infos=feat_infos)
    print(f"devices: {jax.devices()}; dataset: {len(dataset)} samples")

    params = metnet3_init(jax.random.PRNGKey(args.seed), model_cfg)
    if args.resume and args.resume.endswith("_state.npz"):
        from vit_grid_model_tpu.core.checkpoint import restore_train_state

        state = restore_train_state(args.resume,
                                    init_train_state(params, train_cfg))
        print(f"resumed full train state from {args.resume} "
              f"(step {int(state.step)})")
    elif args.resume:
        from vit_grid_model_tpu.core.checkpoint import restore_params

        params = restore_params(args.resume, params)
        state = init_train_state(params, train_cfg)
        print(f"resumed parameters only from {args.resume} "
              "(optimizer moments and schedule restart)")
    else:
        state = init_train_state(params, train_cfg)

    mesh = None
    if args.data_parallel != 1:
        from vit_grid_model_tpu.parallel import mesh as meshlib

        mesh = meshlib.mesh_for_cli(args.data_parallel,
                                    batch_size=args.batch_size)
        state = jax.device_put(state, meshlib.replicated(mesh))
    step_fn = build_train_step(model_cfg, train_cfg)

    ckpt_base = os.path.join(args.checkpoint_dir, args.model_name)
    os.makedirs(args.checkpoint_dir, exist_ok=True)

    # Resume must not re-feed batches the interrupted run already consumed:
    # fold the restored step into the shuffle seed so the resumed stream is
    # fresh data (exact index-level continuation would require assembling
    # and discarding `step` full batches — far costlier than the epoch-order
    # difference it would buy on an effectively-infinite shuffled stream).
    batches = batches_from_dataset(
        dataset, data_cfg, args.batch_size, args.num_workers,
        args.seed + int(state.step), shuffle_mode=args.shuffle_mode,
        shuffle_buffer=args.shuffle_buffer,
        # bf16 training casts the CMAQ stack on device anyway
        # (metnet3_apply); casting on host — fused into the native repack —
        # halves the host->device bytes of the dominant batch member
        x_dtype=(jnp.bfloat16 if args.compute_dtype == "bfloat16"
                 else np.float32),
        nhwc=model_cfg.nhwc_input, pad_multiple=model_cfg.pad_multiple)
    # overlap host->HBM transfer with the previous step's compute
    from vit_grid_model_tpu.data.pipeline import device_prefetch

    if mesh is not None:
        from vit_grid_model_tpu.parallel import mesh as meshlib

        batches = device_prefetch(
            batches, lambda b: meshlib.shard_batch(mesh, b))
    else:
        batches = device_prefetch(batches, jax.device_put)

    import itertools

    from vit_grid_model_tpu.core.checkpoint import save_train_state

    done = 0
    metrics = None
    remaining = args.steps - int(state.step)   # full-state resume continues
    while done < remaining:
        chunk = min(args.checkpoint_every, remaining - done)
        # islice bounds the iterator itself: train_loop's own max_steps
        # check would pull (assemble + transfer) one extra batch per chunk
        state, metrics = train_loop(
            state, itertools.islice(batches, chunk), step_fn,
            log_every=args.log_every)
        done += chunk
        path = save_params(f"{ckpt_base}.npz", state.params)
        save_train_state(f"{ckpt_base}_state.npz", state)
        if state.ema_params is not None:
            save_params(f"{ckpt_base}_ema.npz", state.ema_params)
        print(f"step {int(state.step)}: checkpoint -> {path} "
              f"(+ {ckpt_base}_state.npz)")
    print("training complete")
    if metrics is not None:
        metrics = {k: float(v) for k, v in metrics.items()}
    return state, metrics


if __name__ == "__main__":
    main()
