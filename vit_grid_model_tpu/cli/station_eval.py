"""CLI: station-wise evaluation of the grid model.

Completes the reference's ``Air_Simulation_Reanalysis_Dataset_by_stn``
workflow (``dataset.py:1833-2219`` — the dataset ships with no consumer):
run the MetNet3 forward over the test window, sample the predicted PM2.5
fields at the stations' grid coordinates, score against the ground
observations with their validity flags, and append a reference-style metric
block to ``logs/test_{model_name}_by_stn.log``.

Flag surface mirrors the grid-eval CLI (``evaluation_vit.py:694-721``);
the data flags are identical so a grid-eval invocation converts to a
station eval by swapping the module name.
"""

from __future__ import annotations

import os


def build_parser():
    from vit_grid_model_tpu.cli import evaluation_vit as ev

    p = ev.build_parser()
    p.description = "station-wise evaluation (by_stn workflow)"
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.collect_valid_times:
        raise SystemExit("--collect_valid_times is a grid-eval quirk "
                         "(evaluation_vit.py:285-289); the station eval has "
                         "no valid-times bookkeeping")

    from vit_grid_model_tpu.cli.evaluation_vit import (build_configs,
                                                       force_cpu_backend,
                                                       load_model_params)

    force_cpu_backend(args)
    from vit_grid_model_tpu.core.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    import jax
    import numpy as np

    from vit_grid_model_tpu.evaluation.station_eval import (
        evaluate_by_station, write_station_log)

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

    metrics = evaluate_by_station(
        params, model_cfg, data_cfg, test_start=test_start,
        test_end=test_end, batch_size=args.batch_size,
        num_workers=args.num_workers, matmul_precision=args.precision,
        max_batches=args.max_batches, mesh=mesh)

    name = (args.model_name or "model") + "_by_stn"
    os.makedirs(args.log_dir, exist_ok=True)
    with open(os.path.join(args.log_dir, f"test_{name}.log"), "a") as f:
        write_station_log(f, metrics, str(args))
    s = metrics.summary()
    print("station RMSE: {:.4f}  MAE: {:.4f}  R: {:.4f}  n_obs: {}".format(
        s["RMSE"], s["MAE"], s["R"], s["n_obs"]))


if __name__ == "__main__":
    main()
