"""Station-level evaluation: grid predictions scored at station locations.

The reference ships the ``Air_Simulation_Reanalysis_Dataset_by_stn`` dataset
(``dataset.py:1833-2219``) — per-station targets/masks/classes for
station-wise scoring — but no driver that consumes it.  This completes the
workflow: run the grid model, sample the predicted fields at the stations'
grid coordinates (``coords.txt``, ``evaluation_vit.py:82-87``), and score
against the ground observations with validity masks.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

from vit_grid_model_tpu.core.config import DataConfig, MetNet3Config
from vit_grid_model_tpu.data.assembly import (sim_stack_to_model_input,
                                              sim_stack_to_nhwc_input)
from vit_grid_model_tpu.data.datasets import AirSimulationReanalysisDatasetByStn
from vit_grid_model_tpu.data.pipeline import BatchLoader
from vit_grid_model_tpu.data.timeutil import eval_time_list
from vit_grid_model_tpu.evaluation import driver as eval_driver
from vit_grid_model_tpu.evaluation.metrics import (N_CLASSES, PearsonMoments,
                                                   assign_class_eval)
from vit_grid_model_tpu.models.metnet3 import metnet3_apply


@dataclasses.dataclass
class StationMetrics:
    """Masked station-level accumulator (valid = observation present)."""

    def __post_init__(self):
        self.confusion = np.zeros((N_CLASSES, N_CLASSES))
        self.sq = 0.0
        self.ab = 0.0
        self.moments = PearsonMoments()

    def update(self, preds, truth, invalid_flag):
        """``invalid_flag`` is the by_stn dataset's UNINVERTED column-6 flag
        (True = observation invalid, ``dataset.py:1889``).  Truth classes
        are computed here from the values — the dataset's ``stn_cls`` feeds
        that flag straight into ``assign_class_masked`` and is therefore -1
        at exactly the VALID stations (another faithful reference quirk)."""
        m = (~invalid_flag.astype(bool)) & np.isfinite(truth)
        p, t = preds[m].astype(np.float64), truth[m].astype(np.float64)
        pc = assign_class_eval(preds)[m]
        tc = assign_class_eval(np.nan_to_num(truth))[m]
        valid = tc >= 0
        idx = pc[valid] * N_CLASSES + tc[valid]
        self.confusion += np.bincount(
            idx, minlength=N_CLASSES * N_CLASSES
        ).reshape(N_CLASSES, N_CLASSES)
        d = p - t
        self.sq += np.square(d).sum()
        self.ab += np.abs(d).sum()
        self.moments.update(p, t)

    def summary(self) -> Dict[str, float]:
        c = self.confusion
        acc = float(np.trace(c) / c.sum())
        pod = float(c[2:, 2:].sum() / max(c[:, 2:].sum(), 1e-9))
        far = float(c[2:, :2].sum() / max(c[2:, :].sum(), 1e-9))
        n = self.moments.n
        return {
            "ACC": acc, "POD": pod, "FAR": far,
            "F1": 2 * pod * (1 - far) / max(pod + (1 - far), 1e-9),
            "RMSE": float(np.sqrt(self.sq / n)),
            "MAE": float(self.ab / n),
            "R": self.moments.r(guard=1e-18),
            "n_obs": int(n),
        }


def write_station_log(f, metrics: "StationMetrics",
                      args_repr: str = "") -> None:
    """Reference-style scalar metric block (the ``'{:.4f}'`` line format of
    ``evaluation_vit.py:635-692``) for the station-wise scores, so the
    by_stn workflow logs diff like the grid eval does."""
    if args_repr:
        f.write(args_repr)
        f.write("\n")
    s = metrics.summary()
    f.write(f"station model total ACC: {s['ACC']:.4f}\n")
    f.write(f"station model total POD: {s['POD']:.4f}\n")
    f.write(f"station model total FAR: {s['FAR']:.4f}\n")
    f.write(f"station model total F1 score: {s['F1']:.4f}\n")
    f.write(f"station model MAE: {s['MAE']:.4f}\n")
    f.write(f"station model RMSE: {s['RMSE']:.4f}\n")
    f.write(f"station model R: {s['R']:.4f}\n")
    f.write(f"station model n_obs: {s['n_obs']}\n")
    f.flush()


def evaluate_by_station(params, model_cfg: MetNet3Config,
                        data_cfg: DataConfig, *,
                        test_start: datetime, test_end: datetime,
                        batch_size: int = 8, num_workers: int = 4,
                        matmul_precision: str = "highest",
                        max_batches: Optional[int] = None,
                        mesh=None) -> StationMetrics:
    grid = data_cfg.grid
    feat_infos = eval_driver.load_feat_infos(data_cfg.data_path)
    stations = eval_driver.load_stations(data_cfg.data_path,
                                         (grid.height, grid.width))
    times = eval_time_list(test_start, test_end, data_cfg.prev_len,
                           data_cfg.output_dim)
    feats, masks = eval_driver.load_ground_obs(
        data_cfg.data_path, times, stations.total, data_cfg.feat_dim)
    dataset = AirSimulationReanalysisDatasetByStn(
        times, feats, masks, input_dim=data_cfg.input_dim,
        output_dim=data_cfg.output_dim, prev_len=data_cfg.prev_len,
        korea_stn_num=stations.korea_stn_num,
        china_stn_num=stations.china_stn_num,
        cmaq_size=(grid.height, grid.width),
        sim_data_path=data_cfg.sim_data_path,
        reanalysis_data_path=data_cfg.analysis_data_path,
        feat_infos=feat_infos)
    loader = BatchLoader(dataset, batch_size=batch_size,
                         num_workers=num_workers)

    rows = stations.sim_coords[:, 0]
    cols = stations.sim_coords[:, 1]

    def forward(p, x, ts):
        with jax.default_matmul_precision(matmul_precision):
            return metnet3_apply(p, x, ts, model_cfg)

    fwd = jax.jit(forward)
    n_data = 1
    batch_shd = None
    if mesh is not None:
        from vit_grid_model_tpu.parallel import mesh as meshlib

        n_data = mesh.shape["data"]
        batch_shd = meshlib.batch_sharding(mesh)
        params = jax.device_put(params, meshlib.replicated(mesh))
    metrics = StationMetrics()
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        (_, _, sim, _, _, _, raw_times, _, stn_vals, stn_mask,
         stn_cls) = batch
        B = sim.shape[0]
        out_dtype = (jnp.bfloat16 if model_cfg.compute_dtype == "bfloat16"
                     else np.float32)
        if model_cfg.nhwc_input:
            # host-prepared device layout (see evaluation/driver.py)
            x = sim_stack_to_nhwc_input(sim, data_cfg.total_steps,
                                        model_cfg.pad_multiple, out_dtype)
        else:
            x = sim_stack_to_model_input(sim, data_cfg.total_steps,
                                         out_dtype=out_dtype)
        # a ragged final batch runs unsharded at its true size (see
        # evaluation/driver.py)
        xj, tj = jnp.asarray(x), jnp.asarray(raw_times)
        if batch_shd is not None and B % n_data == 0:
            xj = jax.device_put(xj, batch_shd)
            tj = jax.device_put(tj, batch_shd)
        preds = np.asarray(fwd(params, xj, tj))
        preds = np.maximum(preds, 0.0)   # eval clamp (evaluation_vit.py:254)
        del stn_cls   # -1 at valid stations (see StationMetrics.update)
        stn_preds = preds[:, :, rows, cols]          # (B, L, korea)
        metrics.update(stn_preds, stn_vals, invalid_flag=stn_mask)
    return metrics
