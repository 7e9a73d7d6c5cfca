"""Evaluation driver: the counterpart of the reference's
``evaluation(args)`` (``evaluation_vit.py:59-692``).

Same observable behavior — station/grid/stat metadata loading, the 2023-Q1
test window, the batch loop with persistence / CMAQ-21h / CMAQ-avg baselines,
and the byte-compatible metric log — but the model forward is one jit-ed XLA
program, batches stream through the threaded prefetch loader instead of
DataLoader worker processes, and data parallelism is a ``jax.sharding.Mesh``
instead of ``torch.nn.DataParallel``.
"""

from __future__ import annotations

import dataclasses
import time
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from vit_grid_model_tpu.core.config import DataConfig, MetNet3Config
from vit_grid_model_tpu.data.assembly import (sim_stack_to_model_input,
                                              sim_stack_to_nhwc_input)
from vit_grid_model_tpu.data.datasets import AirSimulationReanalysisDatasetOnly
from vit_grid_model_tpu.data.pipeline import BatchLoader
from vit_grid_model_tpu.data.readers import _read_netcdf_var
from vit_grid_model_tpu.data.timeutil import eval_time_list
from vit_grid_model_tpu.evaluation.metrics import EvaluationMetrics
from vit_grid_model_tpu.evaluation import logwriter
from vit_grid_model_tpu.models.metnet3 import metnet3_apply


# ---------------------------------------------------------------------------
# metadata loading (``evaluation_vit.py:35-102``)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StationInfo:
    lats: np.ndarray
    lons: np.ndarray
    korea_regions: List[str]
    korea_stn_num: int
    china_stn_num: int
    sim_coords: np.ndarray          # (korea, 2) grid indices
    cmaq_coords: np.ndarray         # (H, W, 2) lat/lon

    @property
    def total(self) -> int:
        return self.korea_stn_num + self.china_stn_num

    @property
    def region_names(self) -> List[str]:
        """Distinct region labels (``evaluation_vit.py:72``).  NOTE: the
        reference uses ``list(set(...))`` whose order is process-dependent;
        here sorted for determinism (only index identity matters)."""
        return sorted(set(self.korea_regions))

    @property
    def stn_to_region_idx(self) -> np.ndarray:
        """Per-station region index (``evaluation_vit.py:77-80``)."""
        names = self.region_names
        return np.asarray([names.index(r) for r in self.korea_regions],
                          dtype=np.int32)


def load_stations(data_path: str, grid_shape=(82, 67)) -> StationInfo:
    lats, lons, korea_regions = [], [], []
    korea, china = 0, 0
    with open(f"{data_path}/station_infos/korea.txt") as f:
        for line in f:
            row = line.strip().split(",")
            lats.append(float(row[2]))
            lons.append(float(row[3]))
            korea_regions.append(row[-1])
            korea += 1
    with open(f"{data_path}/station_infos/china.txt") as f:
        for line in f:
            row = line.strip().split(",")
            lats.append(float(row[2]))
            lons.append(float(row[3]))
            china += 1
    sim_coords = np.zeros((korea, 2), dtype=int)
    with open(f"{data_path}/station_infos/coords.txt") as f:
        for i, line in enumerate(f):
            row = line.strip().split(",")
            sim_coords[i] = [int(row[0]), int(row[1])]
    cmaq_coords = np.zeros(grid_shape + (2,), dtype=float)
    grid_nc = f"{data_path}/station_infos/GRID_INFO_09km.nc"
    cmaq_coords[:, :, 0] = _read_netcdf_var(grid_nc, "LAT")
    cmaq_coords[:, :, 1] = _read_netcdf_var(grid_nc, "LON")
    return StationInfo(np.asarray(lats), np.asarray(lons), korea_regions,
                       korea, china, sim_coords, cmaq_coords)


def load_feat_infos(data_path: str) -> Dict[str, Tuple[float, float]]:
    out = {}
    with open(f"{data_path}/feat_infos.txt") as f:
        for line in f.readlines():
            name, mean, std = line.strip().split(",")
            if name == "feature":
                continue
            out[name] = (float(mean), float(std))
    return out


def load_ground_obs(data_path: str, times, total_stn: int, feat_dim: int,
                    num_threads: int = 8):
    """Hourly station obs -> (T, stations, feat_dim) + mask
    (``evaluation_vit.py:124-133``).

    The reference reads the ~2.2k hourly files serially (its hot loop #0,
    SURVEY §3.1); here a thread pool overlaps the IO (np.load drops the GIL
    during the read) — results are written by index, so ordering is exact.
    """
    from concurrent.futures import ThreadPoolExecutor

    feat = np.zeros((len(times), total_stn, feat_dim), dtype=np.float32)
    mask = np.zeros((len(times), total_stn), dtype=np.float32)

    def one(i_t):
        i, t = i_t
        arr = np.load(f"{data_path}/ground_obs/{t.year}/{t.month}/"
                      + t.strftime("%d%H") + ".npy")
        feat[i] = arr[:, :feat_dim]
        mask[i] = arr[:, -1]

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(one, enumerate(times)))
    return feat, mask


# ---------------------------------------------------------------------------
# the eval loop
# ---------------------------------------------------------------------------

def extract_baselines(simulation: np.ndarray, data_cfg: DataConfig,
                      cells: int):
    """(sim_21h, sim_avg) value series from the stacked CMAQ tensor: channel
    22 (21h-cycle PM2.5) and the mean of the four cycle PM2.5 channels per
    output hour (``evaluation_vit.py:271-276``)."""
    B = simulation.shape[0]
    L = data_cfg.output_dim
    bc = data_cfg.block_channels
    sim_21h = np.zeros((B, L, cells), dtype=np.float32)
    sim_avg = np.zeros((B, L, cells), dtype=np.float32)
    pm_idx = [4, 10, 16, 22]
    for i in range(L):
        blk = simulation[:, :, :, (i + data_cfg.input_dim) * bc:
                         (i + data_cfg.input_dim + 1) * bc]
        sim_21h[:, i] = blk[:, :, :, 22].reshape(B, cells)
        sim_avg[:, i] = blk[:, :, :, pm_idx].mean(axis=3).reshape(B, cells)
    return sim_21h, sim_avg


def evaluate(params, model_cfg: MetNet3Config, data_cfg: DataConfig, *,
             model_name: str = "model",
             test_start: datetime = datetime(2023, 1, 1, 0),
             test_end: datetime = datetime(2023, 3, 31, 23),
             batch_size: int = 25, num_workers: int = 4,
             log_dir: str = "logs", args_repr: str = "",
             matmul_precision: str = "highest",
             sharding: Optional[jax.sharding.Sharding] = None,
             mesh: Optional[jax.sharding.Mesh] = None,
             collect_valid_times: bool = False,
             progress: bool = True,
             max_batches: Optional[int] = None) -> EvaluationMetrics:
    """Run the full evaluation; returns the metric accumulator (and appends
    the reference-format log).

    ``mesh``: data-parallel evaluation — the counterpart of the
    reference's ``nn.DataParallel(vit_model)`` (``evaluation_vit.py:107``).
    The batch axis is sharded over the mesh's 'data' axis and jit/GSPMD
    computes the *global* program, so (unlike torch DataParallel, whose
    per-GPU chunks change the batch-mixing time-embedding quirk
    ``metnet3.py:395-401``) results are bit-identical to the single-device
    run.  A trailing batch not divisible by the data axis falls back to an
    unsharded compile of the same function at its true size — numerics
    unchanged.

    ``collect_valid_times``: reference quirk #19 — collect encoded sample
    times whose last input hour == 6 (``evaluation_vit.py:285-289``) into
    ``metrics.valid_times``; dead bookkeeping in the reference (feeds only a
    commented-out save path ``:472-483``), reproduced behind this flag.
    """
    grid = data_cfg.grid
    cells = grid.cells

    feat_infos = load_feat_infos(data_cfg.data_path)
    stations = load_stations(data_cfg.data_path, (grid.height, grid.width))
    times = eval_time_list(test_start, test_end, data_cfg.prev_len,
                           data_cfg.output_dim)
    feats, masks = load_ground_obs(data_cfg.data_path, times, stations.total,
                                   data_cfg.feat_dim)

    dataset = AirSimulationReanalysisDatasetOnly(
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
    elif sharding is not None:
        params = jax.device_put(params, sharding)

    metrics = EvaluationMetrics(data_cfg.output_dim)
    L = data_cfg.output_dim
    t0 = time.time()
    _roll = [0, t0]      # [samples, timestamp] at the last progress line

    def _stage(batch):
        """Host->device staging for one batch: model input conversion and
        device placement.  ``jax.device_put`` is asynchronous, so calling
        this for batch k+1 right after dispatching fwd(k) overlaps the
        host->HBM transfer with the forward.

        A ragged final batch (B not divisible over the mesh's data axis,
        drop_last=False like the reference) runs unsharded at its TRUE
        size through the same ``fwd`` — bit-identical to the single-device
        run: padding it would perturb real predictions through the
        batch-mixing time-embedding quirk #11."""
        simulation, _, _, _, raw_times, _ = batch
        B = simulation.shape[0]
        out_dtype = (jnp.bfloat16 if model_cfg.compute_dtype == "bfloat16"
                     else np.float32)
        if model_cfg.nhwc_input:
            # host-prepared device layout: no axis permutation on host OR
            # device (bit-exact vs the standard staging,
            # tests/test_nhwc_input.py)
            sim_vit = sim_stack_to_nhwc_input(
                simulation, data_cfg.total_steps, model_cfg.pad_multiple,
                out_dtype)
        else:
            sim_vit = sim_stack_to_model_input(
                simulation, data_cfg.total_steps, out_dtype=out_dtype)
        x, ts = jnp.asarray(sim_vit), jnp.asarray(raw_times)
        if batch_shd is not None and B % n_data == 0:
            x = jax.device_put(x, batch_shd)
            ts = jax.device_put(ts, batch_shd)
        return batch, B, x, ts

    import itertools

    from vit_grid_model_tpu.utils.hbm import oom_guard

    it = (iter(loader) if max_batches is None
          else itertools.islice(iter(loader), max_batches))
    nxt = next(it, None)
    staged = _stage(nxt) if nxt is not None else None
    bi = -1
    while staged is not None:
        bi += 1
        ((simulation, curr_re, reanalysis, re_cls, raw_times, prev_vals),
         B, x, ts) = staged
        with oom_guard("MetNet3 evaluation forward", batch_size):
            preds_dev = fwd(params, x, ts)          # async dispatch
            nxt = next(it, None)                    # overlap: stage k+1 now
            staged = _stage(nxt) if nxt is not None else None
            # readback: XLA compile/alloc failures surface here
            preds = np.asarray(preds_dev)[:B].reshape(B, L, cells)
        preds = np.maximum(preds, 0.0)           # ``evaluation_vit.py:254``
        if np.isnan(preds).any():                # NaN guard (``:256``)
            raise FloatingPointError(
                f"NaN in model output at batch {bi}")

        persist = np.repeat(curr_re.reshape(B, 1, cells), L, axis=1)
        sim_21h, sim_avg = extract_baselines(simulation, data_cfg, cells)

        metrics.update(
            model=preds, persist=persist, sim_21h=sim_21h, sim_avg=sim_avg,
            truth=reanalysis.reshape(B, L, cells),
            truth_cls=re_cls.reshape(B, L, cells))
        if collect_valid_times:
            # quirk #19: samples whose LAST input hour is 06 KST, encoded
            # YYYYMMDDHH as int (``evaluation_vit.py:285-289``)
            last_in = np.asarray(raw_times)[:, data_cfg.input_dim - 1]
            sel = last_in[last_in[:, 3] == 6.0].astype(np.int64)
            metrics.valid_times.append(
                sel[:, 0] * 1000000 + sel[:, 1] * 10000
                + sel[:, 2] * 100 + sel[:, 3])
        if progress and bi % 10 == 0:
            done = metrics.step_cnt * batch_size
            now = time.time()
            rate = done / max(now - t0, 1e-9)
            # rolling rate over the last window = the steady state, free of
            # the first batch's compile+warmup (which dominates cumulative)
            roll = ((done - _roll[0]) / max(now - _roll[1], 1e-9)
                    if bi else 0.0)
            _roll[:] = [done, now]
            print(f"eval batch {bi} ({done} samples, {rate:.1f} samples/s "
                  f"cum, {roll:.1f} last-10)", flush=True)

    with logwriter.open_log(model_name, log_dir) as f:
        logwriter.write_log(f, metrics, args_repr)
    return metrics
