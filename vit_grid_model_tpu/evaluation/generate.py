"""Batched re-analysis generation: data-parallel inference over a mesh.

The production path for multi-day CMAQ archives: stream CMAQ windows
through the jit-compiled MetNet3 forward with the batch axis sharded over
the mesh's 'data' axis, overlap host->device transfers with compute, and
write one PM2.5 field file per (sample time, lead hour).

Single-card and multi-card runs share this code — only the mesh differs;
XLA emits the scatter/gather collectives from the shardings.
"""

from __future__ import annotations

import os
import time
from datetime import datetime
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from vit_grid_model_tpu.core.config import DataConfig, MetNet3Config
from vit_grid_model_tpu.data.assembly import (host_stage_dtype,
                                              sim_stack_to_model_input)
from vit_grid_model_tpu.data.datasets import AirSimulationReanalysisDatasetOnly
from vit_grid_model_tpu.data.pipeline import BatchLoader, device_prefetch
from vit_grid_model_tpu.data.timeutil import eval_time_list
from vit_grid_model_tpu.evaluation import driver as eval_driver
from vit_grid_model_tpu.models.metnet3 import metnet3_apply
from vit_grid_model_tpu.parallel import mesh as meshlib


def generate_reanalysis(params, model_cfg: MetNet3Config,
                        data_cfg: DataConfig, *, start: datetime,
                        end: datetime, out_dir: str, batch_size: int = 8,
                        num_workers: int = 4,
                        mesh: Optional[jax.sharding.Mesh] = None,
                        matmul_precision: str = "default",
                        progress: bool = True) -> int:
    """Generate PM2.5 re-analysis fields for every hour in [start, end].

    Writes ``{out_dir}/{YYYYmmddHH}_{lead:02d}.npy`` (82, 67) float32 per
    sample hour and lead.  Returns the number of fields written.
    """
    grid = data_cfg.grid
    feat_infos = eval_driver.load_feat_infos(data_cfg.data_path)
    stations = eval_driver.load_stations(data_cfg.data_path,
                                         (grid.height, grid.width))
    times = eval_time_list(start, end, data_cfg.prev_len, data_cfg.output_dim)
    feats, masks = eval_driver.load_ground_obs(
        data_cfg.data_path, times, stations.total, data_cfg.feat_dim)
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

    n_dev = mesh.shape["data"] if mesh is not None else 1
    if batch_size % n_dev != 0:
        raise ValueError(f"batch_size {batch_size} must divide evenly over "
                         f"the {n_dev}-way data axis")
    def forward(p, x, ts):
        with jax.default_matmul_precision(matmul_precision):
            return metnet3_apply(p, x, ts, model_cfg)

    fwd = jax.jit(forward)
    if mesh is not None:
        params = jax.device_put(params, meshlib.replicated(mesh))
        bsh = meshlib.batch_sharding(mesh)

    def prepare(batch):
        simulation, _, _, _, raw_times, _ = batch
        if model_cfg.nhwc_input:
            # host-prepared device layout (see evaluation/driver.py):
            # padded + compute-dtype already, no further host cast needed
            import jax.numpy as _jnp

            from vit_grid_model_tpu.data.assembly import \
                sim_stack_to_nhwc_input
            x = sim_stack_to_nhwc_input(
                simulation, data_cfg.total_steps, model_cfg.pad_multiple,
                _jnp.bfloat16 if model_cfg.compute_dtype == "bfloat16"
                else np.float32)
        else:
            x = sim_stack_to_model_input(simulation, data_cfg.total_steps)
        # Always pad to the full batch size: one compiled shape, and — a
        # faithful reference quirk — the dim-0 time-embedding concat
        # (``metnet3.py:395-401``) mixes embeddings ACROSS batch members,
        # so outputs are only reproducible under a fixed batch composition.
        (x, raw_times), real = meshlib.pad_to_multiple((x, raw_times),
                                                        batch_size)
        if not model_cfg.nhwc_input:
            x = host_stage_dtype(x, model_cfg.compute_dtype)
        if mesh is not None:
            return (jax.device_put(jnp.asarray(x), bsh),
                    jax.device_put(jnp.asarray(raw_times), bsh), real)
        return jnp.asarray(x), jnp.asarray(raw_times), real

    os.makedirs(out_dir, exist_ok=True)
    written = 0
    sample_idx = 0
    t0 = time.time()
    batches = iter(loader)
    for x, ts, real in device_prefetch(batches, prepare):
        preds = np.asarray(fwd(params, x, ts))[:real]   # (B, L, H, W)
        for b in range(real):
            t = times[dataset._mod_idx(sample_idx + b)]
            for lead in range(model_cfg.end_lead_time):
                path = os.path.join(
                    out_dir, f"{t.strftime('%Y%m%d%H')}_{lead + 1:02d}.npy")
                np.save(path, preds[b, lead])
                written += 1
        sample_idx += real
        if progress and sample_idx % (batch_size * 5) < batch_size:
            rate = written / max(time.time() - t0, 1e-9)
            print(f"generated {written} fields ({rate:.1f} fields/s)",
                  flush=True)
    return written
