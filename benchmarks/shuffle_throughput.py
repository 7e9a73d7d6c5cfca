"""Training-shuffle loader throughput, post-retention-fix (verdict r4 #3).

The round-3/4 shuffle table's buffer-mode throughput rows were measured
BEFORE ``BufferPool.ensure_retention`` let the reservoir keep its working
set across epoch drains,
so the published reservoir>=16 numbers paid a first-touch page-fault storm
every epoch that the shipping code no longer pays.  This benchmark
re-measures every shuffle mode on one shared synthetic tree with the fixed
pool, at the flagship train geometry (B=4, input 13 / output 12 / prev 13).

Steady state: an 8-day tree gives 192 usable samples -> 48 batches/epoch at
B=4 (>=7 per the verdict); the first TWO epochs pay one-time costs (cold
reader caches, first-touch of pool buffers — ~30 s of kernel fault time vs
~3.5 s steady) and are discarded; the published number is the MEDIAN of the
remaining epochs, WITH their epoch boundaries — the buffer mode's
drain+refill stall is a real recurring cost and belongs in the number.
Median, not mean: a steady epoch is only ~3.5 s of pure CPU on a shared
1-core vCPU, so single epochs swing ±40% on scheduler noise (measured
round 5: wall==cpu, zero major faults, identical allocation profile).

Run serialized on an idle host.
Usage:  PYTHONPATH=/root/repo:$PYTHONPATH python benchmarks/shuffle_throughput.py
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import time
from datetime import datetime

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests import conftest as C  # noqa: F401  CPU backend + reference shims


def main():
    from vit_grid_model_tpu.data import synthetic
    from vit_grid_model_tpu.data import timeutil as TU
    from vit_grid_model_tpu.data.datasets import (
        AirSimulationReanalysisDatasetOnly)
    from vit_grid_model_tpu.data.pipeline import BatchLoader

    root = "/tmp/vit_synth_shufbench"
    shutil.rmtree(root, ignore_errors=True)
    tree = synthetic.generate_tree(root, datetime(2023, 1, 10, 0),
                                   datetime(2023, 1, 17, 23))
    times = TU.eval_time_list(datetime(2023, 1, 10, 0),
                              datetime(2023, 1, 17, 23), 13, 12)
    rng = np.random.default_rng(0)
    feats = rng.random((len(times), 11, 12)).astype(np.float32)
    masks = np.ones((len(times), 11))
    ds = AirSimulationReanalysisDatasetOnly(
        times, feats, masks, input_dim=13, output_dim=12, prev_len=13,
        korea_stn_num=8, china_stn_num=3, cmaq_size=(82, 67),
        sim_data_path=tree["sim_data_path"],
        reanalysis_data_path=tree["analysis_data_path"],
        feat_infos=synthetic.DEFAULT_FEAT_INFOS)

    results = {}
    for label, shuffle, reservoir in (
            ("samples", True, 8),
            ("batches", "batches", 8),
            ("buffer_r8", "buffer", 8),
            ("buffer_r16", "buffer", 16),
            ("buffer_r64", "buffer", 64)):
        loader = BatchLoader(ds, batch_size=4, num_workers=4,
                             dispatch="auto", shuffle=shuffle, seed=1,
                             shuffle_buffer=reservoir)
        rates = []
        for epoch in range(8):
            t0 = time.perf_counter()
            seen = 0
            for batch in loader:
                seen += batch[0].shape[0]
            rates.append(seen / (time.perf_counter() - t0))
        steady = rates[2:]
        results[label] = round(statistics.median(steady), 1)
        results[label + "_minmax"] = [round(min(steady), 1),
                                      round(max(steady), 1)]

    print(json.dumps({"metric": "shuffle_loader_samples_per_sec_B4",
                      "batches_per_epoch": len(ds) // 4,
                      **results}))


if __name__ == "__main__":
    main()
