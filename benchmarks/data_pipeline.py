"""Host data-plane throughput: sample assembly at the flagship geometry
(input 13 / output 12 / prev 13 — ~100 file touches per sample, the
reference's dominant wall-clock cost per SURVEY §3.3).

Compares, on one shared synthetic tree:

* the reference torch ``Air_Simulation_Reanalysis_Dataset_only``
  (``/root/reference/src/dataset.py:1058``) — no caching, per-sample
  re-reads;
* this framework's numpy path, cold (LRU caches cleared before every
  sample) and warm (consecutive samples share ~96% of their files);
* the native C++ assembler (``native/cmaq_loader.cc`` — GIL-free threaded
  read+standardize+interleave in one pass);
* the threaded ``BatchLoader`` end to end (what the eval/train loops see).

CPU-only (imports tests.conftest for the reference shims, which forces the
CPU backend — fine: no accelerator is involved in this benchmark).

Usage:  PYTHONPATH=. python benchmarks/data_pipeline.py
"""
from __future__ import annotations

import json
import shutil
import time
from datetime import datetime

import numpy as np

from tests import conftest as C  # CPU backend + reference import shims


def main():
    from vit_grid_model_tpu.data import synthetic
    from vit_grid_model_tpu.data import timeutil as TU
    from vit_grid_model_tpu.data.datasets import (
        AirSimulationReanalysisDatasetOnly)
    from vit_grid_model_tpu.data.pipeline import BatchLoader
    from vit_grid_model_tpu.data.readers import clear_caches

    root = "/tmp/vit_synth_dpbench"
    shutil.rmtree(root, ignore_errors=True)
    # 8 days -> 192 samples: >=7 full batches per epoch at B=25.  The
    # round-3 4-day tree gave B=25 only THREE batches per epoch, so the
    # "steady" rate was dominated by the pipeline-fill batches (the
    # consumer idles while batch 1 assembles) — the published 69.2
    # samples/s "cliff" was this amortization artifact, not assembly cost:
    # direct get_batch_collated is FASTER per sample at B=25 than at B=4
    # (benchmarks/loader_profile.py).
    tree = synthetic.generate_tree(root, datetime(2023, 1, 10, 0),
                                   datetime(2023, 1, 17, 23))
    times = TU.eval_time_list(datetime(2023, 1, 10, 0),
                              datetime(2023, 1, 17, 23), 13, 12)
    rng = np.random.default_rng(0)
    feats = rng.random((len(times), 11, 12)).astype(np.float32)
    masks = np.ones((len(times), 11))
    kwargs = dict(input_dim=13, output_dim=12, prev_len=13, korea_stn_num=8,
                  china_stn_num=3, cmaq_size=(82, 67),
                  sim_data_path=tree["sim_data_path"],
                  reanalysis_data_path=tree["analysis_data_path"],
                  feat_infos=synthetic.DEFAULT_FEAT_INFOS)
    ours = AirSimulationReanalysisDatasetOnly(times, feats, masks, **kwargs)
    n = min(len(ours), 16)

    def timed(fn, per_sample_reset=None):
        t0 = time.perf_counter()
        for i in range(n):
            if per_sample_reset:
                per_sample_reset()
            fn(i)
        return n / (time.perf_counter() - t0)

    results = {}

    # reference torch dataset (no cache layer in the reference)
    if C.reference_available():
        C.add_reference_to_path()
        import dataset as ref_dataset

        theirs = ref_dataset.Air_Simulation_Reanalysis_Dataset_only(
            times, feats, masks, 13, 12, 13, 8, 3, (82, 67),
            tree["sim_data_path"], tree["analysis_data_path"],
            synthetic.DEFAULT_FEAT_INFOS)
        results["reference_torch"] = timed(lambda i: theirs[i])

    ours.use_native = False
    clear_caches()
    results["ours_numpy_cold"] = timed(lambda i: ours[i],
                                       per_sample_reset=clear_caches)
    results["ours_numpy_warm"] = timed(lambda i: ours[i])

    from vit_grid_model_tpu.data import native
    if native.available():
        ours.use_native = True
        clear_caches()
        results["ours_native"] = timed(lambda i: ours[i])

    ours.use_native = None   # auto
    # dispatch="auto" resolves to the single-dispatcher mode on the native
    # plane (one sequential caller; the C++ pool is the only parallelism,
    # and get_batch_collated assembles straight into the batched layout);
    # the legacy pool mode is kept for the delta.  B=25 is the reference's
    # actual eval geometry (evaluation_vit.py:138) — union step sharing is
    # (25-1+25)/25 = 1.96 reads per sample vs 25.
    # Two epochs per configuration: epoch 1 pays the one-time process
    # costs (first-touch page faults of the output-pool buffers, cold
    # reader caches) that a real workload (2,179 samples, 87+ batches)
    # amortizes to nothing; epoch 2 is the steady state the eval/train
    # loops actually see, so it is the headline `*_e2e` number.
    for label, dispatch, bs, shuffle in (
            ("batch_loader_e2e", "auto", 4, False),
            ("batch_loader_pool_mode", "pool", 4, False),
            ("batch_loader_e2e_b25", "auto", 25, False),
            # training shuffles: sample-level forfeits union assembly,
            # the chunk-shuffle mode keeps it
            ("batch_loader_shuffle_samples", "auto", 4, True),
            ("batch_loader_shuffle_batches", "auto", 4, "batches"),
            ("batch_loader_shuffle_buffer", "auto", 4, "buffer")):
        loader = BatchLoader(ours, batch_size=bs, num_workers=4,
                             dispatch=dispatch, shuffle=shuffle, seed=1)
        for epoch_label in (label + "_firstepoch", label):
            t0 = time.perf_counter()
            seen = 0
            for batch in loader:
                seen += batch[0].shape[0]
            results[epoch_label] = seen / (time.perf_counter() - t0)
        if label.startswith(("batch_loader_pool", "batch_loader_shuffle")):
            results.pop(label + "_firstepoch")   # delta rows only

    out = {"metric": "assembly_samples_per_sec",
           **{k: round(v, 2) for k, v in results.items()}}
    if "reference_torch" in results and "ours_native" in results:
        out["native_speedup_vs_reference"] = round(
            results["ours_native"] / results["reference_torch"], 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
