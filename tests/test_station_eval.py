"""Station-level evaluation workflow on synthetic data."""

from datetime import datetime

import numpy as np
import pytest

import jax

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import DataConfig, GridConfig, MetNet3Config
from vit_grid_model_tpu.data import readers, synthetic
from vit_grid_model_tpu.evaluation.station_eval import (StationMetrics,
                                                        evaluate_by_station)
from vit_grid_model_tpu.models.metnet3 import metnet3_init


def test_station_metrics_masking():
    m = StationMetrics()
    preds = np.asarray([[[10.0, 50.0, 20.0]]])
    truth = np.asarray([[[12.0, np.nan, 25.0]]])
    # column-6 semantics: True == INVALID observation (dataset.py:1889)
    invalid = np.asarray([[[False, False, True]]])
    m.update(preds, truth, invalid_flag=invalid)
    s = m.summary()
    assert s["n_obs"] == 1            # NaN and flagged-invalid dropped
    assert abs(s["MAE"] - 2.0) < 1e-9


def test_evaluate_by_station(tmp_path):
    paths = synthetic.generate_tree(
        str(tmp_path), datetime(2023, 4, 1, 0), datetime(2023, 4, 1, 10),
        prev_len=3, output_dim=2, korea_stn_num=6, china_stn_num=2)
    readers.clear_caches()
    data_cfg = DataConfig(input_dim=2, output_dim=2, prev_len=3,
                          feat_dim=12, grid=GridConfig(),
                          data_path=paths["data_path"],
                          sim_data_path=paths["sim_data_path"],
                          analysis_data_path=paths["analysis_data_path"])
    model_cfg = MetNet3Config(window_size=4, n_variables=24,
                              n_start_channels=16, end_lead_time=2,
                              pm25_mean=22.5, pm25_std=15.5, n_heads=4,
                              dim_head=4)
    params = metnet3_init(jax.random.PRNGKey(0), model_cfg)
    m = evaluate_by_station(params, model_cfg, data_cfg,
                            test_start=datetime(2023, 4, 1, 0),
                            test_end=datetime(2023, 4, 1, 10),
                            batch_size=4)
    s = m.summary()
    assert s["n_obs"] > 0
    assert np.isfinite(s["RMSE"]) and np.isfinite(s["ACC"])


def test_station_eval_cli_end_to_end(tmp_path):
    """The by_stn workflow is reachable from the command line and writes the
    reference-style metric block."""
    from vit_grid_model_tpu.cli import station_eval as cli

    cli.main([
        "--synthetic", "--synthetic_root", str(tmp_path / "synth"),
        "--gpus", "cpu", "--input_dim", "2", "--output_dim", "2",
        "--prev_len", "3", "--hidden_dim", "16", "--batch_size", "4",
        "--test_start", "2023-04-01T00", "--test_end", "2023-04-01T10",
        "--model_name", "stn_cli", "--log_dir", str(tmp_path / "logs"),
    ])
    log = (tmp_path / "logs" / "test_stn_cli_by_stn.log").read_text()
    # structural check: every scalar line present, '{:.4f}' formatted
    for key in ("total ACC", "total POD", "total FAR", "total F1 score",
                "MAE", "RMSE", "R", "n_obs"):
        assert f"station model {key}:" in log, key
    import re

    assert re.search(r"station model RMSE: \d+\.\d{4}\n", log)
