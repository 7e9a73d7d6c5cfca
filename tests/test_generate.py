"""Data-parallel generation driver over the 8-device virtual CPU mesh: sharded
batches must produce the same fields as unsharded single-device inference."""

import os
from datetime import datetime

import numpy as np
import pytest

import jax

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import (DataConfig, GridConfig,
                                            MeshConfig, MetNet3Config)
from vit_grid_model_tpu.data import readers, synthetic
from vit_grid_model_tpu.evaluation.generate import generate_reanalysis
from vit_grid_model_tpu.models.metnet3 import metnet3_init
from vit_grid_model_tpu.parallel import mesh as meshlib


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen")
    paths = synthetic.generate_tree(
        str(root), datetime(2023, 3, 1, 0), datetime(2023, 3, 1, 12),
        prev_len=3, output_dim=2, korea_stn_num=5, china_stn_num=2)
    readers.clear_caches()
    return paths


def _cfgs(tree):
    data_cfg = DataConfig(input_dim=2, output_dim=2, prev_len=3,
                          feat_dim=12, grid=GridConfig(),
                          data_path=tree["data_path"],
                          sim_data_path=tree["sim_data_path"],
                          analysis_data_path=tree["analysis_data_path"])
    model_cfg = MetNet3Config(window_size=4, n_variables=24,
                              n_start_channels=16, end_lead_time=2,
                              pm25_mean=22.5, pm25_std=15.5, n_heads=4,
                              dim_head=4)
    return data_cfg, model_cfg


def test_generate_sharded_matches_single(tree, tmp_path):
    data_cfg, model_cfg = _cfgs(tree)
    params = metnet3_init(jax.random.PRNGKey(0), model_cfg)
    start, end = datetime(2023, 3, 1, 0), datetime(2023, 3, 1, 12)

    out1 = tmp_path / "single"
    n1 = generate_reanalysis(params, model_cfg, data_cfg, start=start,
                             end=end, out_dir=str(out1), batch_size=8,
                             mesh=None, progress=False)
    assert n1 > 0

    mesh = meshlib.make_mesh(MeshConfig(data=8, model=1))
    out2 = tmp_path / "sharded"
    n2 = generate_reanalysis(params, model_cfg, data_cfg, start=start,
                             end=end, out_dir=str(out2), batch_size=8,
                             mesh=mesh, progress=False)
    assert n2 == n1

    files = sorted(os.listdir(out1))
    assert files == sorted(os.listdir(out2))
    for f in files:
        a = np.load(out1 / f)
        b = np.load(out2 / f)
        assert a.shape == (82, 67)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


def test_generate_nhwc_matches_standard_bf16(tree, tmp_path):
    """bf16 generation with host-prepared NHWC staging writes fields
    BIT-IDENTICAL to the standard bf16-staged path (the CLI enables
    nhwc_input whenever compute_dtype is bfloat16)."""
    import dataclasses

    data_cfg, model_cfg = _cfgs(tree)
    model_cfg = dataclasses.replace(model_cfg, compute_dtype="bfloat16",
                                    fuse_lead_stem=True)
    params = metnet3_init(jax.random.PRNGKey(0), model_cfg)
    start, end = datetime(2023, 3, 1, 0), datetime(2023, 3, 1, 12)

    out1 = tmp_path / "std_bf16"
    n1 = generate_reanalysis(params, model_cfg, data_cfg, start=start,
                             end=end, out_dir=str(out1), batch_size=4,
                             mesh=None, progress=False)
    out2 = tmp_path / "nhwc_bf16"
    n2 = generate_reanalysis(
        params, dataclasses.replace(model_cfg, nhwc_input=True), data_cfg,
        start=start, end=end, out_dir=str(out2), batch_size=4,
        mesh=None, progress=False)
    assert n2 == n1 > 0
    for f in sorted(os.listdir(out1)):
        np.testing.assert_array_equal(np.load(out1 / f), np.load(out2 / f),
                                      err_msg=f)


def test_generate_cli_subset_mesh(tree, tmp_path):
    """Review fix: a positive --data_parallel k smaller than the device
    count must build a k-device subset mesh (it used to crash make_mesh's
    coverage check, unlike the sibling eval/train CLIs)."""
    from vit_grid_model_tpu.cli import generate_reanalysis as cli

    out = tmp_path / "cli_out"
    cli.main([
        "--data_path", tree["data_path"],
        "--sim_data_path", tree["sim_data_path"],
        "--analysis_data_path", tree["analysis_data_path"],
        "--input_dim", "2", "--output_dim", "2", "--prev_len", "3",
        "--hidden_dim", "16", "--batch_size", "4", "--data_parallel", "2",
        "--compute_dtype", "float32",
        "--start", "2023-03-01T00", "--end", "2023-03-01T12",
        "--out_dir", str(out),
    ])
    assert len(os.listdir(out)) > 0


def test_generate_bf16_staging_runs(tree, tmp_path):
    """Fast-mode generation stages inputs in bf16 on the host (halved
    host->device transfer); fields still write and stay finite."""
    import dataclasses

    data_cfg, model_cfg = _cfgs(tree)
    model_cfg = dataclasses.replace(model_cfg, compute_dtype="bfloat16")
    params = metnet3_init(jax.random.PRNGKey(0), model_cfg)
    out = tmp_path / "bf16"
    n = generate_reanalysis(params, model_cfg, data_cfg,
                            start=datetime(2023, 3, 1, 0),
                            end=datetime(2023, 3, 1, 12),
                            out_dir=str(out), batch_size=4, mesh=None,
                            progress=False)
    assert n > 0
    sample = np.load(os.path.join(out, sorted(os.listdir(out))[0]))
    assert np.isfinite(sample).all()
