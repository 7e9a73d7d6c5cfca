"""``chip_smoke.py``'s phases at tiny widths on the CPU, and its refusal to
run without a GPU.  On the card the same functions run at the shipped
width (``python chip_smoke.py``)."""

import os
import sys

import numpy as np
import pytest

import jax

from tests import conftest as C  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from vit_grid_model_tpu.models.metnet3 import metnet3_init  # noqa: E402

# the CLIs fix 32 heads x 32; the direct phases take the widths below
TINY = S.Widths(input_dim=2, output_dim=2, prev_len=3, hidden=16, heads=4,
                dim_head=4)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    paths, start, end = S.make_tree(str(root / "tree"), TINY, 6)
    return root, paths, start, end


@pytest.fixture(scope="module")
def params():
    return metnet3_init(jax.random.PRNGKey(0), TINY.model_config())


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "f32"])
def test_phase_eval(tree, fast):
    root, paths, start, end = tree
    s = S.phase_eval(paths, start, end, TINY, fast=fast, batch=4,
                     max_batches=2, log_dir=str(root / "logs"),
                     name=f"eval_{fast}")
    assert np.isfinite(s["model"]["RMSE"]) and s["model"]["RMSE"] > 0


def test_phase_serving(params):
    outs, lat, setup = S.phase_serving(params, TINY, requests=2)
    assert len(outs) == len(lat) == 2 and setup > 0
    assert outs[0].shape == (1, 2, 82, 67)
    # two different requests give two different forecasts
    assert not np.array_equal(outs[0], outs[1])


def test_phase_train_saves_and_resumes(tree):
    root, paths, start, end = tree
    m1, m2, state = S.phase_train(paths, start, end, TINY,
                                  str(root / "ckpt"), steps=2, batch=2)
    assert int(state.step) == 3
    assert np.isfinite(m1["loss"]) and np.isfinite(m2["loss"])


def test_phase_generate(tree):
    root, paths, start, end = tree
    fields = S.phase_generate(paths, start, start.replace(hour=3), TINY,
                              str(root / "gen"), batch=2)
    # 4 windows x 2 leads
    assert fields.shape == (8, 82, 67)


def test_phase_numerics(params):
    cpu = jax.devices("cpu")[0]
    out = S.phase_numerics(params, TINY, device=cpu, ref_device=cpu)
    assert out["f32_vs_cpu_rel_l2"] == 0.0          # same backend here
    assert 0.0 < out["fast_vs_f32_rel_l2"] <= S.BOUND_FAST_VS_F32
    assert out["fast_vs_f32_rmse_ugm3"] > 0.0
    assert 0.0 <= out["default_vs_highest_rel_l2"] <= S.BOUND_TF32_VS_F32


def test_phase_int8(params):
    rmse = S.phase_int8(params, TINY)
    assert np.isfinite(rmse) and rmse > 0.0


def test_phase_four_devices(tmp_path):
    """The ``--four-gpus`` phase on four virtual CPU devices: data-parallel
    eval, train step and generation each match one device."""
    assert len(jax.devices()) >= 4
    out = S.phase_four_gpus(str(tmp_path), TINY, n_devices=4)
    assert out["eval_summary_rel_diff"] <= S.BOUND_DATA_PARALLEL
    assert out["train_loss_rel_diff"] <= S.BOUND_DATA_PARALLEL
    assert out["generated_fields"] > 0


def test_main_refuses_cpu(capsys):
    assert S.main([]) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "needs a GPU" in captured.err


def test_rel_l2_and_summary_diff():
    a = np.array([3.0, 4.0])
    assert S.rel_l2(a, a) == 0.0
    assert S.rel_l2(np.zeros(2), a) == pytest.approx(1.0)
    s = {k: {"RMSE": 2.0, "R": float("nan")}
         for k in ("model", "persist", "sim_21h", "sim_avg")}
    t = {k: dict(v) for k, v in s.items()}
    assert S._summary_rel_diff(s, t) == 0.0
    t["model"]["RMSE"] = 2.002
    assert S._summary_rel_diff(t, s) == pytest.approx(1e-3)


@pytest.mark.gpu
def test_numerics_on_gpu(gpu, params):
    """The numeric comparisons at tiny widths on a real card (skips here)."""
    out = S.phase_numerics(params, TINY, device=gpu,
                           ref_device=jax.devices("cpu")[0])
    assert out["f32_vs_cpu_rel_l2"] <= S.BOUND_F32_VS_CPU
    assert out["fast_vs_f32_rel_l2"] <= S.BOUND_FAST_VS_F32
