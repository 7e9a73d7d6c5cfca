"""Reverse checkpoint conversion: framework pytree -> reference torch .pkt.

``core.torch_export`` must produce a state_dict the ACTUAL reference module
accepts with ``strict=True`` (every key, every shape), behave as the exact
inverse of ``core.torch_import``, and preserve the forward function — so a
model trained here drops back into the reference's torch evaluation stack
(``evaluation_vit.py:107-109``) unchanged.

Skipped wholesale when the reference checkout is unavailable.
"""

import numpy as np
import pytest

from tests import conftest as C

pytestmark = pytest.mark.skipif(
    not C.reference_available(), reason="reference checkout not mounted")

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

C.add_reference_to_path()

from vit_grid_model_tpu.core.config import MetNet3Config  # noqa: E402
from vit_grid_model_tpu.core.torch_export import (  # noqa: E402
    export_metnet3_state_dict, save_torch_checkpoint)
from vit_grid_model_tpu.core.torch_import import (  # noqa: E402
    convert_metnet3_state_dict, load_torch_state_dict)
from vit_grid_model_tpu.models.metnet3 import (  # noqa: E402
    metnet3_apply, metnet3_init)


def _assert_close(a, b, rel=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    denom = np.abs(b).max() + 1e-9
    np.testing.assert_array_less(np.abs(a - b).max() / denom, rel)


def _small_cfg(**kw):
    return MetNet3Config(window_size=25, n_variables=24, n_start_channels=16,
                         end_lead_time=3, pm25_mean=17.5, pm25_std=12.3,
                         n_heads=4, dim_head=4, **kw)


def _twin(cfg):
    import metnet3 as ref_metnet3

    tm = ref_metnet3.MetNet3(
        input_size_sample=(cfg.window_size, cfg.n_variables, 82, 67),
        n_start_channels=cfg.n_start_channels,
        end_lead_time=cfg.end_lead_time, pm25_boundaries=[15, 35, 75],
        pm10_boundaries=[15, 35, 75], pm25_mean=cfg.pm25_mean,
        pm25_std=cfg.pm25_std, n_heads=cfg.n_heads, dim_head=cfg.dim_head)
    tm.eval()
    return tm


def _random_timestamps(b, t):
    rng = np.random.default_rng(0)
    return np.stack([
        np.full((b, t), 2023.0, np.float32),
        rng.integers(1, 13, (b, t)).astype(np.float32),
        rng.integers(1, 29, (b, t)).astype(np.float32),
        rng.integers(0, 24, (b, t)).astype(np.float32),
    ], axis=-1)


def test_export_strict_load_and_forward_parity():
    """The exported dict strict-loads into the real reference module and the
    torch forward matches our forward on the exported weights (~1e-4 rel)."""
    cfg = _small_cfg()
    params = metnet3_init(jax.random.PRNGKey(3), cfg)
    sd = export_metnet3_state_dict(params, cfg)

    tm = _twin(cfg)
    missing, unexpected = tm.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        strict=True)
    assert not missing and not unexpected

    B = 2
    x = (np.random.default_rng(1)
         .random((B, cfg.window_size, cfg.n_variables, 82, 67),
                 np.float32) * 50.0)
    ts = _random_timestamps(B, cfg.window_size)
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x.copy()), timestamps=torch.from_numpy(ts))
    fwd = jax.jit(lambda p, xx, tt: metnet3_apply(p, xx, tt, cfg))
    y_j = fwd(params, jnp.asarray(x), jnp.asarray(ts))
    _assert_close(y_j, y_t.numpy())


def test_export_import_round_trip_identity():
    """export -> import reproduces the pytree exactly (bitwise on f32)."""
    cfg = _small_cfg()
    params = metnet3_init(jax.random.PRNGKey(7), cfg)
    back = convert_metnet3_state_dict(
        export_metnet3_state_dict(params, cfg), cfg)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_saved_pkt_round_trips_with_dataparallel_prefix(tmp_path):
    """save_torch_checkpoint writes a 'module.'-prefixed .pkt exactly like
    the shipped blob; the import path consumes the file unmodified."""
    cfg = _small_cfg()
    params = metnet3_init(jax.random.PRNGKey(11), cfg)
    path = str(tmp_path / "exported.pkt")
    save_torch_checkpoint(params, cfg, path, data_parallel=True)

    sd = load_torch_state_dict(path)
    assert all(k.startswith("module.") for k in sd)
    back = convert_metnet3_state_dict(sd, cfg)   # strips the prefix itself
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_export_bf16_params_upcast():
    """bf16 training pytrees (e.g. an on-device compute copy) export as f32
    tensors the reference module accepts."""
    cfg = _small_cfg()
    params = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16),
        metnet3_init(jax.random.PRNGKey(5), cfg))
    sd = export_metnet3_state_dict(params, cfg)
    assert all(v.dtype == np.float32 for k, v in sd.items()
               if "num_batches_tracked" not in k)
    tm = _twin(cfg)
    missing, unexpected = tm.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        strict=True)
    assert not missing and not unexpected
