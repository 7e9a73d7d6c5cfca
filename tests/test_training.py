"""Training-stack tests: losses, one train step, loss decrease on a synthetic
overfit task, BN-stat updates, and multi-device data-parallel equivalence."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401  (device/precision setup)
from vit_grid_model_tpu.core.config import MeshConfig, MetNet3Config, TrainConfig
from vit_grid_model_tpu.models.metnet3 import metnet3_init
from vit_grid_model_tpu.parallel import mesh as meshlib
from vit_grid_model_tpu.train import losses as L
from vit_grid_model_tpu.train.trainer import (build_train_step,
                                              init_train_state)


def _cfg():
    return MetNet3Config(window_size=3, n_variables=24, n_start_channels=16,
                         end_lead_time=2, pm25_mean=22.5, pm25_std=15.5,
                         n_heads=4, dim_head=4)


def _batch(cfg, B=4, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.random((B, cfg.window_size, cfg.n_variables, 82, 67),
                        dtype=np.float32) * 50,
        "timestamps": np.tile(np.asarray([2023., 1., 15., 6.], np.float32),
                              (B, 7, 1)),
        "targets": rng.random((B, cfg.end_lead_time, 82, 67),
                              dtype=np.float32) * 60,
    }


def test_losses_basics():
    p = jnp.asarray([[10.0, 20.0], [30.0, 40.0]])
    t = jnp.asarray([[12.0, jnp.nan], [30.0, 50.0]])
    # NaN targets ignored everywhere
    for fn in (L.focal_r_loss, L.mse_loss, L.mae_loss,
               lambda a, b: L.huber_loss(a, b)):
        v = fn(p, t)
        assert np.isfinite(float(v))
    # focal weight shrinks small errors relative to MSE ordering
    small = L.focal_r_loss(jnp.asarray([1.0]), jnp.asarray([1.1]), base="l1")
    big = L.focal_r_loss(jnp.asarray([1.0]), jnp.asarray([50.0]), base="l1")
    assert float(big) > float(small)
    # zero error -> (near) minimal loss
    assert float(L.focal_r_loss(p, p)) < 1e-6


def test_focal_r_weight_curve():
    """Pin the canonical focusing factor: (2*sigmoid(beta|e|)-1)^gamma —
    exactly 0 at e=0, strictly monotone in |e|, -> 1 for large errors; the
    legacy 'sigmoid' form stays flag-gated with its [0.5, 1) range."""
    e = jnp.linspace(0.0, 200.0, 401)
    w = np.asarray(L.focal_r_weight(e, beta=0.2, gamma=1.0))
    assert w[0] == 0.0                        # zero error -> zero weight
    assert np.all(np.diff(w) >= -1e-6)        # monotone (f32 rounding) ...
    assert np.all(np.diff(w[w < 0.99]) > 0)   # ... strictly below saturation
    assert w[-1] > 0.999                      # saturates to 1
    # matches the algebraic form 2*sigmoid(beta*e) - 1
    ref = 2.0 / (1.0 + np.exp(-0.2 * np.asarray(e))) - 1.0
    np.testing.assert_allclose(w, ref, rtol=1e-6, atol=1e-7)
    # gamma exponentiates the factor
    w2 = np.asarray(L.focal_r_weight(e, beta=0.2, gamma=2.0))
    np.testing.assert_allclose(w2, w ** 2, rtol=1e-6, atol=1e-7)
    # symmetric in the sign of the error
    np.testing.assert_allclose(
        np.asarray(L.focal_r_weight(-e, beta=0.2, gamma=1.0)), w,
        rtol=1e-6, atol=1e-7)
    # legacy form: range [0.5, 1), never below half weight
    wl = np.asarray(L.focal_r_weight(e, beta=0.2, gamma=1.0,
                                     focusing="sigmoid"))
    assert wl[0] == 0.5 and np.all(wl >= 0.5)
    assert np.all(np.diff(wl[wl < 0.99]) > 0)
    with pytest.raises(ValueError):
        L.focal_r_weight(e, focusing="nope")


def test_focal_r_loss_focusing_forms():
    p = jnp.asarray([1.0, 1.0, 1.0])
    t = jnp.asarray([1.0, 2.0, 40.0])
    canon = float(L.focal_r_loss(p, t, base="l1"))
    legacy = float(L.focal_r_loss(p, t, base="l1", focusing="sigmoid"))
    # the canonical factor down-weights the easy cells harder
    assert canon < legacy
    # exact zero loss at exact fit under the canonical form
    assert float(L.focal_r_loss(p, p)) == 0.0


def test_pm_class_cross_entropy():
    logits = jnp.zeros((2, 3, 4))          # uniform -> -log(1/4)
    targets = jnp.asarray([[10.0, 20.0, jnp.nan], [40.0, 80.0, 90.0]])
    v = L.pm_class_cross_entropy(logits, targets, [15.0, 35.0, 75.0])
    np.testing.assert_allclose(float(v), np.log(4.0), rtol=1e-6)


def test_train_step_runs_and_updates():
    cfg = _cfg()
    tc = TrainConfig(total_steps=10, warmup_steps=1, batch_size=4)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    state = init_train_state(params, tc)
    step = build_train_step(cfg, tc)
    before = jax.tree.map(lambda x: np.asarray(x).copy(), state.params)
    state, metrics = step(state, _batch(cfg))
    assert np.isfinite(float(metrics["loss"]))
    assert int(state.step) == 1
    # weights moved
    moved = jax.tree.map(lambda a, b: np.abs(np.asarray(a) - b).max(),
                         state.params, before)
    assert max(jax.tree.leaves(moved)) > 0
    # BN running stats updated away from the (0, 1) init
    bn = state.params["vit"]["layers"][0]["conv"]["bn1"]
    assert np.abs(np.asarray(bn["mean"])).max() > 0


def test_bf16_train_step_keeps_param_dtypes_and_npz_roundtrip(tmp_path):
    """Regression: under bf16 compute the MBConv BN stats are collected in
    bf16; merging them back must preserve the stored f32 dtype — a
    heterogeneous pytree produced .npz checkpoints with opaque void ('V2')
    arrays that failed to load (found by the round-2 --fast training run)."""
    from vit_grid_model_tpu.core.checkpoint import restore_params, save_params

    cfg = MetNet3Config(window_size=3, n_variables=24, n_start_channels=16,
                        end_lead_time=2, pm25_mean=22.5, pm25_std=15.5,
                        n_heads=4, dim_head=4, compute_dtype="bfloat16")
    tc = TrainConfig(total_steps=4, warmup_steps=1, batch_size=2)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    state = init_train_state(params, tc)
    step = build_train_step(cfg, tc)
    state, _ = step(state, _batch(cfg, B=2))
    dtypes = {str(np.asarray(v).dtype) for v in jax.tree.leaves(state.params)}
    assert "bfloat16" not in dtypes and "V2" not in dtypes, dtypes

    path = save_params(str(tmp_path / "p.npz"), state.params)
    back = restore_params(path, state.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_save_params_casts_bf16_leaves(tmp_path):
    """Even if a pytree does carry bf16 leaves, .npz save stores them as f32
    (exact) instead of numpy void, and restore casts back to the ``like``
    dtype so the pytree round-trips dtype-faithfully (review finding:
    without the cast a bf16 model silently came back f32)."""
    from vit_grid_model_tpu.core.checkpoint import restore_params, save_params

    tree = {"w": jnp.asarray([1.5, -2.25], jnp.bfloat16),
            "b": jnp.asarray([0.5], jnp.float32)}
    path = save_params(str(tmp_path / "t.npz"), tree)
    back = restore_params(path, tree)
    assert back["w"].dtype == jnp.bfloat16
    assert back["b"].dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  np.asarray(tree["w"], np.float32))
    np.testing.assert_array_equal(np.asarray(back["b"]), np.asarray(tree["b"]))


def test_restore_train_state_ema_mismatch_message(tmp_path):
    """Resuming with a different --ema_decay than the saved run raises a
    targeted error naming the flag, not a bare key-mismatch assert."""
    import pytest

    from vit_grid_model_tpu.core.checkpoint import (restore_train_state,
                                                    save_train_state)

    cfg = _cfg()
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    tc_ema = TrainConfig(total_steps=2, warmup_steps=1, batch_size=1,
                         ema_decay=0.99)
    tc_plain = TrainConfig(total_steps=2, warmup_steps=1, batch_size=1)
    state = init_train_state(params, tc_ema)
    path = save_train_state(str(tmp_path / "s.npz"), state)
    with pytest.raises(ValueError, match="ema_decay"):
        restore_train_state(path, init_train_state(params, tc_plain))


def test_loss_decreases_overfit():
    cfg = _cfg()
    tc = TrainConfig(learning_rate=1e-3, total_steps=30, warmup_steps=1,
                     batch_size=2, loss="focal_r")
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    state = init_train_state(params, tc)
    step = build_train_step(cfg, tc)
    batch = _batch(cfg, B=2)
    losses = []
    for _ in range(12):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


def test_data_parallel_matches_single_device():
    """The pjit'ed step over an 8-device mesh must produce the same update
    as single-device execution (DataParallel-equivalence, SURVEY §2.3)."""
    cfg = _cfg()
    tc = TrainConfig(total_steps=10, warmup_steps=1, batch_size=8)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    batch = _batch(cfg, B=8)

    # the train step donates its input state; give each run its own buffers
    state1 = init_train_state(jax.tree.map(jnp.array, params), tc)
    step1 = build_train_step(cfg, tc)
    state1, m1 = step1(state1, batch)

    mesh = meshlib.make_mesh(MeshConfig(data=8, model=1))
    state2 = init_train_state(jax.tree.map(jnp.array, params), tc)
    state2 = jax.device_put(state2, meshlib.replicated(mesh))
    sharded = meshlib.shard_batch(mesh, batch)
    step2 = build_train_step(cfg, tc)
    with mesh:
        state2, m2 = step2(state2, sharded)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    diffs = jax.tree.map(
        lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max(),
        state1.params, state2.params)
    assert max(jax.tree.leaves(diffs)) < 1e-4


def test_resume_matches_uninterrupted(tmp_path):
    """Full train-state checkpointing: train 2 steps, save, restore, train 2
    more == an uninterrupted 4-step run (optimizer moments, schedule step
    and PRNG all continue; params-only resume would diverge)."""
    from vit_grid_model_tpu.core.checkpoint import (restore_train_state,
                                                    save_train_state)

    cfg = _cfg()
    tc = TrainConfig(learning_rate=1e-3, total_steps=4, warmup_steps=2,
                     batch_size=2)
    batches = [_batch(cfg, B=2, seed=s) for s in range(4)]

    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    step = build_train_step(cfg, tc)

    full = init_train_state(jax.tree.map(jnp.array, params), tc)
    for b in batches:
        full, _ = step(full, b)

    half = init_train_state(jax.tree.map(jnp.array, params), tc)
    for b in batches[:2]:
        half, _ = step(half, b)
    path = save_train_state(str(tmp_path / "t_state.npz"), half)
    resumed = restore_train_state(path, init_train_state(
        jax.tree.map(jnp.array, params), tc))
    assert int(resumed.step) == 2
    for b in batches[2:]:
        resumed, _ = step(resumed, b)

    assert int(resumed.step) == int(full.step) == 4
    for tree_a, tree_b in ((full.params, resumed.params),
                           (full.opt_state, resumed.opt_state)):
        diffs = jax.tree.map(
            lambda a, b: np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64)).max(),
            tree_a, tree_b)
        assert max(jax.tree.leaves(diffs)) == 0.0
    np.testing.assert_array_equal(np.asarray(full.rng),
                                  np.asarray(resumed.rng))


def test_ema_params_track_weights():
    """TrainConfig.ema_decay maintains an EMA copy: check the exact
    recurrence ema <- d*ema + (1-d)*params over 3 steps."""
    cfg = _cfg()
    d = 0.5
    tc = TrainConfig(learning_rate=1e-3, total_steps=5, warmup_steps=1,
                     batch_size=2, ema_decay=d)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    state = init_train_state(params, tc)
    assert state.ema_params is not None
    step = build_train_step(cfg, tc)

    expect = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
    for s in range(3):
        state, _ = step(state, _batch(cfg, B=2, seed=s))
        expect = jax.tree.map(
            lambda e, p: e * d + np.asarray(p, np.float64) * (1 - d),
            expect, state.params)
    diffs = jax.tree.map(
        lambda a, b: np.abs(np.asarray(a, np.float64) - b).max(),
        state.ema_params, expect)
    assert max(jax.tree.leaves(diffs)) < 1e-6
    # EMA lags the raw params (it still holds init mass)
    moved = jax.tree.map(
        lambda e, p: np.abs(np.asarray(e) - np.asarray(p)).max(),
        state.ema_params, state.params)
    assert max(jax.tree.leaves(moved)) > 0


def test_class_head_outputs():
    """The documented class-head contract (``metnet3.py:432-490``): logits,
    NaN-masked CE, midpoint-decoded values, regional heads."""
    from vit_grid_model_tpu.models.metnet3 import (metnet3_class_outputs,
                                                   metnet3_init)

    cfg = MetNet3Config(window_size=3, n_variables=24, n_start_channels=16,
                        end_lead_time=2, pm25_mean=22.5, pm25_std=15.5,
                        n_heads=4, dim_head=4, pm25_class_head=True,
                        pm10=True, direct_regional=True)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    b = _batch(cfg, B=1)
    BL = 1 * cfg.end_lead_time
    labels = np.random.default_rng(0).random((BL, 82, 67)).astype(np.float32) * 90
    labels[0, 0, 0] = np.nan
    regions = np.random.default_rng(1).random((BL, 19)).astype(np.float32) * 40
    out = metnet3_class_outputs(
        params, jnp.asarray(b["x"]), jnp.asarray(b["timestamps"]), cfg,
        labels_pm25=jnp.asarray(labels), region_targets_pm25=jnp.asarray(regions),
        labels_pm10=jnp.asarray(labels), region_targets_pm10=jnp.asarray(regions))
    assert out["logits_pm25"].shape == (BL, 82, 67, 4)
    assert out["logits_pm10"].shape == (BL, 82, 67, 4)
    assert out["region_preds_pm25"].shape == (BL, 19)
    assert np.isfinite(float(out["loss"]))
    # midpoint decoding lands on the documented class values
    vals = np.unique(np.asarray(out["predicted_pm25"]))
    assert set(vals) <= {7.5, 25.0, 55.0, 75.0}


def test_fast_config_loss_curve():
    """A short loss curve of the ``--fast`` training configuration (bf16,
    fused lead stem, host-prepared NHWC input, dropout on) on a fixed
    batch: every loss finite, and the curve falls."""
    import dataclasses

    from vit_grid_model_tpu.data.assembly import model_input_to_nhwc

    cfg = dataclasses.replace(_cfg(), compute_dtype="bfloat16",
                              fuse_lead_stem=True, nhwc_input=True,
                              dropout=0.1)
    tc = TrainConfig(learning_rate=1e-3, total_steps=30, warmup_steps=1,
                     batch_size=2)
    state = init_train_state(metnet3_init(jax.random.PRNGKey(0), cfg), tc)
    step = build_train_step(cfg, tc)
    batch = _batch(cfg, B=2)
    batch["x"] = model_input_to_nhwc(batch["x"], cfg.pad_multiple,
                                     jnp.bfloat16).copy()
    losses = []
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all(), losses
    assert np.mean(losses[-3:]) < 0.9 * np.mean(losses[:3]), losses
