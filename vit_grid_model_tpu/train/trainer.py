"""Training loop: Focal-R supervised MetNet3 on a device mesh.

The reference ships no trainer (SURVEY.md §3.5); this is the reconstructed
contract — ``Dataset_v3``-style batches -> MetNet3 forward -> Focal-R on
(preds, reanalysis) -> optimizer step:

* one jit-compiled train step over a named mesh: batch sharded on 'data',
  params replicated (or head-sharded with tensor_parallel); GSPMD inserts
  the gradient all-reduce;
* MBConv batch-norm statistics computed globally (XLA turns the batch mean
  into a cross-device reduction) and their running averages merged back into
  the param pytree, exactly like torch's momentum update;
* optional ``jax.checkpoint`` rematerialization of the backbone to trade
  FLOPs for device memory;
* optax AdamW + cosine schedule + global-norm clipping; orbax checkpoints.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
import optax

from vit_grid_model_tpu.core.config import MetNet3Config, TrainConfig
from vit_grid_model_tpu.models.metnet3 import metnet3_apply
from vit_grid_model_tpu.train import losses as L


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: jnp.ndarray
    rng: jnp.ndarray
    # exponential moving average of params (None unless TrainConfig.ema_decay
    # > 0); evaluated instead of the raw params when present
    ema_params: Any = None


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.total_steps, cfg.warmup_steps + 1))

    def decay_mask(params):
        # BN running stats are state, not weights: exclude from weight decay
        # (their grads are zero via stop_gradient, but adamw decay is
        # decoupled and would shrink them regardless)
        return jax.tree_util.tree_map_with_path(
            lambda path, _: not _is_bn_stat(path), params)

    return optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip_norm),
        optax.adamw(schedule, weight_decay=cfg.weight_decay,
                    mask=decay_mask),
    )


def _is_bn_stat(path) -> bool:
    keys = [str(getattr(p, "key", "")) for p in path]
    return keys[-1] in ("mean", "var") and any(
        k.startswith("bn") for k in keys)


def init_train_state(params, cfg: TrainConfig) -> TrainState:
    tx = make_optimizer(cfg)
    ema = jax.tree.map(jnp.array, params) if cfg.ema_decay > 0 else None
    return TrainState(params=params, opt_state=tx.init(params),
                      step=jnp.zeros((), jnp.int32),
                      rng=jax.random.PRNGKey(cfg.seed),
                      ema_params=ema)


def _merge_bn(params, bn_updates):
    """Write the collected MBConv running stats back into the pytree."""
    params = jax.tree.map(lambda x: x, params)  # shallow copy
    layers = [dict(layer) for layer in params["vit"]["layers"]]
    for li, stats in enumerate(bn_updates):
        conv = dict(layers[li]["conv"])
        for bn_name, s in stats.items():
            bn = dict(conv[bn_name])
            # keep the stored dtype (f32): under bf16 compute the collected
            # stats arrive bf16, and letting them replace f32 leaves would
            # silently turn the param pytree (and its .npz checkpoints,
            # which can't represent bf16) heterogeneous
            bn["mean"] = jax.lax.stop_gradient(
                s["mean"]).astype(bn["mean"].dtype)
            bn["var"] = jax.lax.stop_gradient(
                s["var"]).astype(bn["var"].dtype)
            conv[bn_name] = bn
        layers[li] = {**layers[li], "conv": conv}
    params["vit"] = {**params["vit"], "layers": layers}
    return params


def build_train_step(model_cfg: MetNet3Config,
                     train_cfg: TrainConfig) -> Callable:
    """Returns jitted ``step(state, batch) -> (state, metrics)``.

    batch: dict with 'x' (B,T,C,H,W), 'timestamps' (B,T,4),
    'targets' (B,L,H,W), optional 'mask' (B,L,H,W) bool.
    """
    loss_kw = {}
    if train_cfg.loss == "focal_r":
        loss_kw = dict(beta=train_cfg.focal_beta, gamma=train_cfg.focal_gamma,
                       focusing=train_cfg.focal_focusing)
    elif train_cfg.loss == "huber":
        loss_kw = dict(delta=10.0)
    loss_fn_core = L.make_loss(train_cfg.loss, **loss_kw)
    tx = make_optimizer(train_cfg)

    def apply_model(params, x, ts, rng):
        def fwd(p, xx):
            collect = []
            preds = metnet3_apply(p, xx, ts, model_cfg, training=True,
                                  rng=rng, collect_bn=collect)
            # return the collected BN stats as outputs so they stay inside
            # the (possibly rematerialized) transform boundary
            return preds, collect

        if train_cfg.remat:
            fwd = jax.checkpoint(fwd)
        return fwd(params, x)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        rng, step_rng = jax.random.split(state.rng)

        def loss_of(params):
            preds, bn_updates = apply_model(
                params, batch["x"], batch["timestamps"], step_rng)
            loss = loss_fn_core(preds, batch["targets"],
                                batch.get("mask"))
            return loss, (preds, bn_updates)

        (loss, (preds, bn_updates)), grads = jax.value_and_grad(
            loss_of, has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        params = _merge_bn(params, bn_updates)
        ema = state.ema_params
        if ema is not None and train_cfg.ema_decay > 0:
            d = train_cfg.ema_decay
            # BN running stats ride the same EMA — they are themselves
            # exponential averages, so a second smoothing is harmless and
            # keeps eval-with-EMA self-consistent
            ema = jax.tree.map(lambda e, p: e * d + p * (1.0 - d),
                               ema, params)
        gnorm = optax.global_norm(grads)
        metrics = {
            "loss": loss, "grad_norm": gnorm,
            "pred_mean": jnp.mean(preds),
            "rmse": jnp.sqrt(jnp.mean(jnp.square(
                preds - jnp.nan_to_num(batch["targets"])))),
        }
        return TrainState(params, opt_state, state.step + 1, rng, ema), metrics

    # With a mesh, shardings ride on the input arrays themselves: the caller
    # places params/opt_state replicated and the batch sharded on 'data'
    # (``parallel.mesh.shard_batch``); GSPMD propagates the rest and inserts
    # the gradient all-reduce.  donate lets XLA reuse the old state's memory.
    return jax.jit(step, donate_argnums=0)


def train_loop(state: TrainState, batches: Iterable, step_fn: Callable, *,
               log_every: int = 10, max_steps: Optional[int] = None,
               log: Callable[[str], None] = print):
    """Drive the jitted step over an iterable of host batches.  Returns
    ``(state, metrics)``: the final state and the last step's metrics (device
    arrays; None when ``batches`` was empty)."""
    from vit_grid_model_tpu.utils.hbm import oom_guard

    t0 = time.time()
    roll = [0, t0]       # [step count, timestamp] at the last log line
    metrics = None
    for i, batch in enumerate(batches):
        if max_steps is not None and i >= max_steps:
            break
        with oom_guard("train step",
                       np.asarray(batch["x"]).shape[0]
                       if isinstance(batch, dict) and "x" in batch
                       else None):
            # compile-time memory exhaustion surfaces at the call; runtime
            # exhaustion at the metric readback below — both guarded
            state, metrics = step_fn(state, batch)
            if i % log_every == 0:
                # the readback waits on every prior step via data
                # dependence, so the logged steps/s stays honest without a
                # per-step sync
                m = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                rate = (i + 1) / (now - t0)
                # rolling window = the steady state, free of compile+warmup
                last = ((i + 1 - roll[0]) / max(now - roll[1], 1e-9)
                        if i else 0.0)
                roll[:] = [i + 1, now]
                log(f"step {int(state.step)}: loss={m['loss']:.4f} "
                    f"rmse={m['rmse']:.3f} gnorm={m['grad_norm']:.3f} "
                    f"({rate:.2f} steps/s cum, {last:.2f} last-{log_every})")
    return state, metrics
