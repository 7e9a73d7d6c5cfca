"""Legacy grid models: station-encoder LSTM + grid LSTM with joint
(grid ++ station) attention over all 5,494 grid cells.

Re-designs of ``model.py:865-1499``:

* ``simulation_grid_model``: station LSTM during encode; grid LSTM only in
  decode, fed the per-step CMAQ block with PM channels standardized; joint
  MHA over (grid, station) tokens with grid tokens always valid
  (``model.py:932-1044``);
* ``simulation_grid_model_v2``: the grid LSTM also runs through the encode
  phase, consuming the input-window CMAQ blocks (``model.py:1113-1248``);
* ``simulation_grid_model_v3``: v2 + selectable RevIN/DishTS/Standard
  normalization of the input-window PM cycle channels against the grid
  ``prev_vals`` history; decode-phase PM channels always Standard; the
  output head denormalizes per the same method (``model.py:1317-1499``).

The joint attention is one masked softmax over ~5.5k tokens — a single
batched matmul pair instead of the reference's per-step
``nn.MultiheadAttention`` over a concatenated tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vit_grid_model_tpu.models import normalizers as N
from vit_grid_model_tpu.ops import nn as vnn
from vit_grid_model_tpu.ops.recurrent import (lstm_cell, lstm_cell_init,
                                              mha_init, mha_self_attention,
                                              residual_masked_attention)

Array = jax.Array

PM_CYCLE_OFFSETS = np.array([4, 10, 16, 22])


@dataclasses.dataclass(frozen=True)
class GridModelSpec:
    input_dim: int = 7
    feat_dim: int = 12
    hidden_dim: int = 128
    pm25_mean: float = 0.0
    pm25_std: float = 1.0
    output_dim: int = 6
    prev_len: int = 100
    korea_stn_num: int = 0
    china_stn_num: int = 0
    grid_shape: Tuple[int, int] = (82, 67)
    normalization_method: str = "Standard"
    version: int = 3          # 1 | 2 | 3

    @property
    def total_stn_num(self) -> int:
        return self.korea_stn_num + self.china_stn_num

    @property
    def cells(self) -> int:
        return self.grid_shape[0] * self.grid_shape[1]

    @property
    def enc_dim(self) -> int:
        return self.hidden_dim // 32

    @property
    def block_channels(self) -> int:
        return (self.feat_dim // 2) * 4 + 4


def grid_model_init(key, spec: GridModelSpec, lats, lons, cmaq_coords,
                    dtype=jnp.float32):
    keys = jax.random.split(key, 6)
    h = spec.hidden_dim
    h16 = h // 16
    p = {
        "lats": jnp.asarray(lats, dtype),
        "lons": jnp.asarray(lons, dtype),
        "cmaq_coords": jnp.asarray(cmaq_coords, dtype),
        "lat_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "lon_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "month_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "day_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "hour_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "simulation_hour_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "station_encoder_lstm": lstm_cell_init(
            keys[0], spec.feat_dim + h16 * 5, h, dtype),
        "station_decoder_lstm": lstm_cell_init(keys[1], h16 * 5, h, dtype),
        # grid LSTM input: time(3*h16) + 24 sim ch + lead enc(4*2d=h/4)
        # + loc(h/8) == feat_dim*2 + h16*9 (``model.py:917``)
        "grid_lstm": lstm_cell_init(
            keys[2], spec.feat_dim * 2 + h16 * 9, h, dtype),
        "mha_e": mha_init(keys[3], h, dtype),
        "mha_d": mha_init(keys[4], h, dtype),
        "last_fc": vnn.linear_init(keys[5], h, 1, dtype=dtype),
        "station_hidden_init": jnp.zeros((spec.total_stn_num, h), dtype),
        "station_cell_init": jnp.zeros((spec.total_stn_num, h), dtype),
        "grid_hidden_init": jnp.zeros((spec.cells, h), dtype),
        "grid_cell_init": jnp.zeros((spec.cells, h), dtype),
    }
    if spec.version == 3:
        if spec.normalization_method == "RevIN":
            p["revin_layer"] = N.revin_init(spec.cells, dtype=dtype)
        if spec.normalization_method == "DishTS":
            p["dishts_layer"] = N.dishts_init(spec.cells, spec.prev_len,
                                              dtype)
    return p


def _grid_sim_step_input(p, spec: GridModelSpec, simulation: Array,
                         step: int, grid_time: Array, grid_loc: Array,
                         standardize_pm: bool) -> Array:
    """Build the grid LSTM input for one absolute timestep of the stacked
    CMAQ tensor (``model.py:1010-1024``)."""
    b = simulation.shape[0]
    bc = spec.block_channels
    s4 = (spec.feat_dim // 2) * 4
    blk = simulation[:, :, :, step * bc:(step + 1) * bc]
    sim_vals = blk[..., :s4].reshape(b, spec.cells, s4)
    lead = blk[..., s4:].reshape(b, spec.cells, 4)
    lead_enc = N.time_encode(p["simulation_hour_encoder"], lead
                             ).reshape(b, spec.cells, -1)
    if standardize_pm:
        pm = (sim_vals[:, :, PM_CYCLE_OFFSETS] - spec.pm25_mean) / spec.pm25_std
        sim_vals = sim_vals.at[:, :, PM_CYCLE_OFFSETS].set(pm)
    return jnp.concatenate(
        [grid_time, sim_vals.reshape(b * spec.cells, -1),
         lead_enc.reshape(b * spec.cells, -1), grid_loc], axis=-1)


def _joint_attention(p_mha, grid_h: Array, stn_h: Array,
                     stn_valid: Array) -> Array:
    """Masked MHA over concatenated (grid ++ station) tokens; grid tokens
    always valid (``model.py:1029-1034``).

    IMPORTANT reference quirk: the attended result is NEVER written back to
    the recurrent grid/station states — it feeds only the output head
    (``model.py:1031-1037``: ``curr_hidden_state`` is a fresh concat each
    step).  Returns the attended concatenated tokens.
    """
    b, g = grid_h.shape[0], grid_h.shape[1]
    tokens = jnp.concatenate([grid_h, stn_h], axis=1)
    valid = jnp.concatenate(
        [jnp.ones((b, g), bool), stn_valid.astype(bool)], axis=1)
    attn = mha_self_attention(p_mha, tokens, key_padding_mask=~valid)
    return tokens + attn


def grid_model_apply(p, spec: GridModelSpec, feats: Array, masks: Array,
                     raw_times: Array, prev_vals: Array,
                     simulation: Array) -> Array:
    """feats (B, T_in, stn, F); masks (B, T_in+T_out, stn) bool; raw_times
    (B, T_in+T_out, 3) month/day/hour; prev_vals (B, prev_len, H, W) grid
    history (v3) or station history (v1/v2, unused); simulation
    (B, H, W, (T_in+T_out)*28).  Returns (B, cells, output_dim)."""
    b = feats.shape[0]
    h_dim = spec.hidden_dim
    stn = spec.total_stn_num
    cells = spec.cells

    # positional features
    stn_loc = jnp.concatenate(
        [N.time_encode(p["lat_encoder"], p["lats"]),
         N.time_encode(p["lon_encoder"], p["lons"])], axis=-1)
    stn_loc = jnp.broadcast_to(stn_loc, (b,) + stn_loc.shape
                               ).reshape(b * stn, -1)
    grid_loc = jnp.concatenate(
        [N.time_encode(p["lat_encoder"], p["cmaq_coords"][:, :, 0]),
         N.time_encode(p["lon_encoder"], p["cmaq_coords"][:, :, 1])],
        axis=-1)
    grid_loc = jnp.broadcast_to(grid_loc, (b,) + grid_loc.shape
                                ).reshape(b * cells, -1)

    def time_feats(n_tokens, times):
        h16 = spec.hidden_dim // 16
        t = times.shape[1]
        fs = [N.time_encode(p[e], times[:, :, i]).reshape(b, t, h16)
              for i, e in enumerate(("month_encoder", "day_encoder",
                                     "hour_encoder"))]
        tf = jnp.concatenate(fs, axis=-1)
        tf = jnp.transpose(tf, (1, 0, 2))[:, :, None, :]
        tf = jnp.broadcast_to(tf, (t, b, n_tokens, tf.shape[-1]))
        return tf.reshape(t, b * n_tokens, -1)

    time_feat = time_feats(stn, raw_times)
    if spec.version == 1:
        # v1 builds grid time features from the OUTPUT window only
        # (``model.py:959-968``)
        time_feat_grid = time_feats(cells, raw_times[:, spec.input_dim:])
    else:
        time_feat_grid = time_feats(cells, raw_times)

    # station PM standardization (always Standard in the grid family,
    # ``model.py:972``)
    feats = feats.at[:, :, :, 0].set(
        (feats[:, :, :, 0] - spec.pm25_mean) / spec.pm25_std)

    # v3: normalize the input-window PM cycle channels vs grid history
    norm_stats = None
    if spec.version == 3:
        bc = spec.block_channels
        pm_steps = []      # (B, T_in, cells) per cycle
        for ci in range(4):
            planes = [simulation[:, :, :, i * bc + PM_CYCLE_OFFSETS[ci]]
                      .reshape(b, cells) for i in range(spec.input_dim)]
            pm_steps.append(jnp.stack(planes, axis=1))
        prev_flat = prev_vals.reshape(b, spec.prev_len, cells)
        method = spec.normalization_method
        if method == "RevIN":
            norm_stats = N.revin_statistics(
                prev_flat, default_mean=spec.pm25_mean,
                default_std=spec.pm25_std)
            pm_steps = [N.revin_norm(p["revin_layer"], norm_stats, x)
                        for x in pm_steps]
        elif method == "DishTS":
            normed = []
            for x in pm_steps:
                y, norm_stats = N.dishts_norm(p["dishts_layer"], x)
                normed.append(y)
            pm_steps = normed
        else:
            pm_steps = [(x - spec.pm25_mean) / spec.pm25_std
                        for x in pm_steps]
        hh, ww = spec.grid_shape
        for i in range(spec.input_dim):
            for ci in range(4):
                simulation = simulation.at[
                    :, :, :, i * bc + PM_CYCLE_OFFSETS[ci]].set(
                    pm_steps[ci][:, i].reshape(b, hh, ww))

    # ---- encode ----
    stn_h = jnp.broadcast_to(p["station_hidden_init"], (b, stn, h_dim))
    stn_c = jnp.broadcast_to(p["station_cell_init"], (b, stn, h_dim)
                             ).reshape(b * stn, h_dim)
    grid_h = jnp.broadcast_to(p["grid_hidden_init"], (b, cells, h_dim))
    grid_c = jnp.broadcast_to(p["grid_cell_init"], (b, cells, h_dim)
                              ).reshape(b * cells, h_dim)

    feats_t = jnp.transpose(feats, (1, 0, 2, 3))
    for i in range(spec.input_dim):
        inp = jnp.concatenate(
            [feats_t[i].reshape(b * stn, -1), time_feat[i], stn_loc],
            axis=-1)
        h_new, stn_c = lstm_cell(p["station_encoder_lstm"], inp,
                                 stn_h.reshape(b * stn, h_dim), stn_c)
        stn_h = h_new.reshape(b, stn, h_dim)

        if spec.version == 1:
            # v1: station-only masked attention during encode
            stn_h = residual_masked_attention(p["mha_e"], stn_h,
                                              masks[:, i])
        else:
            ginp = _grid_sim_step_input(
                p, spec, simulation, i, time_feat_grid[i], grid_loc,
                standardize_pm=(spec.version == 2))
            g_new, grid_c = lstm_cell(p["grid_lstm"], ginp,
                                      grid_h.reshape(b * cells, h_dim),
                                      grid_c)
            grid_h = g_new.reshape(b, cells, h_dim)
            # the reference computes a joint mha_e attention here whose
            # result is discarded (``model.py:1196-1201``) — dead code,
            # omitted (XLA would DCE it regardless)

    # ---- decode ----
    preds = []
    for i in range(spec.output_dim):
        sinp = jnp.concatenate([time_feat[i + spec.input_dim], stn_loc],
                               axis=-1)
        h_new, stn_c = lstm_cell(p["station_decoder_lstm"], sinp,
                                 stn_h.reshape(b * stn, h_dim), stn_c)
        stn_h = h_new.reshape(b, stn, h_dim)

        if spec.version == 1:
            # v1 quirks (``model.py:1005-1024``): grid time features come
            # from the output window, but the CMAQ blocks are read at step
            # ``i`` — the INPUT window's blocks, not ``i + input_dim``.
            tfg = time_feat_grid[i]
            sim_step = i
        else:
            tfg = time_feat_grid[i + spec.input_dim]
            sim_step = i + spec.input_dim
        ginp = _grid_sim_step_input(
            p, spec, simulation, sim_step, tfg, grid_loc,
            standardize_pm=True)
        g_new, grid_c = lstm_cell(p["grid_lstm"], ginp,
                                  grid_h.reshape(b * cells, h_dim),
                                  grid_c)
        grid_h = g_new.reshape(b, cells, h_dim)

        attended = _joint_attention(
            p["mha_d"], grid_h, stn_h, masks[:, spec.input_dim + i])

        result = vnn.linear(p["last_fc"], attended[:, :cells])
        if spec.version == 3 and spec.normalization_method == "RevIN":
            result = jnp.transpose(N.revin_denorm(
                p["revin_layer"], norm_stats,
                jnp.transpose(result, (0, 2, 1))), (0, 2, 1))
        elif spec.version == 3 and spec.normalization_method == "DishTS":
            result = jnp.transpose(N.dishts_denorm(
                p["dishts_layer"], norm_stats,
                jnp.transpose(result, (0, 2, 1))), (0, 2, 1))
        else:
            result = result * spec.pm25_std + spec.pm25_mean
        preds.append(jax.nn.relu(result))

    return jnp.concatenate(preds, axis=-1)
