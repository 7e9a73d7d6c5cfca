"""Legacy station-level models: MultiAir and the simulation_model family.

Re-designs of ``model.py:251-863``: LSTM encoder over station
time series with per-step masked attention across stations, followed by a
decoder conditioned on (satellite | CMAQ-cycle | nothing) inputs.  The
reference's per-step Python loops with ``.cuda()`` scatter become
``lax.scan`` bodies; boolean batch filtering becomes masked attention +
``where`` selection (``ops.recurrent.residual_masked_attention``).

Shared structure (``model.py:251-393`` MultiAir):
* TimeEncode positional features for lat/lon (per station) and
  month/day/hour — NOTE the forward feeds raw_times columns [0,1,2] which
  the eval caller slices as ``raw_times[:,:,1:]`` = (month, day, hour)
  (``evaluation_vit.py:251`` commented call shows the contract);
* encode: ``input_dim`` steps of LSTMCell over (feats, time, loc) +
  masked MHA across stations with residual, only for batch rows with >=1
  valid station;
* decode: ``output_dim`` steps with model-specific input, projection to one
  value per station, normalization inverse, ReLU.

Differences per variant:
* MultiAir: decoder input = previous satellite image + per-lead satellite
  prediction + its mean/std (``model.py:357-371``); RevIN/DishTS/Standard
  selectable; denorm via 'denorm' sliced to Korean stations;
* simulation_model: decoder input = 4-cycle CMAQ station values (24 ch)
  with the PM channels [4,10,16,22] re-normalized through the SAME RevIN
  stats (``model.py:516-529``), plus TimeEncode of (global lead + i + 1);
  always RevIN; denorm2;
* simulation_model_avg: single-cycle 6-channel decoder input, PM channel 4
  re-normalized (``model.py:679-689``);
* wo_simulation_model: zero decoder input (ablation, ``model.py:837``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from vit_grid_model_tpu.models import normalizers as N
from vit_grid_model_tpu.ops import nn as vnn
from vit_grid_model_tpu.ops.recurrent import (lstm_cell, lstm_cell_init,
                                              mha_init,
                                              residual_masked_attention)

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class StationModelSpec:
    input_dim: int = 7
    feat_dim: int = 12
    hidden_dim: int = 128
    pm25_mean: float = 0.0
    pm25_std: float = 1.0
    output_dim: int = 6
    prev_len: int = 100
    korea_stn_num: int = 0
    china_stn_num: int = 0
    normalization_method: str = "DishTS"
    variant: str = "multiair"   # multiair | simulation | simulation_avg | wo

    @property
    def total_stn_num(self) -> int:
        return self.korea_stn_num + self.china_stn_num

    @property
    def enc_dim(self) -> int:
        return self.hidden_dim // 32

    def decoder_input_dim(self) -> int:
        h16 = self.hidden_dim // 16
        if self.variant == "multiair":
            return 16
        if self.variant == "simulation":
            return (self.feat_dim // 2) * 4 + h16 * 4
        if self.variant == "simulation_avg":
            return (self.feat_dim // 2) + h16 * 4
        return h16     # wo


def station_model_init(key, spec: StationModelSpec, lats, lons,
                       dtype=jnp.float32):
    keys = jax.random.split(key, 4)
    h = spec.hidden_dim
    p = {
        "lats": jnp.asarray(lats, dtype),
        "lons": jnp.asarray(lons, dtype),
        "lat_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "lon_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "month_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "day_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "hour_encoder": N.time_encode_init(spec.enc_dim, dtype),
        "lstmcell": lstm_cell_init(keys[0], spec.feat_dim + h // 16 * 5, h,
                                   dtype),
        "decoder": lstm_cell_init(keys[1], spec.decoder_input_dim(), h,
                                  dtype),
        "last_fc": vnn.linear_init(keys[2], h, 1, dtype=dtype),
        "hidden_init": jnp.zeros((spec.total_stn_num, h), dtype),
        "cell_init": jnp.zeros((spec.total_stn_num, h), dtype),
    }
    if spec.variant == "multiair":
        p["mha"] = mha_init(keys[3], h, dtype)
        if spec.normalization_method == "RevIN":
            p["revin_layer"] = N.revin_init(spec.total_stn_num, dtype=dtype)
        if spec.normalization_method == "DishTS":
            p["dishts_layer"] = N.dishts_init(spec.total_stn_num,
                                              spec.prev_len, dtype)
    else:
        k_e, k_d = jax.random.split(keys[3])
        p["mha_e"] = mha_init(k_e, h, dtype)
        p["mha_d"] = mha_init(k_d, h, dtype)
        # these variants build a RevIN layer unconditionally
        # (``model.py:428``)
        p["revin_layer"] = N.revin_init(spec.total_stn_num, dtype=dtype)
        if spec.variant in ("simulation", "simulation_avg"):
            p["simulation_hour_encoder"] = N.time_encode_init(spec.enc_dim,
                                                              dtype)
    return p


def _location_features(p, spec: StationModelSpec, batch: int) -> Array:
    lat = N.time_encode(p["lat_encoder"], p["lats"])
    lon = N.time_encode(p["lon_encoder"], p["lons"])
    loc = jnp.concatenate([lat, lon], axis=-1)            # (stn, h/8)
    return jnp.broadcast_to(loc, (batch,) + loc.shape
                            ).reshape(batch * spec.total_stn_num, -1)


def _time_features(p, spec: StationModelSpec, raw_times: Array,
                   n_tokens: int) -> Array:
    """raw_times (B, T, 3) = (month, day, hour) -> (T, B*n_tokens, 3*h/16)."""
    b, t = raw_times.shape[0], raw_times.shape[1]
    h16 = spec.hidden_dim // 16
    feats = []
    for i, enc in enumerate(("month_encoder", "day_encoder", "hour_encoder")):
        f = N.time_encode(p[enc], raw_times[:, :, i]).reshape(b, t, h16)
        feats.append(f)
    tf = jnp.concatenate(feats, axis=-1)                  # (B, T, 3*h16)
    tf = jnp.transpose(tf, (1, 0, 2))[:, :, None, :]      # (T, B, 1, ...)
    tf = jnp.broadcast_to(tf, (t, b, n_tokens, tf.shape[-1]))
    return tf.reshape(t, b * n_tokens, -1)


def _encode(p, spec: StationModelSpec, feats: Array, masks: Array,
            time_feat: Array, loc_feats: Array, mha_key: str):
    """The shared encoder scan: (B,T,stn,F) -> final (h, c)."""
    b = feats.shape[0]
    h_dim = spec.hidden_dim
    stn = spec.total_stn_num
    h0 = jnp.broadcast_to(p["hidden_init"], (b, stn, h_dim))
    c0 = jnp.broadcast_to(p["cell_init"], (b, stn, h_dim)
                          ).reshape(b * stn, h_dim)

    feats_t = jnp.transpose(feats, (1, 0, 2, 3))          # (T, B, stn, F)
    xs = (feats_t.reshape(spec.input_dim, b * stn, -1),
          time_feat[:spec.input_dim],
          jnp.transpose(masks[:, :spec.input_dim], (1, 0, 2)))

    def body(carry, x):
        h, c = carry
        f_i, t_i, m_i = x
        inp = jnp.concatenate([f_i, t_i, loc_feats], axis=-1)
        h_new, c_new = lstm_cell(p["lstmcell"], inp,
                                 h.reshape(b * stn, h_dim), c)
        h_new = h_new.reshape(b, stn, h_dim)
        h_new = residual_masked_attention(p[mha_key], h_new, m_i)
        return (h_new, c_new), None

    (h, c), _ = jax.lax.scan(body, (h0, c0), xs)
    return h, c


def _standardize_station_pm(p, spec: StationModelSpec, feats: Array,
                            prev_vals: Array):
    """Normalize station PM2.5 (feature 0) per the configured method;
    returns (feats_with_norm_pm, denorm_fn) (``model.py:329-338``)."""
    pm = feats[:, :, :, 0]                               # (B, T_in, stn)
    method = spec.normalization_method
    if spec.variant != "multiair":
        method = "RevIN"                                  # hardwired
    if method == "RevIN":
        stats = N.revin_statistics(prev_vals, default_mean=spec.pm25_mean,
                                   default_std=spec.pm25_std)
        norm_pm = N.revin_norm(p["revin_layer"], stats, pm)
        ctx = ("revin", stats)
    elif method == "DishTS":
        norm_pm, dstats = N.dishts_norm(p["dishts_layer"], pm)
        ctx = ("dishts", dstats)
    else:
        norm_pm = (pm - spec.pm25_mean) / spec.pm25_std
        ctx = ("standard", None)
    feats = feats.at[:, :, :, 0].set(norm_pm)
    return feats, ctx


def station_model_apply(p, spec: StationModelSpec, feats: Array,
                        masks: Array, raw_times: Array, prev_vals: Array,
                        sat_outputs: Optional[Array] = None,
                        sat_inputs: Optional[Array] = None,
                        simulation: Optional[Array] = None) -> Array:
    """Forward.  feats (B, input_dim, stn, F); masks (B, T_in+T_out, stn)
    bool; raw_times (B, T_in+T_out, 3) month/day/hour; prev_vals
    (B, prev_len, stn); variant-specific extra inputs.
    Returns (B, korea_stn_num, output_dim) like the reference concat."""
    b = feats.shape[0]
    stn = spec.total_stn_num
    korea = spec.korea_stn_num
    h_dim = spec.hidden_dim

    loc_feats = _location_features(p, spec, b)
    time_feat = _time_features(p, spec, raw_times, stn)

    feats, norm_ctx = _standardize_station_pm(p, spec, feats, prev_vals)

    enc_mha = "mha" if spec.variant == "multiair" else "mha_e"
    dec_mha = "mha" if spec.variant == "multiair" else "mha_d"
    h, c = _encode(p, spec, feats, masks, time_feat, loc_feats, enc_mha)

    if spec.variant != "multiair":
        # decoder runs over Korean stations only (``model.py:510-512``)
        h = h[:, :korea]
        c = c.reshape(b, stn, h_dim)[:, :korea].reshape(b * korea, h_dim)
        n_dec = korea
    else:
        c = c
        n_dec = stn

    # ---- pre-compute decoder inputs per step ----
    if spec.variant == "multiair":
        sat_mean = jnp.mean(sat_outputs, axis=1)
        sat_std = jnp.std(sat_outputs, axis=1, ddof=1)
        sat_mean = jnp.broadcast_to(sat_mean[:, None], (b, stn, sat_mean.shape[-1])
                                    ).reshape(b * stn, -1)
        sat_std = jnp.broadcast_to(sat_std[:, None], (b, stn, sat_std.shape[-1])
                                   ).reshape(b * stn, -1)
        sat_out_flat = sat_outputs.reshape(b * stn, -1)
        sat_in_flat = sat_inputs.reshape(b * stn, -1)
        sat_in_flat = jnp.where(sat_in_flat == -1, 0.0, sat_in_flat)

    preds = []
    method, stats = norm_ctx
    for i in range(spec.output_dim):
        if spec.variant == "multiair":
            cur = jnp.concatenate(
                [sat_in_flat, sat_out_flat[:, i:i + 1],
                 sat_mean[:, i:i + 1], sat_std[:, i:i + 1]], axis=-1)
        elif spec.variant == "wo":
            cur = jnp.zeros((b * korea, h_dim // 16), feats.dtype)
        else:
            s4 = (spec.feat_dim // 2) * (4 if spec.variant == "simulation"
                                         else 1)
            sim_vals = simulation[:, :, i * s4:(i + 1) * s4]
            lead = simulation[:, :, -4:] + (i + 1)
            lead_enc = N.time_encode(p["simulation_hour_encoder"], lead
                                     ).reshape(b, korea, -1)
            # re-normalize the PM channels through the encoder's RevIN
            # stats, zero-padded to total stations (``model.py:520-529``)
            if spec.variant == "simulation":
                pm_idx = jnp.asarray([4, 10, 16, 22])
            else:
                pm_idx = jnp.asarray([4])
            pm_full = jnp.zeros((b, stn, pm_idx.shape[0]), feats.dtype)
            pm_full = pm_full.at[:, :korea].set(sim_vals[:, :, pm_idx])
            pm_norm = N.revin_norm(
                p["revin_layer"], stats,
                jnp.transpose(pm_full, (0, 2, 1)))[:, :, :korea]
            pm_norm = jnp.transpose(pm_norm, (0, 2, 1))
            sim_vals = sim_vals.at[:, :, pm_idx].set(pm_norm)
            cur = jnp.concatenate([sim_vals.reshape(b * korea, -1),
                                   lead_enc.reshape(b * korea, -1)], axis=-1)

        h_new, c = lstm_cell(p["decoder"], cur,
                             h.reshape(b * n_dec, h_dim), c)
        h = h_new.reshape(b, n_dec, h_dim)
        step_mask = masks[:, spec.input_dim + i, :n_dec]
        h = residual_masked_attention(p[dec_mha], h, step_mask)

        result = vnn.linear(p["last_fc"], h)              # (B, n_dec, 1)
        if spec.variant == "multiair":
            if method == "revin":
                pred = jnp.transpose(N.revin_denorm(
                    p["revin_layer"], stats,
                    jnp.transpose(result, (0, 2, 1)))[:, :, :korea],
                    (0, 2, 1))
            elif method == "dishts":
                pred = jnp.transpose(N.dishts_denorm(
                    p["dishts_layer"], stats,
                    jnp.transpose(result, (0, 2, 1)))[:, :, :korea],
                    (0, 2, 1))
            else:
                pred = result[:, :korea]
        else:
            pred = jnp.transpose(N.revin_denorm2(
                p["revin_layer"], stats,
                jnp.transpose(result, (0, 2, 1))), (0, 2, 1))
        preds.append(jax.nn.relu(pred))

    return jnp.concatenate(preds, axis=-1)
