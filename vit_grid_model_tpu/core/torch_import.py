"""Convert reference torch checkpoints into framework pytrees.

The shipped checkpoint (``check_points/simulation_vit_model_12hr.pkt``,
loaded at ``evaluation_vit.py:109``) is a ``DataParallel`` state_dict whose
keys carry a ``module.`` prefix.  This converter maps every tensor to the
corresponding slot of a ``metnet3_init``-shaped pytree, performing the layout
changes this design requires:

* conv kernels   OIHW  -> HWIO
* linear weights (out, in) -> (in, out)
* conv-transpose kernels (in, out, kh, kw) -> spatially-flipped HWIO so the
  XLA fractionally-strided convolution reproduces torch's gradient-conv
* embeddings / norm vectors pass through (ChanLayerNorm's (1,C,1,1) params
  squeeze to (C,))

No torch import is required: any mapping of name -> numpy array works.  Use
``load_torch_state_dict`` for ``.pkt`` files (needs torch installed).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import jax.numpy as jnp

from vit_grid_model_tpu.core.config import MetNet3Config


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a torch checkpoint file into {name: numpy array}."""
    import torch  # local import: torch is only needed for conversion

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def strip_data_parallel(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop the ``module.`` DataParallel prefix (``evaluation_vit.py:107``)."""
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


# ---------------------------------------------------------------------------
# tensor layout adapters
# ---------------------------------------------------------------------------

def _conv(w: np.ndarray) -> jnp.ndarray:
    """OIHW -> HWIO."""
    return jnp.asarray(np.transpose(w, (2, 3, 1, 0)))


def _conv_transpose(w: np.ndarray) -> jnp.ndarray:
    """torch ConvTranspose2d (in, out, kh, kw) -> flipped HWIO for
    ``lax.conv_transpose``'s fractionally-strided convolution."""
    w = np.flip(w, axis=(2, 3))
    return jnp.asarray(np.transpose(w, (2, 3, 0, 1)))   # (kh, kw, in, out)


def _lin(w: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.transpose(w))


def _vec(w: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.reshape(w, (-1,)))


def _bn(sd, prefix) -> dict:
    return {
        "scale": _vec(sd[f"{prefix}.weight"]),
        "bias": _vec(sd[f"{prefix}.bias"]),
        "mean": _vec(sd[f"{prefix}.running_mean"]),
        "var": _vec(sd[f"{prefix}.running_var"]),
    }


def _conv_p(sd, prefix) -> dict:
    p = {"w": _conv(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["b"] = _vec(sd[f"{prefix}.bias"])
    return p


def _lin_p(sd, prefix) -> dict:
    p = {"w": _lin(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["b"] = _vec(sd[f"{prefix}.bias"])
    return p


# ---------------------------------------------------------------------------
# module mappers
# ---------------------------------------------------------------------------

def _block(sd, prefix) -> dict:
    return {
        "proj": _conv_p(sd, f"{prefix}.proj"),
        "norm": {"g": _vec(sd[f"{prefix}.norm.g"]),
                 "b": _vec(sd[f"{prefix}.norm.b"])},
    }


def _resnet_block(sd, prefix) -> dict:
    p = {
        "block1": _block(sd, f"{prefix}.block1"),
        "block2": _block(sd, f"{prefix}.block2"),
    }
    if f"{prefix}.mlp.1.weight" in sd:           # Sequential(ReLU, Linear)
        p["mlp"] = _lin_p(sd, f"{prefix}.mlp.1")
    if f"{prefix}.res_conv.weight" in sd:
        p["res_conv"] = _conv_p(sd, f"{prefix}.res_conv")
    return p


def _resnet_blocks(sd, prefix, depth: int) -> dict:
    return {"blocks": [_resnet_block(sd, f"{prefix}.blocks.{i}")
                       for i in range(depth)]}


def _mbconv(sd, prefix) -> dict:
    """MBConv Sequential indices (``maxvit.py:87-97``): 0 expand conv, 1 BN,
    3 depthwise conv, 4 BN, 6 squeeze-excite, 7 project conv, 8 BN.  When the
    block has a residual the Sequential is wrapped in MBConvResidual and every
    name gains a ``fn.`` segment (``maxvit.py:50-59``)."""
    if f"{prefix}.fn.0.weight" in sd:
        prefix = f"{prefix}.fn"
    return {
        "expand": _conv_p(sd, f"{prefix}.0"),
        "bn1": _bn(sd, f"{prefix}.1"),
        "dw": _conv_p(sd, f"{prefix}.3"),
        "bn2": _bn(sd, f"{prefix}.4"),
        "se": {
            "fc1": _lin_p(sd, f"{prefix}.6.gate.1"),
            "fc2": _lin_p(sd, f"{prefix}.6.gate.3"),
        },
        "project": _conv_p(sd, f"{prefix}.7"),
        "bn3": _bn(sd, f"{prefix}.8"),
    }


def _attention(sd, prefix) -> dict:
    p = {
        "norm": {},
        "to_qkv": _lin_p(sd, f"{prefix}.to_qkv"),
        "q_norm": {"gamma": jnp.asarray(sd[f"{prefix}.q_norm.gamma"])},
        "k_norm": {"gamma": jnp.asarray(sd[f"{prefix}.k_norm.gamma"])},
        "to_out": _lin_p(sd, f"{prefix}.to_out.0"),
        "rel_pos_bias": {"table": jnp.asarray(sd[f"{prefix}.rel_pos_bias.weight"])},
    }
    if f"{prefix}.norm.weight" in sd:            # affine only when uncond
        p["norm"] = {"g": _vec(sd[f"{prefix}.norm.weight"]),
                     "b": _vec(sd[f"{prefix}.norm.bias"])}
    if f"{prefix}.film.0.weight" in sd:
        p["film"] = {"fc1": _lin_p(sd, f"{prefix}.film.0"),
                     "fc2": _lin_p(sd, f"{prefix}.film.2")}
    return p


def _maxvit(sd, prefix, num_layers: int) -> dict:
    layers = []
    for i in range(num_layers):
        layers.append({
            "conv": _mbconv(sd, f"{prefix}.layers.{i}.0"),
            "block_attn": _attention(sd, f"{prefix}.layers.{i}.1"),
            "grid_attn": _attention(sd, f"{prefix}.layers.{i}.2"),
            "register_tokens": jnp.asarray(sd[f"{prefix}.register_tokens.{i}"]),
        })
    return {"layers": layers}


def convert_metnet3_state_dict(sd: Dict[str, np.ndarray],
                               cfg: MetNet3Config) -> dict:
    """Map a (prefix-stripped) MetNet3 state_dict onto the
    ``metnet3_init``-shaped pytree.  Works for both ``MetNet3`` and
    ``MetNet3_with_stn_imgs`` (identical parameter sets)."""
    sd = strip_data_parallel(sd)
    num_vit_layers = sum(cfg.depth_tuple)
    params = {
        "condition_lead_time": {"table": jnp.asarray(sd["condition_lead_time.weight"])},
        "condition_model_time": [
            {"table": jnp.asarray(sd[f"condition_model_time.{i}.weight"])}
            for i in range(3)
        ],
        "resnet1": _resnet_blocks(sd, "resnet1", cfg.resnet_block_depth),
        "vit": _maxvit(sd, "vit", num_vit_layers),
        "up": {"w": _conv_transpose(sd["up.weight"]),
               "b": _vec(sd["up.bias"])},
        "resnet2": _resnet_blocks(sd, "resnet2", cfg.resnet_block_depth),
    }
    if "classifier_pm25.weight" in sd:
        params["classifier_pm25"] = _conv_p(sd, "classifier_pm25")
    if "classifier_pm10.weight" in sd:
        params["classifier_pm10"] = _conv_p(sd, "classifier_pm10")
    return params


def convert_checkpoint(path: str, cfg: MetNet3Config) -> dict:
    """One-call conversion of a ``.pkt`` file (``evaluation_vit.py:109``)."""
    return convert_metnet3_state_dict(load_torch_state_dict(path), cfg)


# ---------------------------------------------------------------------------
# legacy model family (``model.py``) converters
# ---------------------------------------------------------------------------

def _lstm(sd, prefix) -> dict:
    return {
        "w_ih": jnp.asarray(sd[f"{prefix}.weight_ih"]),
        "w_hh": jnp.asarray(sd[f"{prefix}.weight_hh"]),
        "b_ih": jnp.asarray(sd[f"{prefix}.bias_ih"]),
        "b_hh": jnp.asarray(sd[f"{prefix}.bias_hh"]),
    }


def _mha_params(sd, prefix) -> dict:
    return {
        "in_proj_w": jnp.asarray(sd[f"{prefix}.in_proj_weight"]),
        "in_proj_b": jnp.asarray(sd[f"{prefix}.in_proj_bias"]),
        "out_proj": _lin_p(sd, f"{prefix}.out_proj"),
    }


def _time_encode(sd, prefix) -> dict:
    return {"w": jnp.asarray(sd[f"{prefix}.w.weight"]),
            "b": jnp.asarray(sd[f"{prefix}.w.bias"])}


def _revin(sd, prefix) -> dict:
    p = {}
    if f"{prefix}.affine_weight" in sd:
        p = {"affine_weight": jnp.asarray(sd[f"{prefix}.affine_weight"]),
             "affine_bias": jnp.asarray(sd[f"{prefix}.affine_bias"])}
    return p


def _dishts(sd, prefix) -> dict:
    return {"reduce_mlayer": jnp.asarray(sd[f"{prefix}.reduce_mlayer"]),
            "gamma": jnp.asarray(sd[f"{prefix}.gamma"]),
            "beta": jnp.asarray(sd[f"{prefix}.beta"])}


_TIME_ENCODERS = ("lat_encoder", "lon_encoder", "month_encoder",
                  "day_encoder", "hour_encoder")


def convert_station_model(sd: Dict[str, np.ndarray], variant: str,
                          lats, lons) -> dict:
    """MultiAir / simulation_model(_avg) / wo_simulation_model state_dict ->
    ``station_model_init``-shaped pytree.  ``lats``/``lons`` are plain
    attributes in torch (not in the state_dict) so they come from the
    caller, like the reference constructors (``model.py:279-280``)."""
    sd = strip_data_parallel(sd)
    p = {
        "lats": jnp.asarray(np.asarray(lats, np.float32)),
        "lons": jnp.asarray(np.asarray(lons, np.float32)),
        "lstmcell": _lstm(sd, "lstmcell"),
        "decoder": _lstm(sd, "decoder"),
        "last_fc": _lin_p(sd, "last_fc"),
        "hidden_init": jnp.asarray(sd["hidden_init"]),
        "cell_init": jnp.asarray(sd["cell_init"]),
    }
    for enc in _TIME_ENCODERS:
        p[enc] = _time_encode(sd, enc)
    if variant == "multiair":
        p["mha"] = _mha_params(sd, "mha")
        if "revin_layer.affine_weight" in sd:
            p["revin_layer"] = _revin(sd, "revin_layer")
        if "dishts_layer.reduce_mlayer" in sd:
            p["dishts_layer"] = _dishts(sd, "dishts_layer")
    else:
        p["mha_e"] = _mha_params(sd, "mha_e")
        p["mha_d"] = _mha_params(sd, "mha_d")
        p["revin_layer"] = _revin(sd, "revin_layer")
        if "simulation_hour_encoder.w.weight" in sd:
            p["simulation_hour_encoder"] = _time_encode(
                sd, "simulation_hour_encoder")
    return p


def convert_grid_model(sd: Dict[str, np.ndarray], version: int,
                       lats, lons, cmaq_coords) -> dict:
    """simulation_grid_model{,_v2,_v3} state_dict ->
    ``grid_model_init``-shaped pytree.  v1's decode-only grid LSTM is named
    ``grid_decoder_lstm`` (``model.py:917``); v2/v3 share ``grid_lstm``."""
    sd = strip_data_parallel(sd)
    grid_lstm_name = "grid_decoder_lstm" if version == 1 else "grid_lstm"
    p = {
        "lats": jnp.asarray(np.asarray(lats, np.float32)),
        "lons": jnp.asarray(np.asarray(lons, np.float32)),
        "cmaq_coords": jnp.asarray(np.asarray(cmaq_coords, np.float32)),
        "station_encoder_lstm": _lstm(sd, "station_encoder_lstm"),
        "station_decoder_lstm": _lstm(sd, "station_decoder_lstm"),
        "grid_lstm": _lstm(sd, grid_lstm_name),
        "mha_e": _mha_params(sd, "mha_e"),
        "mha_d": _mha_params(sd, "mha_d"),
        "last_fc": _lin_p(sd, "last_fc"),
        "station_hidden_init": jnp.asarray(sd["station_hidden_init"]),
        "station_cell_init": jnp.asarray(sd["station_cell_init"]),
        "grid_hidden_init": jnp.asarray(sd["grid_hidden_init"]),
        "grid_cell_init": jnp.asarray(sd["grid_cell_init"]),
        "simulation_hour_encoder": _time_encode(sd,
                                                "simulation_hour_encoder"),
    }
    for enc in _TIME_ENCODERS:
        p[enc] = _time_encode(sd, enc)
    if "revin_layer.affine_weight" in sd:
        p["revin_layer"] = _revin(sd, "revin_layer")
    if "dishts_layer.reduce_mlayer" in sd:
        p["dishts_layer"] = _dishts(sd, "dishts_layer")
    return p


# ---------------------------------------------------------------------------
# SimVP converter (``model.py:146-249``, ``modules.py``)
# ---------------------------------------------------------------------------

def _basic_conv(sd, prefix, transpose: bool) -> dict:
    w = sd[f"{prefix}.conv.weight"]
    conv = {"w": _conv_transpose(w) if transpose else _conv(w)}
    if f"{prefix}.conv.bias" in sd:
        conv["b"] = _vec(sd[f"{prefix}.conv.bias"])
    return {"conv": conv,
            "norm": {"g": _vec(sd[f"{prefix}.norm.weight"]),
                     "b": _vec(sd[f"{prefix}.norm.bias"])}}


def _inception(sd, prefix, n_branches: int) -> dict:
    return {
        "conv1": _conv_p(sd, f"{prefix}.conv1"),
        "layers": [_basic_conv(sd, f"{prefix}.layers.{j}", transpose=False)
                   for j in range(n_branches)],
    }


def convert_simvp(sd: Dict[str, np.ndarray], n_s: int, n_t: int,
                  n_branches: int = 4) -> dict:
    """SimVP_adv state_dict -> ``simvp_init``-shaped pytree.  Decoder convs
    with stride 2 are ConvTranspose2d in torch (``modules.py:8-11``) —
    stride-1 ConvSC layers force transpose=False (``modules.py:26``)."""
    from vit_grid_model_tpu.models.simvp import stride_generator

    sd = strip_data_parallel(sd)
    enc_layers = [_basic_conv(sd, f"enc.enc.{i}.conv", transpose=False)
                  for i in range(n_s)]
    dec_strides = stride_generator(n_s, reverse=True)
    dec_layers = [_basic_conv(sd, f"dec.dec.{i}.conv",
                              transpose=dec_strides[i] == 2)
                  for i in range(n_s)]
    return {
        "enc": {"enc": enc_layers},
        "hid": {
            "enc": [_inception(sd, f"hid.enc.{i}", n_branches)
                    for i in range(n_t)],
            "dec": [_inception(sd, f"hid.dec.{i}", n_branches)
                    for i in range(n_t)],
        },
        "dec": {"dec": dec_layers, "readout": _conv_p(sd, "dec.readout")},
    }
