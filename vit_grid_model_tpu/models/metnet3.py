"""MetNet3: pad -> resnet -> downsample -> MaxViT -> upsample -> resnet ->
1x1 head, with per-lead-time batch expansion and FiLM conditioning.

Re-design of the reference grid model (``metnet3.py:191-505``) and
its station-image variant (``metnet3.py:518-834``).  The whole forward is one
jit-compiled NHWC program; the per-lead batch expansion (``repeat_interleave``,
``metnet3.py:383``) becomes a leading (B*L) axis that shards cleanly over a
data mesh.

Parity-critical quirks reproduced exactly (SURVEY.md §2.4):

#7  input repeated L times sample-major; lead times ``1..L`` tiled per sample
    (``metnet3.py:382-383,407``);
#8  pad to multiple of 14, centered (left=w//2 etc., ``metnet3.py:324-333``);
#9  PM2.5 cycle channels [4,10,16,22] standardized inside forward with the
    global mean/std, outputs de-standardized (``metnet3.py:356-380,428-429``);
#10 conditioning reads raw-times row 6 regardless of input_dim
    (``metnet3.py:405``);
#11 month/day/hour embeddings concatenated along dim 0 then viewed as
    channels — the resulting channel scrambling is reproduced bit-exactly
    (``metnet3.py:395-401``);
plus the resnet FiLM recipe (ReLU on cond before the linear,
``metnet3.py:140-143``) and ChanLayerNorm's clamped-variance rsqrt.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from vit_grid_model_tpu.core.config import MetNet3Config
from vit_grid_model_tpu.models.maxvit import MaxViTSpec, maxvit_apply, maxvit_init
from vit_grid_model_tpu.ops import nn as vnn

Array = jax.Array


# ---------------------------------------------------------------------------
# conditionable resnet blocks (reference ``metnet3.py:110-187``)
# ---------------------------------------------------------------------------

def _block_init(key, dim_in, dim_out, dtype):
    return {
        "proj": vnn.conv_init(key, 3, 3, dim_in, dim_out, dtype=dtype),
        "norm": vnn.chan_layer_norm_init(dim_out, dtype),
    }


def _block_apply(p, x, scale_shift=None, *, int8=False, collect_amax=None,
                 site=None):
    """``int8``: take the quantized conv sidecar when present (PTQ path,
    ``ops/quantize.py``).  ``collect_amax``: calibration hook — record
    max-|input| for this conv under ``site``."""
    if collect_amax is not None and site is not None:
        from vit_grid_model_tpu.ops.quantize import record_amax

        record_amax(collect_amax, site, x)
    if int8 and "proj_q" in p:
        from vit_grid_model_tpu.ops.quantize import conv2d_int8

        x = conv2d_int8(p["proj_q"], x, padding=1)
    else:
        x = vnn.conv2d(p["proj"], x, padding=1)
    x = vnn.chan_layer_norm(p["norm"], x)
    if scale_shift is not None:
        scale, shift = scale_shift
        x = x * (scale + 1.0) + shift
    return jax.nn.relu(x)


def resnet_block_init(key, dim_in, dim_out, cond_dim=None, dtype=jnp.float32):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    p = {
        "block1": _block_init(k1, dim_in, dim_out, dtype),
        "block2": _block_init(k2, dim_out, dim_out, dtype),
    }
    if cond_dim is not None:
        # reference: nn.Sequential(nn.ReLU(), nn.Linear(cond_dim, dim_out*2))
        p["mlp"] = vnn.linear_init(k3, cond_dim, dim_out * 2, dtype=dtype)
    if dim_in != dim_out:
        p["res_conv"] = vnn.conv_init(k4, 1, 1, dim_in, dim_out, dtype=dtype)
    return p


def resnet_block_apply(p, x, cond=None, *, int8=False, collect_amax=None,
                       site=None):
    scale_shift = None
    if "mlp" in p and cond is not None:
        c = vnn.linear(p["mlp"], jax.nn.relu(cond))        # (B, 2*dim_out)
        scale, shift = jnp.split(c, 2, axis=-1)
        scale_shift = (scale[:, None, None, :], shift[:, None, None, :])
    qkw = lambda blk: dict(int8=int8, collect_amax=collect_amax,
                           site=f"{site}.{blk}" if site else None)
    h = _block_apply(p["block1"], x, scale_shift, **qkw("block1"))
    h = _block_apply(p["block2"], h, **qkw("block2"))
    res = vnn.conv2d(p["res_conv"], x, padding="VALID") if "res_conv" in p else x
    return h + res


def resnet_blocks_init(key, dim_in, dim_out, depth, cond_dim=None,
                       dtype=jnp.float32):
    blocks, curr = [], dim_in
    for _ in range(depth):
        key, sub = jax.random.split(key)
        blocks.append(resnet_block_init(sub, curr, dim_out, cond_dim, dtype))
        curr = dim_out
    return {"blocks": blocks}


def resnet_blocks_apply(p, x, cond=None, *, int8=False, collect_amax=None,
                        site=None):
    for i, bp in enumerate(p["blocks"]):
        x = resnet_block_apply(bp, x, cond, int8=int8,
                               collect_amax=collect_amax,
                               site=f"{site}.{i}" if site else None)
    return x


# ---------------------------------------------------------------------------
# padding helpers (reference ``metnet3.py:324-337``)
# ---------------------------------------------------------------------------

def pad_values(h: int, w: int, pad_size: int = 14) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) zero padding centering (h, w) into the next
    multiple of ``pad_size``."""
    pad_h = (pad_size - h) % pad_size
    pad_w = (pad_size - w) % pad_size
    return pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2


def pad_hw(x: Array, pad_size: int = 14) -> Tuple[Array, Tuple[int, int, int, int]]:
    """Pad the trailing-but-one (H) and trailing (W) axes of an NHWC tensor."""
    l, r, t, b = pad_values(x.shape[1], x.shape[2], pad_size)
    cfg = [(0, 0)] * x.ndim
    cfg[1] = (t, b)
    cfg[2] = (l, r)
    return jnp.pad(x, cfg), (l, r, t, b)


def unpad_hw(x: Array, pv: Tuple[int, int, int, int]) -> Array:
    l, r, t, b = pv
    return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :]


# ---------------------------------------------------------------------------
# MetNet3
# ---------------------------------------------------------------------------

def _vit_spec(cfg: MetNet3Config) -> MaxViTSpec:
    return MaxViTSpec(
        dim=cfg.n_start_channels,
        depth=cfg.depth_tuple,
        cond_dim=cfg.lead_time_emb_dim,
        heads=cfg.n_heads,
        dim_head=cfg.dim_head,
        window_size=cfg.vit_window_size,
        mbconv_expansion_rate=cfg.mbconv_expansion_rate,
        mbconv_shrinkage_rate=cfg.mbconv_shrinkage_rate,
        dropout=cfg.dropout,
        num_register_tokens=cfg.num_register_tokens,
        fold_bn_eval=cfg.fold_bn_eval,
    )


def metnet3_init(key, cfg: MetNet3Config, dtype=jnp.float32):
    keys = jax.random.split(key, 8)
    n_in = cfg.n_input_channels
    if cfg.concat_time_to_input:
        n_in = n_in + cfg.lead_time_emb_dim + cfg.model_time_emb_dim * 3
    params = {
        "condition_lead_time": vnn.embedding_init(
            keys[0], cfg.end_lead_time + 1, cfg.lead_time_emb_dim, dtype),
        "condition_model_time": [
            vnn.embedding_init(keys[1], 12 + 1, cfg.model_time_emb_dim, dtype),
            vnn.embedding_init(keys[2], 31 + 1, cfg.model_time_emb_dim, dtype),
            vnn.embedding_init(keys[3], 24 + 1, cfg.model_time_emb_dim, dtype),
        ],
        "resnet1": resnet_blocks_init(
            keys[4], n_in, cfg.n_start_channels, cfg.resnet_block_depth,
            cfg.lead_time_emb_dim, dtype),
        "vit": maxvit_init(keys[5], _vit_spec(cfg), dtype),
        "up": vnn.conv_init(keys[6], 2, 2, cfg.n_start_channels,
                            cfg.n_start_channels, dtype=dtype),
        "resnet2": resnet_blocks_init(
            keys[7], cfg.n_start_channels, cfg.n_start_channels,
            cfg.resnet_block_depth, cfg.lead_time_emb_dim, dtype),
    }
    key2 = jax.random.fold_in(key, 99)
    if cfg.pm25:
        # live reference head: 1-channel regression (``metnet3.py:306``);
        # with pm25_class_head, the earlier documented class head instead
        # (len(boundaries)+1 logits, ``metnet3.py:438-441``)
        n_out = (len(cfg.pm25_boundaries) + 1 if cfg.pm25_class_head else 1)
        params["classifier_pm25"] = vnn.conv_init(
            key2, 1, 1, cfg.n_start_channels, n_out, dtype=dtype)
        if cfg.direct_regional:
            # Conv1x1 -> flatten -> Linear(H*W, 19) (``metnet3.py:308-312``)
            ka, kb = jax.random.split(jax.random.fold_in(key2, 7))
            params["regr_regional_pm25"] = {
                "conv": vnn.conv_init(ka, 1, 1, cfg.n_start_channels, 1,
                                      dtype=dtype),
                "fc": vnn.linear_init(
                    kb, cfg.input_height * cfg.input_width, 19, dtype=dtype),
            }
    if cfg.pm10:
        params["classifier_pm10"] = vnn.conv_init(
            jax.random.fold_in(key2, 1), 1, 1, cfg.n_start_channels,
            len(cfg.pm10_boundaries) + 1, dtype=dtype)
        if cfg.direct_regional:
            ka, kb = jax.random.split(jax.random.fold_in(key2, 8))
            params["regr_regional_pm10"] = {
                "conv": vnn.conv_init(ka, 1, 1, cfg.n_start_channels, 1,
                                      dtype=dtype),
                "fc": vnn.linear_init(
                    kb, cfg.input_height * cfg.input_width, 19, dtype=dtype),
            }
    return params


def standardize_pm_channels(x: Array, cfg: MetNet3Config) -> Array:
    """Standardize the four daily-cycle PM2.5 planes (and, for the
    station-image variant, the extra observation channel) inside forward —
    other species were standardized by the dataset (``metnet3.py:356-380``,
    ``dataset.py:861-866``)."""
    if cfg.normalization_method != "Standard":
        return x
    idx = list(cfg.pm25_channel_indices)
    if cfg.stn_img_channel is not None:
        idx = idx + [cfg.stn_img_channel]        # ``metnet3.py:701``
    idx = jnp.asarray(idx)
    planes = (x[:, :, idx] - cfg.pm25_mean) / cfg.pm25_std
    return x.at[:, :, idx].set(planes)


def standardize_pm_channels_nhwc(x: Array, cfg: MetNet3Config,
                                 pv: Tuple[int, int, int, int]) -> Array:
    """``standardize_pm_channels`` for the host-prepared NHWC layout
    (``cfg.nhwc_input``): x is (B, Hp, Wp, T*C), already zero-padded, PM
    channels raw.  The padded border must STAY zero (the standard path
    standardizes before padding), so the standardized value is selected
    only on (PM fused channel) x (interior pixel) lanes.  Same elementwise
    ``(x - mean) / std`` as the standard path => bit-identical values on
    the selected lanes (pinned by tests/test_nhwc_input.py)."""
    if cfg.normalization_method != "Standard":
        return x
    T, C = cfg.window_size, cfg.n_variables
    idx = list(cfg.pm25_channel_indices)
    if cfg.stn_img_channel is not None:
        idx.append(cfg.stn_img_channel)          # ``metnet3.py:701``
    l, r, tp, bp = pv
    hp, wp = x.shape[1], x.shape[2]
    # mask built ON DEVICE from iota comparisons so it fuses into the
    # elementwise select (advisor r4: the previous host-built bool array
    # baked a ~3.5 MB constant into every compiled executable at flagship
    # geometry)
    shape = (hp, wp, T * C)
    hh = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    ww = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    cc = jax.lax.broadcasted_iota(jnp.int32, shape, 2) % C
    interior = (hh >= tp) & (hh < hp - bp) & (ww >= l) & (ww < wp - r)
    chan = cc == idx[0]
    for c in idx[1:]:
        chan = chan | (cc == c)
    return jnp.where(interior & chan, (x - cfg.pm25_mean) / cfg.pm25_std, x)


def _condition_time(params, cfg: MetNet3Config, target_time: Array,
                    bl: int) -> Array:
    """Build the 5 constant conditioning channels per (sample, lead), with the
    reference's dim-0-concat scrambling of the month/day/hour embeddings
    (quirk #11, ``metnet3.py:389-402``).

    target_time: (B*L, 5) rows of (year, month, day, hour, lead_time), the
    tensor the reference assembles at ``metnet3.py:405-409``.
    Returns (B*L, lead_emb_dim + 3*model_time_emb_dim).
    """
    lead_emb = vnn.embedding(params["condition_lead_time"],
                             target_time[:, -1].astype(jnp.int32))
    model_time = target_time[:, 1:-1].astype(jnp.int32)           # (BL, 3) m/d/h
    embs = [vnn.embedding(params["condition_model_time"][i], model_time[:, i])
            for i in range(3)]                                    # (BL, e) each
    # torch.cat along dim 0 then .view(B*L, -1): row i of the result takes
    # flat elements [3e*i : 3e*(i+1)] of the stacked matrix — reproduce the
    # scrambling exactly rather than concatenating along features.
    scrambled = jnp.concatenate(embs, axis=0).reshape(bl, -1)     # (BL, 3e)
    return jnp.concatenate([lead_emb, scrambled], axis=-1)


def _fused_lead_stem(params, cfg: MetNet3Config, x: Array, time_feats: Array,
                     cond: Array, B: int, L: int, *, int8: bool = False,
                     collect_amax: Optional[dict] = None) -> Array:
    """Lead-factorized stem: the network input is the SAME (T*C)-channel
    stack for all L leads of a sample — only the 5 constant conditioning
    channels and the FiLM cond differ (``metnet3.py:383-416``).  The first
    resnet block's 3x3 conv is linear, so

        conv(concat(x, t)) == conv_x(x) + conv_t(t)

    where ``conv_x`` over the shared channels runs ONCE per sample (an L-fold
    FLOP cut on the most expensive conv of the model), and ``conv_t`` over
    spatially-constant channels reduces to ``einsum(c, K)`` with the
    border-aware kernel-integral maps ``K[h, w, j, o] = conv(ones)``.

    Exact up to float re-association (validated to ~1e-5 relative by
    tests/test_fused_stem.py); disabled by default for bit parity.
    """
    block1 = params["resnet1"]["blocks"][0]
    w = block1["block1"]["proj"]["w"]                     # (3, 3, C_in, O)
    n_time = time_feats.shape[-1]
    n_shared = w.shape[2] - n_time
    w_shared, w_time = w[:, :, :n_shared], w[:, :, n_shared:]

    Hp, Wp = x.shape[1], x.shape[2]
    # shared 3x3 conv once per sample, then expand to (B*L, ...)
    y_shared = vnn.conv2d({"w": w_shared, "b": block1["block1"]["proj"]["b"]},
                          x, padding=1)
    y = jnp.repeat(y_shared, L, axis=0)
    # border-aware integral of the time-channel kernels: conv of ones
    ones = jnp.ones((1, Hp, Wp, 1), x.dtype)
    k_maps = vnn.conv2d(
        {"w": w_time.transpose(0, 1, 3, 2).reshape(3, 3, 1, -1)},
        ones, padding=1)                                  # (1, H, W, O*J)
    k_maps = k_maps.reshape(Hp, Wp, w.shape[3], n_time)
    y = y + jnp.einsum("bj,hwoj->bhwo", time_feats, k_maps,
                       preferred_element_type=x.dtype)

    # finish block1 exactly as resnet_block_apply does
    scale_shift = None
    if "mlp" in block1:
        c = vnn.linear(block1["mlp"], jax.nn.relu(cond))
        scale, shift = jnp.split(c, 2, axis=-1)
        scale_shift = (scale[:, None, None, :], shift[:, None, None, :])
    h = vnn.chan_layer_norm(block1["block1"]["norm"], y)
    if scale_shift is not None:
        h = h * (scale_shift[0] + 1.0) + scale_shift[1]
    h = jax.nn.relu(h)
    h = _block_apply(block1["block2"], h, int8=int8,
                     collect_amax=collect_amax, site="resnet1.0.block2")

    # residual 1x1 conv 605->128: same shared/time split (no borders)
    res_w = block1["res_conv"]["w"][0, 0]                 # (C_in, O)
    res_shared = jnp.einsum("bhwc,co->bhwo", x, res_w[:n_shared],
                            preferred_element_type=x.dtype)
    res = jnp.repeat(res_shared, L, axis=0)
    res = res + (time_feats @ res_w[n_shared:])[:, None, None, :]
    res = res + block1["res_conv"]["b"]
    out = h + res

    # remaining resnet1 blocks run per-(sample, lead) as usual
    for i, bp in enumerate(params["resnet1"]["blocks"][1:], start=1):
        out = resnet_block_apply(bp, out, cond, int8=int8,
                                 collect_amax=collect_amax,
                                 site=f"resnet1.{i}")
    return out


def metnet3_apply(params, x: Array, timestamps: Array, cfg: MetNet3Config, *,
                  training: bool = False, rng: Optional[Array] = None,
                  return_features: bool = False,
                  collect_bn: Optional[list] = None,
                  collect_amax: Optional[dict] = None) -> Array:
    """Forward pass.

    x:          (B, T, C, H, W) float — the CMAQ stack (T = window_size,
                C = n_variables), matching the reference eval contract
                (``evaluation_vit.py:248-250``).  With ``cfg.nhwc_input``:
                (B, Hp, Wp, T*C) instead — host-prepared device layout
                (channels-last, zero-padded, compute dtype, PM raw; see
                ``data/assembly.py::sim_stack_to_nhwc_input``).
    timestamps: (B, T', 4) raw (year, month, day, hour) rows; row 6 is used
                (quirk #10).
    Returns (B, L, H, W) PM2.5 fields (de-standardized).
    """
    B = x.shape[0]
    L = cfg.end_lead_time
    dtype = jnp.dtype(cfg.compute_dtype)
    if dtype != jnp.float32:
        # throughput mode: run the whole network in bf16 (weights + acts);
        # matmul accumulation stays f32 via preferred_element_type, and the
        # head output is cast back to f32 before de-standardization.
        # int8 sidecars ('proj_q': quantized weights + f32 scales/bias,
        # ops/quantize.py) are left untouched — bf16-rounding the dequant
        # scales would add a systematic per-channel gain error.
        def _cast(path, a):
            if any(getattr(k, "key", None) == "proj_q" for k in path):
                return a
            return (a.astype(dtype)
                    if hasattr(a, "dtype") and a.dtype == jnp.float32 else a)
        params = jax.tree_util.tree_map_with_path(_cast, params)

    lead_times = jnp.tile(jnp.arange(1, L + 1), B)                 # (BL,)
    cond = vnn.embedding(params["condition_lead_time"], lead_times)

    if cfg.nhwc_input:
        # host-prepared device layout: (B, Hp, Wp, T*C) channels-last,
        # zero-padded to pad_multiple, compute dtype, PM channels raw
        # (data/assembly.py::sim_stack_to_nhwc_input) — skips the
        # (B,T,C,H,W)->NHWC relayout on the device
        H, Wd = cfg.input_height, cfg.input_width
        l_, r_, t_, b_ = pad_values(H, Wd, cfg.pad_multiple)
        pv = (l_, r_, t_, b_)
        expect = (cfg.input_height + t_ + b_, cfg.input_width + l_ + r_,
                  cfg.window_size * cfg.n_variables)
        if tuple(x.shape[1:]) != expect:
            raise ValueError(f"nhwc_input expects (B,{expect[0]},{expect[1]},"
                             f"{expect[2]}), got {x.shape}")
        x = standardize_pm_channels_nhwc(x.astype(dtype), cfg, pv)
    else:
        _, T, C, H, Wd = x.shape
        x = standardize_pm_channels(x, cfg)
        # NHWC with fused (T*C) channel axis, padded (no lead repeat yet)
        x = x.reshape(B, T * C, H, Wd).transpose(0, 2, 3, 1)
        x, pv = pad_hw(x, cfg.pad_multiple)
    Hp, Wp = x.shape[1], x.shape[2]

    time_feats = None
    if cfg.concat_time_to_input:
        ts6 = jnp.repeat(timestamps[:, 6, :], L, axis=0)           # (BL, 4)
        # append the lead column the reference concatenates (``metnet3.py:409``)
        ts6 = jnp.concatenate(
            [ts6, lead_times[:, None].astype(ts6.dtype)], axis=-1)  # (BL, 5)
        time_feats = _condition_time(params, cfg, ts6, B * L)       # (BL, 5)

    x = x.astype(dtype)
    cond = cond.astype(dtype)

    int8 = cfg.int8_convs and not training
    if cfg.fuse_lead_stem and cfg.concat_time_to_input:
        out = _fused_lead_stem(params, cfg, x, time_feats.astype(dtype),
                               cond, B, L, int8=int8,
                               collect_amax=collect_amax)
    else:
        # per-lead batch expansion, sample-major (B*L), the reference's
        # repeat_interleave (``metnet3.py:383``)
        x = jnp.repeat(x, L, axis=0)
        if time_feats is not None:
            time_maps = jnp.broadcast_to(
                time_feats[:, None, None, :],
                (B * L, Hp, Wp, time_feats.shape[-1]))
            x = jnp.concatenate([x, time_maps.astype(x.dtype)], axis=-1)
        out = resnet_blocks_apply(params["resnet1"], x, cond, int8=int8,
                                  collect_amax=collect_amax, site="resnet1")
    out = vnn.max_pool_2x(out)
    out = maxvit_apply(params["vit"], out, cond, _vit_spec(cfg),
                       training=training, rng=rng, collect_bn=collect_bn)
    out = vnn.conv2d_transpose(params["up"], out, stride=2)
    out = resnet_blocks_apply(params["resnet2"], out, cond, int8=int8,
                              collect_amax=collect_amax, site="resnet2")
    out = unpad_hw(out, pv)                                        # (BL,H,W,ch)
    if return_features:
        return out

    preds = vnn.conv2d(params["classifier_pm25"], out, padding="VALID")
    preds = preds[..., 0].reshape(B, L, H, Wd).astype(jnp.float32)
    if cfg.normalization_method == "Standard":
        preds = preds * cfg.pm25_std + cfg.pm25_mean
    return preds


def metnet3_class_outputs(params, x: Array, timestamps: Array,
                          cfg: MetNet3Config, *,
                          labels_pm25: Optional[Array] = None,
                          region_targets_pm25: Optional[Array] = None,
                          labels_pm10: Optional[Array] = None,
                          region_targets_pm10: Optional[Array] = None,
                          training: bool = False,
                          rng: Optional[Array] = None) -> dict:
    """The reference's documented class-head training contract
    (``metnet3.py:432-490``, commented out there): per-cell class logits,
    bucketized cross-entropy with NaN targets masked, midpoint-decoded
    continuous predictions, and optional regional regression heads
    (detached from the backbone when ``ignore_backbone``).

    Use ``MetNet3Config(pm25_class_head=True)`` (and/or ``pm10=True``) so
    the heads emit class logits.  Returns a dict of losses/outputs shaped
    like the reference's OrderedDict.
    """
    from vit_grid_model_tpu.models.classification import categorical_to_continuous
    from vit_grid_model_tpu.train import losses as L

    feats = metnet3_apply(params, x, timestamps, cfg, training=training,
                          rng=rng, return_features=True)   # (BL, H, W, ch)
    ret = {}

    def head(suffix, boundaries, labels, region_targets):
        logits = vnn.conv2d(params[f"classifier_{suffix}"], feats,
                            padding="VALID")
        ret[f"logits_{suffix}"] = logits
        loss = 0.0
        if labels is not None:
            loss = L.pm_class_cross_entropy(logits, labels, boundaries)
            ret[f"loss_{suffix}"] = loss
        classes = jnp.argmax(logits, axis=-1)
        ret[f"predicted_{suffix}"] = categorical_to_continuous(
            classes, boundaries)
        regr_loss = 0.0
        reg_name = f"regr_regional_{suffix}"
        if cfg.direct_regional and reg_name in params:
            src = jax.lax.stop_gradient(feats) if cfg.ignore_backbone \
                else feats
            r = vnn.conv2d(params[reg_name]["conv"], src, padding="VALID")
            r = vnn.linear(params[reg_name]["fc"],
                           r.reshape(r.shape[0], -1))
            ret[f"region_preds_{suffix}"] = r
            if region_targets is not None:
                regr_loss = L.regional_mse_loss(r, region_targets)
                ret[f"regr_loss_{suffix}"] = regr_loss
        return loss + regr_loss

    total = 0.0
    if cfg.pm25 and cfg.pm25_class_head:
        total = total + head("pm25", cfg.pm25_boundaries, labels_pm25,
                             region_targets_pm25)
    if cfg.pm10 and "classifier_pm10" in params:
        total = total + head("pm10", cfg.pm10_boundaries, labels_pm10,
                             region_targets_pm10)
    ret["loss"] = total
    return ret


def get_ignore_keys_for_eval(cfg: MetNet3Config) -> list:
    """Output keys to drop at eval time (reference ``metnet3.py:492-505``)."""
    keys = []
    if cfg.pm25:
        keys += ["loss_pm25", "logits_pm25"]
        if cfg.direct_regional:
            keys += ["regr_loss_pm25"]
    if cfg.pm10:
        keys += ["loss_pm10", "logits_pm10"]
        if cfg.direct_regional:
            keys += ["regr_loss_pm10"]
    return keys
