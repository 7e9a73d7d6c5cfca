"""Post-training int8 quantization of the resnet 3x3 convs (inference).

Plain ``lax`` code: XLA lowers the int8 x int8 -> int32 convolution to
the device's integer convolution (on an H100, cuDNN's int8 path, whose
published dense int8 rate is twice the bf16 rate).  Quantization targets
the resnet1/resnet2 ``Block`` 3x3 convs, the largest convolutions of the
model after the stem.  Whether it pays on a given card is a benchmark
question (``bench.py --dtype int8`` reports both the rate and the RMSE
delta against bf16).

Recipe (standard PTQ):
* weights: symmetric per-output-channel int8 (HWIO channel = last axis);
* activations: symmetric per-tensor int8 with a STATIC scale calibrated
  offline (one ``collect_amax`` forward over calibration batches) — a
  static scale lets XLA fuse the quantize into the producer's epilogue
  (the activation is written once, as int8) instead of paying an extra
  amax pass per call;
* accumulation in int32, dequantize + bias in f32, output in the compute
  dtype.

Flag-gated (``MetNet3Config.int8_convs``) and eval-only; the reference has
no quantized path (a throughput feature of this framework, accuracy-gated
in ``bench.py --dtype int8`` / tests/test_int8.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array


def quantize_conv(conv_p, act_amax: float):
    """Quantize one conv's params for ``conv2d_int8``.

    Returns ``{"wq" int8 HWIO, "sw" (O,) f32, "sx" () f32, "b" f32}``.
    ``act_amax`` is the calibrated max-|activation| at this conv's input.
    """
    w = jnp.asarray(conv_p["w"], jnp.float32)
    sw = jnp.max(jnp.abs(w), axis=(0, 1, 2)) / 127.0           # (O,)
    sw = jnp.maximum(sw, 1e-12)
    wq = jnp.clip(jnp.round(w / sw), -127, 127).astype(jnp.int8)
    out = {"wq": wq, "sw": sw,
           "sx": jnp.float32(max(float(act_amax), 1e-12) / 127.0)}
    if "b" in conv_p:
        out["b"] = jnp.asarray(conv_p["b"], jnp.float32)
    return out


def conv2d_int8(qp, x: Array, *, stride: int = 1, padding=1) -> Array:
    """int8 conv with static per-tensor activation scale.

    The quantize of ``x`` is a pure elementwise map (static scale), so XLA
    fuses it into the producer; the int32 accumulator is dequantized
    per-output-channel and the bias added in f32.
    """
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    inv_sx = 1.0 / qp["sx"]
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) * inv_sx),
                  -127, 127).astype(jnp.int8)
    y = lax.conv_general_dilated(
        xq, qp["wq"], window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    yf = y.astype(jnp.float32) * (qp["sx"] * qp["sw"])
    if "b" in qp:
        yf = yf + qp["b"]
    return yf.astype(x.dtype)


def record_amax(collect: dict, site: str, x: Array) -> None:
    """Accumulate max-|x| for ``site`` into the (traced) collect dict."""
    m = jnp.max(jnp.abs(x)).astype(jnp.float32)
    collect[site] = jnp.maximum(collect[site], m) if site in collect else m


def _resolve_block(params, site: str):
    """'resnet1.0.block1' -> params['resnet1']['blocks'][0]['block1']."""
    stage, idx, block = site.split(".")
    return params[stage]["blocks"][int(idx)][block]


def attach_int8_sidecars(params, amax: dict):
    """Return a copy of ``params`` with an int8 sidecar ('proj_q') next to
    each calibrated Block conv.  ``amax`` maps site keys (as produced by
    the ``collect_amax`` forward) to calibrated activation amax values."""
    params = jax.tree.map(lambda a: a, params)     # shallow-ish copy
    for site, m in amax.items():
        node = _resolve_block(params, site)
        node["proj_q"] = quantize_conv(node["proj"], float(m))
    return params


#: the first block's first conv consumes the raw (T*C)-channel CMAQ stack,
#: whose un-standardized PM planes have a far wider dynamic range than the
#: inner activations — per-tensor int8 there costs accuracy for a conv the
#: fused stem doesn't even run per-lead.  Excluded by default.
DEFAULT_SKIP = frozenset({"resnet1.0.block1"})


def quantize_metnet3_int8(params, cfg, calibration_batches,
                          skip=DEFAULT_SKIP):
    """Calibrate + quantize: run ``collect_amax`` forwards over
    ``calibration_batches`` (iterable of (x, timestamps)) and attach int8
    sidecars for every resnet Block conv the int8 path uses (minus
    ``skip``).

    The returned params run unchanged under ``int8_convs=False`` (sidecars
    are ignored) and take the int8 conv path under ``int8_convs=True``.
    """
    from vit_grid_model_tpu.models.metnet3 import metnet3_apply

    @jax.jit
    def collect(p, a, b):
        col = {}
        metnet3_apply(p, a, b, cfg, collect_amax=col)
        return col

    amax: dict = {}
    for x, ts in calibration_batches:
        got = jax.device_get(collect(params, x, ts))
        for k, v in got.items():
            if k not in skip:
                amax[k] = max(amax.get(k, 0.0), float(v))
    return attach_int8_sidecars(params, amax)
