"""Functional neural-net primitives, NHWC layout, params as plain pytrees.

These are the building blocks behind every model in the framework.
Design rules:

* activations are channels-last (NHWC), the layout cuDNN's convolutions and
  XLA's fusions take without a relayout;
* every primitive is a pure function ``apply(params, x, ...)`` plus an
  ``init(key, ...) -> params`` companion, so the whole model is one pytree
  and one jit-compiled program — no module objects in the compute path;
* initializers mirror torch defaults (kaiming-uniform fan-in for conv/linear,
  standard normal for embeddings) so training from scratch matches the
  reference's statistical regime, and converted checkpoints drop in directly.

Reference parity notes cite file:line into ``/root/reference/src``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array


# ---------------------------------------------------------------------------
# initializers (torch-default compatible)
# ---------------------------------------------------------------------------

def _uniform(key, shape, bound, dtype=jnp.float32):
    return jax.random.uniform(key, shape, dtype, minval=-bound, maxval=bound)


def conv_init(key, kh: int, kw: int, c_in: int, c_out: int, *, groups: int = 1,
              bias: bool = True, dtype=jnp.float32):
    """HWIO conv weights; kaiming-uniform(a=sqrt5) == U(+-1/sqrt(fan_in))."""
    fan_in = kh * kw * (c_in // groups)
    bound = 1.0 / math.sqrt(fan_in)
    kw_, kb_ = jax.random.split(key)
    p = {"w": _uniform(kw_, (kh, kw, c_in // groups, c_out), bound, dtype)}
    if bias:
        p["b"] = _uniform(kb_, (c_out,), bound, dtype)
    return p


def linear_init(key, d_in: int, d_out: int, *, bias: bool = True,
                dtype=jnp.float32):
    bound = 1.0 / math.sqrt(d_in)
    kw_, kb_ = jax.random.split(key)
    p = {"w": _uniform(kw_, (d_in, d_out), bound, dtype)}
    if bias:
        p["b"] = _uniform(kb_, (d_out,), bound, dtype)
    return p


def embedding_init(key, num: int, dim: int, dtype=jnp.float32):
    return {"table": jax.random.normal(key, (num, dim), dtype)}


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def linear(p, x: Array) -> Array:
    y = jnp.dot(x, p["w"], preferred_element_type=x.dtype)
    if "b" in p:
        y = y + p["b"]
    return y


def embedding(p, idx: Array) -> Array:
    return jnp.take(p["table"], idx, axis=0)


# ---------------------------------------------------------------------------
# convolutions (NHWC activations, HWIO weights)
# ---------------------------------------------------------------------------

def conv2d(p, x: Array, *, stride: int = 1, padding="SAME",
           groups: int = 1) -> Array:
    """2-D convolution.  ``padding`` may be "SAME", "VALID", an int, or an
    explicit ((top, bottom), (left, right)) pair — int semantics match
    torch's symmetric zero padding."""
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    y = lax.conv_general_dilated(
        x, p["w"],
        window_strides=(stride, stride),
        padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
    )
    if "b" in p:
        y = y + p["b"]
    return y


def conv2d_transpose(p, x: Array, *, stride: int = 2) -> Array:
    """Transposed conv with kernel==stride (the reference's Upsample2x,
    ``metnet3.py:88-89``).  Implemented as the gradient-conv so the weight
    layout matches a converted ``nn.ConvTranspose2d`` (IOHW -> HWIO with the
    in/out axes swapped by the converter)."""
    y = lax.conv_transpose(
        x, p["w"],
        strides=(stride, stride),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    if "b" in p:
        y = y + p["b"]
    return y


def depthwise_conv2d(p, x: Array, *, stride: int = 1, padding=1) -> Array:
    """Depthwise 3x3 used inside MBConv (``maxvit.py:91``)."""
    c = x.shape[-1]
    return conv2d(p, x, stride=stride, padding=padding, groups=c)


# ---------------------------------------------------------------------------
# normalizations
# ---------------------------------------------------------------------------

def batch_norm_init(c: int, dtype=jnp.float32):
    return {
        "scale": jnp.ones((c,), dtype),
        "bias": jnp.zeros((c,), dtype),
        "mean": jnp.zeros((c,), dtype),    # running mean (inference)
        "var": jnp.ones((c,), dtype),      # running var  (inference)
    }


def batch_norm(p, x: Array, *, training: bool = False, eps: float = 1e-5,
               momentum: float = 0.1):
    """BatchNorm over all axes but the last.  In training mode returns
    ``(y, new_stats)`` with torch-compatible running-stat updates (biased
    batch var for normalization, unbiased for the running update)."""
    if training:
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axis=axes)
        var = jnp.var(x, axis=axes)
        n = x.size // x.shape[-1]
        unbiased = var * (n / max(n - 1, 1))
        new_stats = {
            "mean": (1 - momentum) * p["mean"] + momentum * mean,
            "var": (1 - momentum) * p["var"] + momentum * unbiased,
        }
        y = (x - mean) * lax.rsqrt(var + eps) * p["scale"] + p["bias"]
        return y, new_stats
    y = (x - p["mean"]) * lax.rsqrt(p["var"] + eps) * p["scale"] + p["bias"]
    return y


def fold_bn_into_conv(conv_p, bn_p, *, eps: float = 1e-5):
    """Fold an inference-mode BatchNorm into the preceding conv's weights.

    ``BN(conv(x))`` == ``conv'(x)`` with ``w' = w * s`` and
    ``b' = (b - mean) * s + bias`` where ``s = scale / sqrt(var + eps)``.
    HWIO weights put the output channel last, so ``s`` broadcasts directly
    (this also covers depthwise convs, whose per-group output channel is
    the last axis too).  Pure XLA param transform — a standard free win for
    eval-mode MBConv (the reference keeps the BNs separate at eval,
    ``maxvit.py:87-97``; numerics equivalent up to one float re-association
    per channel, so the transform is flag-gated, see ``MetNet3Config.
    fold_bn_eval``)."""
    s = bn_p["scale"] * lax.rsqrt(bn_p["var"] + eps)
    b = conv_p["b"] if "b" in conv_p else jnp.zeros_like(bn_p["mean"])
    return {"w": conv_p["w"] * s,
            "b": (b - bn_p["mean"]) * s + bn_p["bias"]}


def chan_layer_norm_init(c: int, dtype=jnp.float32):
    return {"g": jnp.ones((c,), dtype), "b": jnp.zeros((c,), dtype)}


def chan_layer_norm(p, x: Array, *, eps: float = 1e-5) -> Array:
    """LayerNorm over the channel axis with the reference's exact recipe:
    biased variance, ``var.clamp(min=eps).rsqrt()`` — NOT ``rsqrt(var+eps)``
    (``metnet3.py:94-104``)."""
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    inv = lax.rsqrt(jnp.maximum(var, eps))
    return (x - mean) * inv * p["g"] + p["b"]


def layer_norm_init(c: int, *, affine: bool = True, dtype=jnp.float32):
    if affine:
        return {"g": jnp.ones((c,), dtype), "b": jnp.zeros((c,), dtype)}
    return {}


def layer_norm(p, x: Array, *, eps: float = 1e-5) -> Array:
    """torch ``nn.LayerNorm`` semantics: biased var, rsqrt(var + eps)."""
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    y = (x - mean) * lax.rsqrt(var + eps)
    if "g" in p:
        y = y * p["g"] + p["b"]
    return y


def group_norm_init(c: int, dtype=jnp.float32):
    return {"g": jnp.ones((c,), dtype), "b": jnp.zeros((c,), dtype)}


def group_norm(p, x: Array, *, groups: int, eps: float = 1e-5) -> Array:
    """GroupNorm (used by the SimVP conv stack, ``modules.py:12``)."""
    shape = x.shape
    c = shape[-1]
    xg = x.reshape(shape[:-1] + (groups, c // groups))
    axes = tuple(range(1, xg.ndim - 2)) + (xg.ndim - 1,)
    mean = jnp.mean(xg, axis=axes, keepdims=True)
    var = jnp.var(xg, axis=axes, keepdims=True)
    xg = (xg - mean) * lax.rsqrt(var + eps)
    return xg.reshape(shape) * p["g"] + p["b"]


def qk_rms_norm_init(heads: int, dim_head: int, dtype=jnp.float32):
    """Multi-head RMS norm for attention queries/keys (``maxvit.py:18-30``)."""
    return {"gamma": jnp.ones((heads, 1, dim_head), dtype)}


def qk_rms_norm(p, x: Array, *, eps: float = 1e-12) -> Array:
    """``F.normalize(x, dim=-1) * sqrt(d) * gamma``: l2-normalize with
    torch's max(||x||, eps) clamp, then scale.  x: (..., heads, n, d)."""
    d = x.shape[-1]
    norm = jnp.sqrt(jnp.sum(jnp.square(x), axis=-1, keepdims=True))
    x = x / jnp.maximum(norm, eps)
    return x * (d ** 0.5) * p["gamma"]


# ---------------------------------------------------------------------------
# activations / pooling
# ---------------------------------------------------------------------------

def gelu(x: Array) -> Array:
    """Exact (erf) GELU — torch ``nn.GELU()`` default."""
    return jax.nn.gelu(x, approximate=False)


def silu(x: Array) -> Array:
    return jax.nn.silu(x)


def leaky_relu(x: Array, negative_slope: float = 0.2) -> Array:
    return jax.nn.leaky_relu(x, negative_slope)


def max_pool_2x(x: Array) -> Array:
    """MaxPool2d(kernel=2, stride=2) — the MetNet3 downsample
    (``metnet3.py:86``)."""
    return lax.reduce_window(
        x, -jnp.inf, lax.max,
        window_dimensions=(1, 2, 2, 1),
        window_strides=(1, 2, 2, 1),
        padding="VALID",
    )


def global_avg_pool(x: Array) -> Array:
    """(N, H, W, C) -> (N, C) mean, the SE gate's Reduce (``maxvit.py:39``)."""
    return jnp.mean(x, axis=(1, 2))


# ---------------------------------------------------------------------------
# dropout / stochastic depth
# ---------------------------------------------------------------------------

def dropout(key: Optional[Array], x: Array, rate: float,
            training: bool) -> Array:
    if not training or rate == 0.0 or key is None:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)


def drop_sample(key: Optional[Array], x: Array, prob: float,
                training: bool) -> Array:
    """Per-sample stochastic depth.  NOTE: unreachable in the reference at
    eval (and its train-mode impl is broken — ``maxvit.py:72`` constructs
    ``torch.FloatTensor((shape,))`` which raises); provided here as the
    working equivalent for training."""
    if not training or prob == 0.0 or key is None:
        return x
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    keep = jax.random.bernoulli(key, 1.0 - prob, shape)
    return jnp.where(keep, x / (1.0 - prob), 0.0)


# ---------------------------------------------------------------------------
# composite blocks shared by models
# ---------------------------------------------------------------------------

def squeeze_excite_init(key, dim: int, shrinkage_rate: float = 0.25,
                        dtype=jnp.float32):
    """SE gate: mean-pool -> Linear -> ReLU -> Linear -> sigmoid
    (``maxvit.py:33-48``; both linears bias-free)."""
    hidden = int(dim * shrinkage_rate)
    k1, k2 = jax.random.split(key)
    return {
        "fc1": linear_init(k1, dim, hidden, bias=False, dtype=dtype),
        "fc2": linear_init(k2, hidden, dim, bias=False, dtype=dtype),
    }


def squeeze_excite(p, x: Array) -> Array:
    gate = global_avg_pool(x)
    gate = jax.nn.relu(linear(p["fc1"], gate))
    gate = jax.nn.sigmoid(linear(p["fc2"], gate))
    return x * gate[:, None, None, :]


def film_init(key, cond_dim: int, dim: int, dtype=jnp.float32):
    """FiLM conditioning head: Linear -> SiLU -> Linear -> (gamma, beta)
    (``maxvit.py:130-134``)."""
    k1, k2 = jax.random.split(key)
    return {
        "fc1": linear_init(k1, cond_dim, dim * 2, dtype=dtype),
        "fc2": linear_init(k2, dim * 2, dim * 2, dtype=dtype),
    }


def film(p, cond: Array) -> Tuple[Array, Array]:
    h = linear(p["fc2"], silu(linear(p["fc1"], cond)))
    gamma, beta = jnp.split(h, 2, axis=-1)
    return gamma, beta
