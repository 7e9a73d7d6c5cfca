"""Recurrent + masked-attention primitives for the legacy station models.

torch-semantics building blocks (``nn.LSTMCell``, single-head
``nn.MultiheadAttention`` with key_padding_mask) re-expressed as pure
functions so the reference's per-timestep Python loops become
``lax.scan``-friendly programs.

The reference updates only batch rows that have >=1 valid station
(``model.py:352-355`` boolean indexing).  Data-dependent gather/scatter is
hostile to XLA, so here attention runs for EVERY row with a masked softmax
and the row update is a ``jnp.where`` select — bit-identical results with
static shapes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from vit_grid_model_tpu.ops import nn as vnn

Array = jax.Array


# ---------------------------------------------------------------------------
# LSTM cell (torch gate order/init)
# ---------------------------------------------------------------------------

def lstm_cell_init(key, input_size: int, hidden_size: int, dtype=jnp.float32):
    """torch ``nn.LSTMCell`` params: U(-1/sqrt(H), 1/sqrt(H)) on all four.
    Weight layout (4H, in) / (4H, H), gate order i, f, g, o."""
    bound = 1.0 / math.sqrt(hidden_size)
    k = jax.random.split(key, 4)
    u = lambda kk, shape: jax.random.uniform(kk, shape, dtype, -bound, bound)
    return {
        "w_ih": u(k[0], (4 * hidden_size, input_size)),
        "w_hh": u(k[1], (4 * hidden_size, hidden_size)),
        "b_ih": u(k[2], (4 * hidden_size,)),
        "b_hh": u(k[3], (4 * hidden_size,)),
    }


def lstm_cell(p, x: Array, h: Array, c: Array) -> Tuple[Array, Array]:
    """One step: x (N, in), h/c (N, H) -> (h', c')."""
    gates = (jnp.dot(x, p["w_ih"].T, preferred_element_type=x.dtype)
             + p["b_ih"]
             + jnp.dot(h, p["w_hh"].T, preferred_element_type=x.dtype)
             + p["b_hh"])
    i, f, g, o = jnp.split(gates, 4, axis=-1)
    c_new = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
    h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
    return h_new, c_new


# ---------------------------------------------------------------------------
# single-head MHA with key padding (torch semantics)
# ---------------------------------------------------------------------------

def mha_init(key, embed_dim: int, dtype=jnp.float32):
    """torch ``nn.MultiheadAttention(embed_dim, 1)``: fused in-proj
    (3E, E) xavier-uniform, zero in-proj bias, out-proj Linear(E, E)."""
    k1, k2 = jax.random.split(key)
    bound = math.sqrt(6.0 / (3 * embed_dim + embed_dim))
    return {
        "in_proj_w": jax.random.uniform(k1, (3 * embed_dim, embed_dim),
                                        dtype, -bound, bound),
        "in_proj_b": jnp.zeros((3 * embed_dim,), dtype),
        "out_proj": {
            "w": vnn.linear_init(k2, embed_dim, embed_dim, dtype=dtype)["w"],
            "b": jnp.zeros((embed_dim,), dtype),
        },
    }


def mha_self_attention(p, x: Array,
                       key_padding_mask: Optional[Array] = None) -> Array:
    """Self-attention, batch-first: x (B, N, E);
    key_padding_mask (B, N) bool with True = EXCLUDE that key (torch
    convention).  Rows whose keys are all excluded return zeros (torch would
    produce NaN; callers discard those rows, ``model.py:352-355``)."""
    e = x.shape[-1]
    wq, wk, wv = jnp.split(p["in_proj_w"], 3, axis=0)
    bq, bk, bv = jnp.split(p["in_proj_b"], 3, axis=0)
    q = jnp.dot(x, wq.T) + bq
    k = jnp.dot(x, wk.T) + bk
    v = jnp.dot(x, wv.T) + bv
    sim = jnp.einsum("bie,bje->bij", q, k,
                     preferred_element_type=jnp.float32) / math.sqrt(e)
    if key_padding_mask is not None:
        sim = jnp.where(key_padding_mask[:, None, :], -jnp.inf, sim)
    # safe softmax: all -inf rows -> zeros instead of NaN
    m = jnp.max(sim, axis=-1, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    ex = jnp.exp(sim - m)
    denom = jnp.sum(ex, axis=-1, keepdims=True)
    attn = jnp.where(denom > 0, ex / jnp.maximum(denom, 1e-30), 0.0)
    out = jnp.einsum("bij,bje->bie", attn.astype(v.dtype), v,
                     preferred_element_type=jnp.float32).astype(v.dtype)
    return vnn.linear(p["out_proj"], out)


def residual_masked_attention(p, hidden: Array, valid: Array) -> Array:
    """The legacy models' per-step pattern (``model.py:352-355``): attend
    across stations with invalid ones excluded as keys, add residually, but
    ONLY for batch rows having at least one valid station."""
    row_has_valid = jnp.sum(valid, axis=1) > 0
    attn = mha_self_attention(p, hidden, key_padding_mask=~valid)
    updated = hidden + attn
    return jnp.where(row_has_valid[:, None, None], updated, hidden)
