"""Windowed multi-head attention with QK-RMSNorm, relative-position bias,
register tokens and FiLM lead-time conditioning.

This is the innermost hot op of the MaxViT backbone (reference
``maxvit.py:106-219``).  Parity-critical details reproduced exactly:

* pre-norm LayerNorm has no affine when conditioned (``maxvit.py:137``);
* FiLM: ``x * gamma + beta`` with gamma/beta broadcast from the per-(sample,
  lead) cond over that sample's windows (``maxvit.py:184-187``);
* queries/keys pass through multi-head RMSNorm scaled by ``sqrt(dim_head)``;
  the constructor's ``dim_head ** -0.5`` scale is computed but NEVER applied
  (``maxvit.py:123`` vs ``:199-203``) — the RMSNorm is the only scaling;
* the bias table has ``(2w-1)^2 + 1`` rows; register rows/cols read the
  sentinel row (``maxvit.py:156-167``).

The path below is a batched dense attention over 53-token windows — one
(Bw, h, n, n) einsum pair that XLA hands to the device's matrix units.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vit_grid_model_tpu.ops import nn as vnn

Array = jax.Array


def attention_init(key, dim: int, *, cond_dim: Optional[int], heads: int,
                   dim_head: int, window_size: int, num_registers: int,
                   dtype=jnp.float32):
    dim_inner = heads * dim_head
    keys = jax.random.split(key, 5)
    p = {
        "norm": vnn.layer_norm_init(dim, affine=cond_dim is None, dtype=dtype),
        "to_qkv": vnn.linear_init(keys[0], dim, dim_inner * 3, bias=False,
                                  dtype=dtype),
        "q_norm": vnn.qk_rms_norm_init(heads, dim_head, dtype),
        "k_norm": vnn.qk_rms_norm_init(heads, dim_head, dtype),
        "to_out": vnn.linear_init(keys[1], dim_inner, dim, bias=False,
                                  dtype=dtype),
        # (2w-1)^2 + 1 rows, one per relative offset + register sentinel
        "rel_pos_bias": vnn.embedding_init(
            keys[2], (2 * window_size - 1) ** 2 + 1, heads, dtype),
    }
    if cond_dim is not None:
        p["film"] = vnn.film_init(keys[3], cond_dim, dim, dtype)
    return p


def attention(p, x: Array, cond: Optional[Array], bias_indices: Array, *,
              heads: int, windows_per_sample: int,
              dropout_rate: float = 0.0, training: bool = False,
              dropout_key: Optional[Array] = None) -> Array:
    """x: (Bw, n, dim) where Bw = B_cond * windows_per_sample (sample-major);
    cond: (B_cond, cond_dim) or None; bias_indices: (n, n) int32.

    Returns (Bw, n, dim).
    """
    bw, n, dim = x.shape

    x = vnn.layer_norm(p["norm"], x)

    if "film" in p and cond is not None:
        gamma, beta = vnn.film(p["film"], cond)          # (B_cond, dim) each
        # broadcast each sample's gamma/beta over its windows, sample-major
        gamma = jnp.repeat(gamma, windows_per_sample, axis=0)[:, None, :]
        beta = jnp.repeat(beta, windows_per_sample, axis=0)[:, None, :]
        x = x * gamma + beta

    qkv = vnn.linear(p["to_qkv"], x)                      # (Bw, n, 3*h*d)
    q, k, v = jnp.split(qkv, 3, axis=-1)

    def split_heads(t):
        return t.reshape(bw, n, heads, -1).transpose(0, 2, 1, 3)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)

    q = vnn.qk_rms_norm(p["q_norm"], q)
    k = vnn.qk_rms_norm(p["k_norm"], k)

    sim = jnp.einsum("bhid,bhjd->bhij", q, k,
                     preferred_element_type=jnp.float32)

    bias = vnn.embedding(p["rel_pos_bias"], bias_indices)  # (n, n, h)
    sim = sim + bias.transpose(2, 0, 1)[None]

    attn = jax.nn.softmax(sim, axis=-1).astype(v.dtype)
    attn = vnn.dropout(dropout_key, attn, dropout_rate, training)

    out = jnp.einsum("bhij,bhjd->bhid", attn, v,
                     preferred_element_type=jnp.float32).astype(v.dtype)
    out = out.transpose(0, 2, 1, 3).reshape(bw, n, -1)
    return vnn.linear(p["to_out"], out)
