"""MaxViT backbone: per-stage [MBConv -> block attention -> grid attention]
with register tokens and FiLM lead-time conditioning.

Re-design of the reference backbone (``maxvit.py:224-342``): activations
stay NHWC, window partitions are reshape/transpose pairs fused by XLA, and
all windows of a layer go through ONE batched attention call so the
(batch x window) axis makes large matrix products.  Parity quirks
reproduced:

* stage dims double per stage (``dims = 2**i * dim``, ``maxvit.py:246``) but
  the first stage pair is ``(dim, dim)`` (``maxvit.py:251``);
* MBConv ``downsample=True`` on the first block of each stage only disables
  its residual — spatial size is constant through the whole backbone
  (``maxvit.py:85`` stride is 1 on both branches);
* block-attention registers are per-window; before grid attention they are
  mean-reduced across windows and re-broadcast (``maxvit.py:326-327``);
* the attention residual (+x) includes the register tokens
  (``maxvit.py:310,334``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from vit_grid_model_tpu.ops import window as W
from vit_grid_model_tpu.ops.attention import attention, attention_init
from vit_grid_model_tpu.ops.mbconv import mbconv, mbconv_init

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class MaxViTSpec:
    dim: int
    depth: Tuple[int, ...] = (1,)
    cond_dim: int = 32
    heads: int = 32
    dim_head: int = 32
    window_size: int = 7
    mbconv_expansion_rate: int = 4
    mbconv_shrinkage_rate: float = 0.25
    dropout: float = 0.1
    num_register_tokens: int = 4
    # Inference only: fold MBConv's three BatchNorms into the adjacent
    # conv weights (pure param transform; equivalent up to one float
    # re-association per channel).  Off by default for bit-stable parity.
    fold_bn_eval: bool = False

    def layer_dims(self):
        """Yield (dim_in, dim_out, downsample) per layer, reproducing the
        reference's stage iteration (``maxvit.py:245-265``)."""
        num_stages = len(self.depth)
        dims = tuple((2 ** i) * self.dim for i in range(num_stages))
        if num_stages > 1:
            dim_pairs = tuple(zip(dims[:-1], dims[1:]))
        else:
            dim_pairs = ((self.dim, self.dim),)
        out = []
        for (layer_dim_in, layer_dim), layer_depth in zip(dim_pairs, self.depth):
            for stage_ind in range(layer_depth):
                is_first = stage_ind == 0
                stage_dim_in = layer_dim_in if is_first else layer_dim
                out.append((stage_dim_in, layer_dim, is_first))
        return out


def maxvit_init(key, spec: MaxViTSpec, dtype=jnp.float32):
    layers = []
    for dim_in, dim_out, is_first in spec.layer_dims():
        key, k_conv, k_block, k_grid, k_reg = jax.random.split(key, 5)
        layers.append({
            "conv": mbconv_init(
                k_conv, dim_in, dim_out, downsample=is_first,
                expansion_rate=spec.mbconv_expansion_rate,
                shrinkage_rate=spec.mbconv_shrinkage_rate, dtype=dtype),
            "block_attn": attention_init(
                k_block, dim_out, cond_dim=spec.cond_dim, heads=spec.heads,
                dim_head=spec.dim_head, window_size=spec.window_size,
                num_registers=spec.num_register_tokens, dtype=dtype),
            "grid_attn": attention_init(
                k_grid, dim_out, cond_dim=spec.cond_dim, heads=spec.heads,
                dim_head=spec.dim_head, window_size=spec.window_size,
                num_registers=spec.num_register_tokens, dtype=dtype),
            "register_tokens": jax.random.normal(
                k_reg, (spec.num_register_tokens, dim_out), dtype),
        })
    return {"layers": layers}


def _attend_windows(layer_p, which: str, xw: Array, registers: Array,
                    cond: Array, bias_idx: Array, spec: MaxViTSpec,
                    nwin: int, *, training: bool, key: Optional[Array]):
    """Run one attention over packed (registers ++ window tokens)."""
    tokens = jnp.concatenate([registers, xw], axis=1)   # (bw, nr + n, d)
    with jax.named_scope(which):
        out = attention(
            layer_p[which], tokens, cond, bias_idx, heads=spec.heads,
            windows_per_sample=nwin, dropout_rate=spec.dropout,
            training=training, dropout_key=key)
    tokens = out + tokens                               # residual incl. registers
    nr = spec.num_register_tokens
    return tokens[:, nr:], tokens[:, :nr]


def maxvit_apply(params, x: Array, cond: Array, spec: MaxViTSpec, *,
                 training: bool = False, rng: Optional[Array] = None,
                 collect_bn: Optional[list] = None) -> Array:
    """x: (B, H, W, C) NHWC; cond: (B, cond_dim).  H, W divisible by the
    window size (the caller pads, ``metnet3.py:324``).

    In training mode with ``collect_bn`` a list, MBConv batch-norms use batch
    statistics and append their updated running stats (one dict per layer) to
    the list — the trainer merges them back into the param pytree.
    """
    from vit_grid_model_tpu.ops.mbconv import mbconv_train

    w = spec.window_size
    nr = spec.num_register_tokens
    bias_idx = W.relative_position_indices(w, nr)
    layer_dims = spec.layer_dims()

    for li, layer_p in enumerate(params["layers"]):
        dim_in, dim_out, is_first = layer_dims[li]
        keys = (jax.random.split(rng, 3) if (training and rng is not None)
                else (None, None, None))
        if training and rng is not None:
            rng = jax.random.fold_in(rng, li + 1)

        if training and collect_bn is not None:
            x, bn_stats = mbconv_train(
                layer_p["conv"], x, dim_in=dim_in, dim_out=dim_out,
                downsample=is_first, dropout_rate=0.0, dropout_key=keys[0])
            collect_bn.append(bn_stats)
        else:
            x = mbconv(layer_p["conv"], x, dim_in=dim_in, dim_out=dim_out,
                       downsample=is_first, dropout_rate=0.0,
                       training=training, dropout_key=keys[0],
                       fold_bn=spec.fold_bn_eval and not training)

        b = x.shape[0]
        # ---- block (local-window) attention ----
        xw, dims = W.block_partition(x, w)              # (b*nx*ny, w*w, d)
        nwin = dims[1] * dims[2]
        r = jnp.broadcast_to(layer_p["register_tokens"],
                             (xw.shape[0], nr, dim_out))
        xw, r = _attend_windows(layer_p, "block_attn", xw, r, cond, bias_idx,
                                spec, nwin, training=training, key=keys[1])
        x = W.block_reverse(xw, w, dims)

        # ---- grid (strided-window) attention ----
        # registers: mean across this sample's windows, then re-broadcast
        r = r.reshape(b, nwin, nr, dim_out).mean(axis=1)     # (b, nr, d)
        xw, dims = W.grid_partition(x, w)
        nwin = dims[1] * dims[2]
        r = jnp.repeat(r, nwin, axis=0)                      # sample-major
        xw, r = _attend_windows(layer_p, "grid_attn", xw, r, cond, bias_idx,
                                spec, nwin, training=training, key=keys[2])
        x = W.grid_reverse(xw, w, dims)

    return x
