"""``ops/attention.py`` against a plain per-window, per-head float64
reference, its gradient, its dropout, and the affine LayerNorm it uses when
unconditioned."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.test_util import check_grads

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.ops.attention import attention, attention_init
from vit_grid_model_tpu.ops.window import relative_position_indices

WINDOW, REGISTERS = 7, 4                # 7*7 + 4 = 53 tokens per window
N_TOK = WINDOW * WINDOW + REGISTERS
COND_DIM = 2


def _setup(dim, heads, dim_head, *, cond=True, windows=6, per_sample=3,
           n_tok=N_TOK, window=WINDOW, registers=REGISTERS, seed=0):
    k = jax.random.split(jax.random.PRNGKey(seed), 6)
    p = attention_init(k[0], dim, cond_dim=COND_DIM if cond else None,
                       heads=heads, dim_head=dim_head, window_size=window,
                       num_registers=registers)
    # non-trivial QK-RMSNorm gains and LayerNorm affine
    p["q_norm"]["gamma"] = 1.0 + 0.3 * jax.random.normal(
        k[1], p["q_norm"]["gamma"].shape)
    p["k_norm"]["gamma"] = 1.0 + 0.3 * jax.random.normal(
        k[2], p["k_norm"]["gamma"].shape)
    if not cond:
        p["norm"] = {"g": 1.0 + 0.3 * jax.random.normal(k[3], (dim,)),
                     "b": 0.3 * jax.random.normal(k[4], (dim,))}
    x = jax.random.normal(k[5], (windows, n_tok, dim))
    c = (jax.random.normal(jax.random.fold_in(k[5], 1),
                           (windows // per_sample, COND_DIM))
         if cond else None)
    bias_idx = relative_position_indices(window, registers)
    return p, x, c, bias_idx


def reference_attention(p, x, cond, bias_idx, heads, per_sample):
    """One window and one head at a time, in float64 numpy."""
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    x = np.asarray(x, np.float64)
    bias = np.asarray(p["rel_pos_bias"]["table"])[np.asarray(bias_idx)]
    out = np.empty_like(x)
    for w in range(x.shape[0]):
        t = x[w]
        mu = t.mean(-1, keepdims=True)
        t = (t - mu) / np.sqrt(((t - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
        if "g" in p["norm"]:
            t = t * p["norm"]["g"] + p["norm"]["b"]
        if "film" in p and cond is not None:
            c = np.asarray(cond, np.float64)[w // per_sample]
            f1, f2 = p["film"]["fc1"], p["film"]["fc2"]
            h = c @ f1["w"] + f1["b"]
            h = (h / (1.0 + np.exp(-h))) @ f2["w"] + f2["b"]
            gamma, beta = np.split(h, 2)
            t = t * gamma + beta
        q, k, v = np.split(t @ p["to_qkv"]["w"], 3, axis=-1)
        d = q.shape[-1] // heads
        heads_out = []
        for h in range(heads):
            sl = slice(h * d, (h + 1) * d)
            qh, kh, vh = q[:, sl], k[:, sl], v[:, sl]
            qh = (qh / np.maximum(np.linalg.norm(qh, axis=-1, keepdims=True),
                                  1e-12) * np.sqrt(d)
                  * p["q_norm"]["gamma"][h, 0])
            kh = (kh / np.maximum(np.linalg.norm(kh, axis=-1, keepdims=True),
                                  1e-12) * np.sqrt(d)
                  * p["k_norm"]["gamma"][h, 0])
            s = qh @ kh.T + bias[:, :, h]
            a = np.exp(s - s.max(-1, keepdims=True))
            a /= a.sum(-1, keepdims=True)
            heads_out.append(a @ vh)
        out[w] = np.concatenate(heads_out, -1) @ p["to_out"]["w"]
    return out


def _run(p, x, c, bias_idx, heads, per_sample, **kw):
    return jax.jit(lambda p_, x_, c_: attention(
        p_, x_, c_, bias_idx, heads=heads, windows_per_sample=per_sample,
        **kw))(p, x, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,heads,dim_head", [(32, 4, 8), (128, 32, 32)],
                         ids=["4x8", "32x32"])
def test_attention_matches_reference(dim, heads, dim_head, dtype):
    p, x, c, bias_idx = _setup(dim, heads, dim_head)
    want = reference_attention(p, x, c, bias_idx, heads, 3)
    cast = lambda a: a.astype(dtype)                      # noqa: E731
    got = np.asarray(_run(jax.tree.map(cast, p), cast(x), cast(c),
                          bias_idx, heads, 3), np.float64)
    assert got.shape == (6, N_TOK, dim)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    # f32 at "highest" precision: summation order only; bf16: 8-bit
    # mantissa operands through two products and a softmax
    assert rel < (1e-5 if dtype == "float32" else 2e-2), rel


def test_attention_unconditioned_uses_affine_layer_norm():
    p, x, _, bias_idx = _setup(32, 4, 8, cond=False)
    assert set(p["norm"]) == {"g", "b"} and "film" not in p
    want = reference_attention(p, x, None, bias_idx, 4, 3)
    got = np.asarray(_run(p, x, None, bias_idx, 4, 3), np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the affine actually matters
    p0 = dict(p, norm={})
    assert not np.allclose(np.asarray(_run(p0, x, None, bias_idx, 4, 3)),
                           got, atol=1e-3)


@pytest.mark.parametrize("cond", [True, False], ids=["film", "affine_ln"])
def test_attention_gradient(cond):
    """Reverse-mode gradients against finite differences, w.r.t. the input
    and every parameter (small window: 2x2 + 1 register)."""
    p, x, c, bias_idx = _setup(16, 2, 8, cond=cond, windows=2, per_sample=1,
                               n_tok=5, window=2, registers=1)

    def loss(p_, x_):
        y = attention(p_, x_, c, bias_idx, heads=2, windows_per_sample=1)
        return jnp.sum(jnp.sin(y))

    check_grads(loss, (p, x), order=1, modes=("rev",), atol=5e-2,
                rtol=5e-2, eps=1e-3)


def test_attention_dropout():
    p, x, c, bias_idx = _setup(32, 4, 8)
    evald = np.asarray(_run(p, x, c, bias_idx, 4, 3))
    kw = dict(dropout_rate=0.5, training=True)
    k1, k2 = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    a = np.asarray(_run(p, x, c, bias_idx, 4, 3, dropout_key=k1, **kw))
    b = np.asarray(_run(p, x, c, bias_idx, 4, 3, dropout_key=k1, **kw))
    d = np.asarray(_run(p, x, c, bias_idx, 4, 3, dropout_key=k2, **kw))
    np.testing.assert_array_equal(a, b)            # same key, same mask
    assert not np.allclose(a, d)                   # new key, new mask
    assert np.linalg.norm(a - evald) / np.linalg.norm(evald) > 0.1
    # no key, rate 0 or eval mode: no dropout
    for kw_off in (dict(dropout_rate=0.5, training=True),
                   dict(dropout_rate=0.0, training=True, dropout_key=k1),
                   dict(dropout_rate=0.5, training=False, dropout_key=k1)):
        np.testing.assert_array_equal(
            np.asarray(_run(p, x, c, bias_idx, 4, 3, **kw_off)), evald)
    # inverted dropout is unbiased: the mean over keys approaches eval
    keys = jax.random.split(jax.random.PRNGKey(3), 256)
    mean = np.asarray(jax.jit(jax.vmap(lambda k: attention(
        p, x, c, bias_idx, heads=4, windows_per_sample=3,
        dropout_key=k, **kw)))(keys)).mean(0)
    assert np.linalg.norm(mean - evald) / np.linalg.norm(evald) < 0.1
