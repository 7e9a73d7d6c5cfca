"""The peak table the benchmarks divide by, the compile-cache rule of the
entry points, and the trace reduction's scope attribution."""

import os
import sys

import pytest

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core import jaxcache
from vit_grid_model_tpu.utils import peaks

sys.path.insert(0, os.path.join(jaxcache.CHECKOUT, "benchmarks"))

import trace_forward  # noqa: E402


def test_peaks_known_device():
    p = peaks.peaks_for("NVIDIA H100 80GB HBM3")
    assert p.bf16_flops == 989e12 and p.tf32_flops == 495e12
    assert p.f32_flops == 67e12 and p.mem_bytes_per_s == 3.35e12
    assert "data sheet" in p.source


def test_peaks_unknown_device_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        peaks.peaks_for("NVIDIA A100-SXM4-40GB")
    with pytest.raises(KeyError):
        peaks.peaks_for("cpu")


def test_matmul_peak_follows_dtype_and_precision():
    p = peaks.peaks_for("NVIDIA H100 80GB HBM3")
    assert p.matmul_peak("bfloat16", "default") == p.bf16_flops
    assert p.matmul_peak("int8", "default") == p.bf16_flops
    assert p.matmul_peak("float32", "default") == p.tf32_flops
    assert p.matmul_peak("float32", "highest") == p.f32_flops


@pytest.fixture
def cache_config(monkeypatch):
    """Restore jax's cache directory after the test."""
    before = jax.config.jax_compilation_cache_dir
    yield monkeypatch
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_env_set_is_left_to_jax(cache_config, tmp_path):
    cache_config.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert jaxcache.enable_persistent_cache() == str(tmp_path)
    # the code set nothing: jax reads the variable itself
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_env_unset_uses_fixed_checkout_path(cache_config):
    cache_config.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = jaxcache.enable_persistent_cache()
    assert got == os.path.join(jaxcache.CHECKOUT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert os.path.isfile(os.path.join(jaxcache.CHECKOUT, "chip_smoke.py"))


def test_cache_path_is_stable_across_calls(cache_config):
    cache_config.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = jaxcache.enable_persistent_cache()
    assert all(jaxcache.enable_persistent_cache() == first for _ in range(3))
    assert first == jaxcache.DEFAULT_CACHE_DIR


def test_trace_scope_attribution():
    @jax.jit
    def f(x):
        with jax.named_scope("block_attn"):
            y = jnp.tanh(x @ x)
        with jax.named_scope("grid_attn"):
            y = jnp.exp(y @ x)
        return y.sum()

    scopes = trace_forward.hlo_op_scopes(
        f.lower(jnp.ones((16, 16))).compile().as_text())
    assert {"block_attn", "grid_attn", "other"} <= set(scopes.values())
    assert trace_forward.scope_of("jit(f)/block_attn_x/dot") == "other"
