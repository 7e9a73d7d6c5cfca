"""Persistent XLA compilation cache for the entry points.

A fresh process otherwise recompiles every program it runs; at the shipped
widths that is tens of seconds per program.  The rule:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and this module
  sets nothing;
* otherwise the cache lives at ``<checkout>/.jax_cache``, a fixed path
  (the path is part of the cache key, so a moving directory never hits;
  ``.gitignore`` lists it).

Cache keys include the jax/XLA version, the device and the compile options,
so a stale toolchain or another card never reuses an entry.
"""

from __future__ import annotations

import os

#: the checkout root (the directory holding the package)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_persistent_cache() -> str:
    """Point jax at the persistent cache (call BEFORE the first jit).
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
