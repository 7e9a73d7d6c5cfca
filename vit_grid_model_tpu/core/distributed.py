"""Multi-host initialization.

The reference is single-process (SURVEY §2.3).  For runs over several GPU
hosts this wraps ``jax.distributed.initialize``: call once per host before
any device use; afterwards ``jax.devices()`` spans every host's cards and
the same ``parallel.mesh`` code shards over NVLink within a host and the
network between hosts — nothing else in the framework changes.

Typical launch (one process per host; nothing discovers the cluster, so
the coordinator is given explicitly):

    from vit_grid_model_tpu.core import distributed
    distributed.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = parallel.mesh.make_mesh(MeshConfig())  # all global devices
"""

from __future__ import annotations

import os
from typing import Optional

import jax


_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime.  GPU hosts give the
    coordinator explicitly (``coordinator_address``, ``num_processes``,
    ``process_id``); with no arguments a cluster environment JAX knows
    (e.g. SLURM) drives discovery, and without one this is a no-op.

    MUST run before any backend use: querying devices (even
    ``jax.process_count()``) initializes the backends, after which
    ``jax.distributed.initialize`` refuses to run.  A failed multi-host
    init is surfaced, not swallowed — silently falling back would leave
    every host running as an independent single-process instance.
    """
    global _initialized
    if _initialized:
        return
    explicit = coordinator_address is not None
    kwargs = (dict(coordinator_address=coordinator_address,
                   num_processes=num_processes, process_id=process_id)
              if explicit else {})
    try:
        jax.distributed.initialize(**kwargs)
        _initialized = True
    except ValueError:
        if explicit:
            raise
        # no coordinator in the environment: legitimate single-process run
    except RuntimeError as e:
        msg = str(e).lower()
        if "already" in msg or "only be called once" in msg:
            _initialized = True
            return
        if "before any jax calls" in msg and not explicit:
            # backends already up in a single-process context (tests,
            # notebooks): benign.  On several hosts, configure the
            # coordinator explicitly and call initialize() first — that
            # path raises.
            import warnings

            warnings.warn(
                "jax backends initialized before distributed.initialize(); "
                "continuing single-process", RuntimeWarning)
            return
        raise


def is_primary() -> bool:
    """True on the host that should write logs/checkpoints."""
    return jax.process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """The per-host slice of a globally sharded batch (hosts feed disjoint
    shards; GSPMD stitches them through the 'data' axis)."""
    per = global_batch // jax.process_count()
    start = per * jax.process_index()
    return slice(start, start + per)
