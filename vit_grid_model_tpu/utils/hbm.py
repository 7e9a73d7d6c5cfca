"""Device-memory exhaustion guard: turn XLA allocator dumps into
actionable errors.

The device's memory bounds the batch sizes each mode supports
(``benchmarks/hbm_envelope.py`` measures the envelope); when a workload
exceeds it, XLA raises a RESOURCE_EXHAUSTED error whose multi-page
buffer-assignment dump buries the one actionable fact.  ``oom_guard``
re-raises it as a one-paragraph RuntimeError naming the workload, the
batch, and the device's own memory limit.
"""

from __future__ import annotations

import contextlib


def is_oom_error(e: BaseException) -> bool:
    """True when ``e`` is an XLA out-of-memory failure.

    Classification is gated on the exception COMING FROM XLA — an
    ``XlaRuntimeError`` (matched by name: the class moved modules across
    jaxlib versions) or a message carrying an XLA marker — before the
    memory substrings are consulted.  An unrelated error that merely
    mentions "out of memory" (advisor r4: e.g. a loader IOError) must not
    be rewrapped as a device-memory failure.
    """
    s = str(e)
    from_xla = (type(e).__name__ == "XlaRuntimeError"
                or "RESOURCE_EXHAUSTED" in s or "XLA" in s)
    if not from_xla:
        return False
    return ("RESOURCE_EXHAUSTED" in s
            or "Out of memory" in s
            or "out of memory" in s
            or "Attempting to reserve" in s)


def device_memory_limit() -> str:
    """The first device's memory limit as JAX reports it, e.g.
    ``"60.0 GB"``; ``"unknown"`` when the backend keeps no statistics."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return f"{limit / 1e9:.1f} GB" if limit else "unknown"


@contextlib.contextmanager
def oom_guard(what: str, batch_size: int | None = None,
              envelope_hint: str = "benchmarks/hbm_envelope.py measures "
                                   "the envelope"):
    """Wrap a compile/execute region; on device-memory exhaustion raise a
    concise RuntimeError (chained to the original for full detail)."""
    try:
        yield
    except Exception as e:                          # noqa: BLE001
        if not is_oom_error(e):
            raise
        b = f" at batch_size={batch_size}" if batch_size is not None else ""
        raise RuntimeError(
            f"{what}{b} does not fit in this device's memory "
            f"({device_memory_limit()} available to this process). Reduce "
            f"the batch size or shard over more devices ({envelope_hint}). "
            f"Original XLA error type: {type(e).__name__}.") from e
