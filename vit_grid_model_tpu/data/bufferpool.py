"""Refcount-probing pool for large host-side staging buffers.

A fresh multi-hundred-MB ``np.empty`` is a new anonymous mmap whose
first-touch page faults serialize in the kernel: writing one flagship
B=25 batch into a fresh allocation costs ~4 s at 94% system time vs
~0.22 s into an already-faulted buffer (measured on a one-core host).  The
prefetching loader and the eval staging path used to pay that storm on
every batch, because downstream holders (queued batches, in-flight
``device_put``) kept prior arrays alive while each call allocated anew.

``get`` returns a pooled array only when the pool holds the ONLY
reference to it (refcount probe) — a batch still queued, staged, viewed,
or pinned by an asynchronous transfer keeps its refcount elevated (any
holder, Python or C++ binding, owns a Python reference to the ndarray),
so handing out an aliased buffer is impossible by construction.  When
every pooled buffer is busy the call falls back to a fresh allocation
(correct, just slower), so the pool is a pure fast path.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict

import numpy as np


class BufferPool:
    def __init__(self, max_per_key: int = 16):
        # the cap only bounds how many buffers may be RETAINED per key —
        # the pool grows to actual concurrent demand, never eagerly.  The
        # loader's worst case: prefetch queue (2) + consumer-held batch +
        # the batch being written, PLUS, under shuffle="buffer", the
        # ~shuffle_buffer source batches the zero-copy reservoir pins
        # (pipeline.py::_buffer_shuffle) — hence 16, not 4 (a lower cap
        # makes the reservoir allocate fresh every batch, re-paying the
        # first-touch page-fault storm the pool exists to avoid)
        self._max = max_per_key
        self._lock = threading.Lock()
        self._bufs: Dict[tuple, list] = {}
        self._max_overrides: Dict[tuple, int] = {}

    @staticmethod
    def key(shape, dtype=np.float32) -> tuple:
        """The pool key for a (shape, dtype) — the unit retention caps
        apply to."""
        return (tuple(int(s) for s in shape), str(np.dtype(dtype)))

    def ensure_retention(self, n: int, key: tuple | None = None) -> None:
        """Raise (never lower) the retention cap to ``n`` — for one pool
        ``key`` (from :meth:`key`) when given, else for every key.

        Called by consumers whose steady-state working set exceeds the
        default — e.g. the shuffle="buffer" reservoir pins ~shuffle_buffer
        source batches, and a cap BELOW that working set guarantees churn:
        every epoch drain releases reservoir-many buffers, the over-cap
        excess is dropped, and the next epoch re-allocates them fresh,
        re-paying the first-touch page-fault storm per epoch.  Retention
        still only grows to actual demand (nothing is pre-allocated).
        Callers that know their shapes pass ``key`` so an elevated cap
        doesn't leak to unrelated buffer shapes for process lifetime
        (advisor r4)."""
        with self._lock:
            if key is None:
                self._max = max(self._max, n)
            else:
                self._max_overrides[key] = max(
                    self._max_overrides.get(key, 0), n)

    def get(self, shape, dtype=np.float32) -> np.ndarray:
        """An idle (already-faulted) array of ``shape``/``dtype``, else a
        fresh allocation.  Contents are UNINITIALIZED — callers must write
        every byte, exactly as with ``np.empty``."""
        key = self.key(shape, dtype)
        with self._lock:
            bufs = self._bufs.setdefault(key, [])
            for arr in bufs:
                # refs while probing: the pool slot, the loop variable,
                # and getrefcount's argument == 3; any external holder
                # (queued batch, numpy view, in-flight device_put) adds
                if sys.getrefcount(arr) == 3:
                    return arr
            arr = np.empty(key[0], np.dtype(dtype))
            cap = max(self._max, self._max_overrides.get(key, 0))
            if len(bufs) < cap:
                bufs.append(arr)
            return arr

    def clear(self) -> None:
        with self._lock:
            self._bufs.clear()


#: process-wide pool shared by the native assembler outputs and the
#: host staging paths (model-input repack, bf16 cast)
POOL = BufferPool()
