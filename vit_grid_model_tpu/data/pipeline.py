"""Host-side input pipeline: threaded sample assembly + batch prefetch.

The reference parallelizes input with 5 DataLoader worker *processes*
(``evaluation_vit.py:138``).  The replacement here keeps assembly on
host threads (the work is numpy + file I/O, which releases the GIL), batches
with the dataset's ``collate``, and prefetches a bounded queue of ready
batches so the accelerator never waits on the filesystem.  With sharding
enabled, each batch is placed directly into the device layout
(``jax.device_put`` with a ``NamedSharding``), so host->HBM transfer
overlaps the previous step's compute.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class BatchLoader:
    """Minimal DataLoader equivalent: map-style dataset -> batched numpy.

    Deterministic order (``shuffle=False`` like the eval loader) unless a
    seed is given; ``drop_last=False`` matches ``evaluation_vit.py:138``.

    ``shuffle`` accepts ``"batches"`` and ``"buffer"`` besides True/False:

    * ``"batches"``: the epoch is cut into CONSECUTIVE-index batches (at a
      per-epoch random rotation) and the batch ORDER is shuffled.
      Consecutive batches keep the union-assembly fast path
      (``get_batch_collated``: (B-1+T)/(B*T) of the file reads), which
      sample-level shuffling forfeits — measured 87.7 vs 42.2 samples/s
      steady at the flagship geometry on a one-core host.  The trade is
      coarse SGD noise: samples co-occur with their window neighbors.
    * ``"buffer"``: union-assembled consecutive batches feed a reservoir
      of ``shuffle_buffer * batch_size`` samples (preallocated ring
      slots), and emitted batches draw ``batch_size`` samples uniformly
      from the reservoir — the standard shuffle-buffer (tf.data/grain)
      local shuffle.  Batch composition mixes across ~``shuffle_buffer``
      source batches (whose ORDER is itself shuffled per epoch), removing
      the neighbors-co-occur artifact of ``"batches"`` at a fraction of
      sample-level shuffling's assembly cost (two extra memcpys per
      sample instead of a per-sample union re-read).
    """

    def __init__(self, dataset, batch_size: int, *, shuffle=False,
                 seed: int = 0, num_workers: int = 4,
                 prefetch_batches: int = 2, drop_last: bool = False,
                 collate: Optional[Callable] = None,
                 dispatch: str = "auto", shuffle_buffer: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.drop_last = drop_last
        # get_batch_collated produces batches equivalent to the dataset's
        # own collate over get_batch; it can only replace the stack step
        # when the caller didn't override collate
        self._stock_collate = collate is None
        self.collate = collate or getattr(dataset, "collate", None) or (
            lambda samples: tuple(np.stack(f) for f in zip(*samples)))
        # "single": one dispatcher thread, sequential __getitem__ — the
        # right mode when the dataset's assembly is internally threaded
        # (the native C++ plane): Python worker threads on top CONTEND with
        # the native pool rather than add (measured 33.9 vs 80.8 samples/s
        # on a one-core host).  "pool": the ThreadPoolExecutor path for
        # GIL-releasing numpy/file assembly.  "auto": ask the dataset
        # (``prefers_single_dispatch``).
        if dispatch not in ("auto", "single", "pool"):
            raise ValueError(f"unknown dispatch mode {dispatch!r}")
        self.dispatch = dispatch
        self.shuffle_buffer = max(2, shuffle_buffer)
        self._epoch = 0

    def _single_dispatch(self) -> bool:
        if self.dispatch != "auto":
            return self.dispatch == "single"
        return bool(getattr(self.dataset, "prefers_single_dispatch", False))

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle in ("batches", "buffer"):
            # rotate the epoch (re-randomizes the cut points), chunk into
            # consecutive runs, shuffle the run order.  The wrap-around
            # chunk is the one non-consecutive batch per epoch; it simply
            # takes the per-sample assembly path.
            rng = np.random.default_rng(self.seed + self._epoch)
            idx = np.roll(idx, int(rng.integers(max(len(idx), 1))))
            starts = np.arange(0, len(idx), self.batch_size)
            rng.shuffle(starts)
            for s in starts:
                chunk = idx[s:s + self.batch_size]
                if (self.drop_last and len(chunk) < self.batch_size
                        and self.shuffle == "batches"):
                    # buffer mode: ragged SOURCE chunks still feed the
                    # reservoir; drop_last applies to EMITTED batches
                    continue
                if len(chunk):
                    yield chunk
            return
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        end = (len(idx) // self.batch_size * self.batch_size
               if self.drop_last else len(idx))
        for s in range(0, end, self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if len(chunk):
                yield chunk

    def _buffer_shuffle(self, stream) -> Iterator:
        """Local (reservoir) shuffle over union-assembled source batches.

        ZERO-COPY reservoir: entries are (source_batch, row) references —
        copying samples into staging rings costs two full memcpys of the
        ~15 MB sim tensor per sample, which on this class of host is more
        than the union assembly itself (measured 43.7 vs 74.5 samples/s).
        The single unavoidable copy happens at emission, gathering the
        chosen rows into pooled output buffers.  Held source batches keep
        their pooled buffers alive until their LAST row is drawn — random
        draws long-tail that, so the pinned set spans ~``shuffle_buffer *
        H(batch_size)`` distinct batches (≈2.1x at B=4), not
        ``shuffle_buffer``.  The pool retention cap ratchets to the
        OBSERVED pinned count (instrumented round 5: a cap at the nominal
        reservoir size left 20 fresh ~50 MB allocations per epoch at
        reservoir=16 — the first-touch fault storm the pool exists to
        avoid, erratically halving loader throughput).
        """
        from vit_grid_model_tpu.data.bufferpool import POOL

        # retention below the pinned working set re-pays the first-touch
        # fault storm on every refill (an undersized cap drops released
        # buffers, the refill allocates fresh).  The cap is raised PER KEY,
        # for exactly the field shapes the reservoir handles (advisor r4:
        # a global raise leaked the elevated cap to every pool key for
        # process lifetime), and ratchets with the measured number of
        # distinct pinned source batches (+6 covers the emitted batches in
        # flight: prefetch queue, consumer, the one being written).
        keyed: Dict[tuple, int] = {}

        def ensure_keys(fields, lead_n, retain):
            for f in fields:
                a = np.asarray(f)
                k = POOL.key((lead_n,) + a.shape[1:], a.dtype)
                if keyed.get(k, 0) < retain:
                    keyed[k] = retain
                    POOL.ensure_retention(retain, k)
        # distinct stream from _batch_indices' default_rng(seed + epoch) for
        # EVERY seed (advisor r4: the old seed*7919 + epoch collided at
        # seed=0, correlating chunk order with reservoir draws) — the
        # SeedSequence key carries a stream tag
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, self._epoch, 0x5E5E)))
        cap = self.shuffle_buffer * self.batch_size
        entries: list = []                       # (batch_tuple, row)

        def emit(n):
            pick = rng.choice(len(entries), size=n, replace=False)
            chosen = [entries[t] for t in pick]
            for t in sorted(pick, reverse=True):
                entries.pop(t)
            ensure_keys(chosen[0][0], n, self.shuffle_buffer + 6)
            fields = []
            for f_idx in range(len(chosen[0][0])):
                proto = np.asarray(chosen[0][0][f_idx])
                buf = POOL.get((n,) + proto.shape[1:], proto.dtype)
                for j, (src, i) in enumerate(chosen):
                    buf[j] = src[f_idx][i]
                fields.append(buf)
            return tuple(fields)

        peak_pinned = 0
        for batch in stream:
            src_n = np.asarray(batch[0]).shape[0]
            for i in range(src_n):
                entries.append((batch, i))
            pinned = len({id(e[0]) for e in entries})
            if pinned > peak_pinned:
                peak_pinned = pinned
                ensure_keys(batch, src_n, peak_pinned + 6)
            while len(entries) >= cap:
                yield emit(self.batch_size)
        while entries:                               # epoch drain
            n = min(self.batch_size, len(entries))
            if self.drop_last and n < self.batch_size:
                return
            yield emit(n)

    def __iter__(self) -> Iterator:
        self._epoch += 1
        out_q: "queue.Queue" = queue.Queue(self.prefetch_batches)
        stop = threading.Event()

        def put(item) -> bool:
            # stop-aware put: a consumer that abandons the iterator mid-epoch
            # (max_batches, exceptions) sets `stop`; a plain blocking put
            # would pin this thread, its pool and the queued batches forever
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def assembled():
            """Collated batches in epoch (chunk) order."""
            if self._single_dispatch():
                # the native assembler's internal pool is the only
                # parallelism; the prefetch queue double-buffers the
                # collated batch against the consumer's device_put +
                # compute.  Preference order per batch:
                # get_batch_collated (one native pass STRAIGHT into the
                # batched arrays — no slice/stack copies) ->
                # get_batch (union assembly, then collate) ->
                # per-sample __getitem__.
                get_collated = (getattr(self.dataset,
                                        "get_batch_collated", None)
                                if self._stock_collate else None)
                get_batch = getattr(self.dataset, "get_batch", None)
                get = self.dataset.__getitem__
                for chunk in self._batch_indices():
                    if stop.is_set():
                        return
                    batch = (get_collated(chunk)
                             if get_collated is not None else None)
                    if batch is None:
                        samples = (get_batch(chunk)
                                   if get_batch is not None
                                   else [get(i) for i in chunk])
                        batch = self.collate(samples)
                    yield batch
            else:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk in self._batch_indices():
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                chunk))
                        yield self.collate(samples)

        def produce():
            try:
                stream = assembled()
                if self.shuffle == "buffer":
                    stream = self._buffer_shuffle(stream)
                for batch in stream:
                    if not put(("batch", batch)):
                        return
            except BaseException as e:  # surface worker errors to consumer
                put(("error", e))
                return
            put(("done", None))

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                kind, payload = out_q.get()
                if kind == "batch":
                    yield payload
                elif kind == "error":
                    raise payload
                else:
                    return
        finally:
            stop.set()


def device_prefetch(batches: Iterator, put: Callable) -> Iterator:
    """Overlap host->device transfer with compute: keep one batch in flight.

    ``put`` is typically ``lambda b: jax.device_put(b, sharding)``.
    """
    it = iter(batches)
    try:
        pending = put(next(it))
    except StopIteration:
        return
    for nxt in it:
        nxt_dev = put(nxt)
        yield pending
        pending = nxt_dev
    yield pending
