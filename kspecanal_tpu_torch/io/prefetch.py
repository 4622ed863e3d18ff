"""Whole-sweep read-ahead for scan mode: a copy of
``kspecanal_tpu.io.prefetch.SweepPrefetcher`` in which the sweep acquirer is
a required argument.  The original's constructor imports its default
acquirer from ``kspecanal_tpu.session``, which loads JAX.

The worker thread owns the source while the prefetcher is open: it runs the
serial per-band retune/read walk (``session.acquire_sweep`` or
``acquire_sweep_raw``) and queues complete numpy sweeps, which the session
loop takes with :meth:`SweepPrefetcher.get` while the previous sweep
computes.  The retune order within each sweep is unchanged, so the data is
identical to the serial driver's.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable


class SweepPrefetcher:
    """Credit-bound read-ahead: the worker runs at most ``depth`` (<= 4)
    sweeps ahead of what :meth:`get` consumed and acquires at most
    ``limit`` sweeps in all (0: no limit), so a non-wrapping source reused
    after the run is not advanced past the sweeps it consumed.  A source
    error on the worker is re-raised from the next :meth:`get`.
    ``acquire_fn(source, cfg, plan)`` returns a tuple whose last element
    is the source's ``exhausted`` flag.  ``close()`` stops the worker and
    returns the source."""

    def __init__(self, source, cfg, plan, acquire_fn: Callable,
                 depth: int = 2, limit: int = 0):
        self._acquire = acquire_fn
        self._source = source
        self._cfg = cfg
        self._plan = plan
        depth = max(1, min(int(depth), 4))
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._credits = threading.Semaphore(depth)
        self._limit = int(limit) if limit else 0
        self._exc: Exception | None = None
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._fill, daemon=True)
        self._worker.start()

    def get(self):
        """Next sweep as the ``acquire_fn`` tuple.  Re-raises a worker-side
        source error; once the worker has stopped and the queue is drained,
        acquires synchronously."""
        while True:
            try:
                sweep = self._q.get(timeout=0.1)
                self._credits.release()
                return sweep
            except queue.Empty:
                if self._exc is not None:
                    raise self._exc
                if self._stop.is_set():
                    return self._acquire(self._source, self._cfg, self._plan)

    def close(self):
        self._stop.set()
        self._credits.release()   # unblock a worker waiting for a credit
        self._worker.join(timeout=5.0)

    def _fill(self):
        produced = 0
        while not self._stop.is_set():
            if self._limit and produced >= self._limit:
                return
            # A consumption credit before touching the source: at most
            # `depth` sweeps are ever read past what get() returned.
            if not self._credits.acquire(timeout=0.1):
                continue
            if self._stop.is_set():
                return
            try:
                sweep = self._acquire(self._source, self._cfg, self._plan)
            except Exception as e:   # propagate via get() instead of hanging
                self._exc = e
                self._stop.set()
                return
            produced += 1
            while not self._stop.is_set():
                try:
                    self._q.put(sweep, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if sweep[-1]:     # source exhausted: no further sweeps exist
                self._stop.set()
                return
