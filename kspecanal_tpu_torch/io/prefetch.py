"""Pipelined ingest of the port: the read-ahead wrappers of
``kspecanal_tpu.io.prefetch``, copied.

:class:`PrefetchingSource` is the original as it is: a worker thread reads
blocks of a fixed size ahead into a bounded queue (raw u8 blocks where the
inner source has ``read_raw``); a retune flushes it.

:class:`SweepPrefetcher` is the scan mode's whole-sweep read-ahead, with
the sweep acquirer a required argument: the original's constructor imports
its default acquirer from ``kspecanal_tpu.session``, which loads JAX.  The
worker thread owns the source while the prefetcher is open: it runs the
serial per-band retune/read walk (``session.acquire_sweep`` or
``acquire_sweep_raw``) and queues complete numpy sweeps, which the session
loop takes with :meth:`SweepPrefetcher.get` while the previous sweep
computes.  The retune order within each sweep is unchanged, so the data is
identical to the serial driver's.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Tuple

import numpy as np

Planes = Tuple[np.ndarray, np.ndarray]


class PrefetchingSource:
    """Wraps any IQSource; ``read(n)`` returns prefetched blocks when the
    requested size matches the configured block size, else reads through."""

    def __init__(self, inner, block_size: int, depth: int = 4):
        self._inner = inner
        self._block = block_size
        # Raw-capable inner sources are prefetched as RAW u8 blocks so the
        # session's 2 B/sample ship path survives the wrapper; read_raw is
        # exposed per-instance only when the inner source offers it (the
        # drivers feature-detect with getattr).
        self._raw = hasattr(inner, "read_raw")
        if self._raw:
            self.read_raw = self._pop_raw
        self._popped_exhausted = False
        # Queue items are (epoch, block, exhausted): a block read under
        # tuning epoch k is discarded by read() once a retune has bumped
        # the epoch, even if the worker enqueued it AFTER retune() drained
        # the queue (the worker may sit between releasing the lock and
        # put()); `exhausted` is the inner EOF flag AT READ TIME, carried
        # per item like SweepPrefetcher does.
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._epoch = 0
        self._stop = threading.Event()
        self._gen = threading.Event()
        self._gen.set()
        self._worker = threading.Thread(target=self._fill, daemon=True)
        self._lock = threading.Lock()
        self._worker.start()

    # -- source protocol ---------------------------------------------------
    @property
    def center_freq(self):
        return self._inner.center_freq

    @property
    def sample_rate(self):
        return self._inner.sample_rate

    @property
    def gain(self):
        return self._inner.gain

    @property
    def exhausted(self):
        # EOF flag as observed when the block the consumer LAST POPPED was
        # read — NOT the inner source's live flag: the worker runs up to
        # depth+1 blocks ahead, so the live flag would make drivers stop
        # early and silently drop real prefetched data (the graceful-stop
        # contract is per-consumed-block, kspecanal.py:559-564).
        return self._popped_exhausted

    def _pop_block(self, n: int, read_through):
        if n != self._block:
            with self._lock:
                out = read_through(n)
                self._popped_exhausted = bool(
                    getattr(self._inner, "exhausted", False))
                return out
        while True:
            try:
                epoch, block, exh = self._q.get(timeout=0.1)
                if epoch == self._epoch:
                    self._popped_exhausted = exh
                    return block
                # stale: read at a pre-retune tuning — drop and keep waiting
            except queue.Empty:
                if self._stop.is_set():
                    with self._lock:
                        out = read_through(n)
                        self._popped_exhausted = bool(
                            getattr(self._inner, "exhausted", False))
                        return out

    def read(self, n: int) -> Planes:
        if self._raw:
            raw = self._pop_block(n, self._inner.read_raw)
            try:                    # native fused decode (~10x NumPy)
                from kspecanal_tpu_torch.io import native_iq
                return native_iq.decode_u8_iq(raw)
            except (ImportError, OSError):
                x = raw.astype(np.float32) - np.float32(127.0)
                return (np.ascontiguousarray(x[0::2]),
                        np.ascontiguousarray(x[1::2]))
        return self._pop_block(n, self._inner.read)

    def _pop_raw(self, n: int) -> np.ndarray:
        return self._pop_block(n, self._inner.read_raw)

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self._gen.clear()          # pause the worker
        with self._lock:
            ok = self._inner.retune(center_freq, sample_rate, gain)
            # Sources whose data does not depend on the tuning (recorded
            # captures) declare retune_invalidates=False: their prefetched
            # blocks stay valid, and flushing would permanently DROP data
            # from a non-wrapping file (the worker reads ahead of the
            # driver's initial retune).
            if getattr(self._inner, "retune_invalidates", True):
                self._epoch += 1   # invalidates in-flight worker blocks too
                # drop now-stale prefetched blocks
                while True:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        break
        self._gen.set()
        return ok

    def close(self):
        self._stop.set()
        self._gen.set()
        self._worker.join(timeout=2.0)
        self._inner.close()

    # -- worker ------------------------------------------------------------
    def _fill(self):
        while not self._stop.is_set():
            self._gen.wait(timeout=0.1)
            if not self._gen.is_set():
                continue
            with self._lock:
                if self._stop.is_set():
                    return
                epoch = self._epoch
                block = (self._inner.read_raw(self._block) if self._raw
                         else self._inner.read(self._block))
                exh = bool(getattr(self._inner, "exhausted", False))
            item = (epoch, block, exh)
            try:
                self._q.put(item, timeout=0.5)
            except queue.Full:
                # consumer is slower than the source; drop nothing, retry —
                # put() re-attempted with the same block next loop
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue


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
