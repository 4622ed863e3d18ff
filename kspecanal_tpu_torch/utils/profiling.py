"""Tracing of the port's sessions — the counterpart of
``kspecanal_tpu.utils.profiling``.

  * :class:`StageTimer` is a copy of the JAX package's (per-stage wall
    times and samples/s rates);
  * :func:`trace` wraps a block in ``torch.profiler`` (CPU and CUDA
    activities), writes a Chrome trace into the directory given (``tpuProfile
    <dir>`` on the CLI, or ``KSPEC_TRACE_DIR``) and logs the card's busy
    share of the traced window, :func:`device_busy_share`;
  * :func:`cuda_ms`, :func:`cuda_ms_each` and :func:`card_line` time work
    on the card and name the card for the forensics scripts
    (``kspecanal_tpu_torch/scripts``).
"""
from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time
from collections import defaultdict
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

import torch

from kspecanal_tpu_torch.utils.logging import log_info


class StageTimer:
    """Per-stage wall-clock + throughput accounting."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.samples: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, samples: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)
            self.samples[name] += samples

    def rate(self, name: str) -> float:
        """Samples/s over everything recorded for a stage."""
        total = sum(self.times[name])
        return self.samples[name] / total if total else 0.0

    def report(self) -> str:
        lines = []
        for name, ts in self.times.items():
            total = sum(ts)
            line = (f"{name}: n={len(ts)} total={total:.3f}s "
                    f"mean={total / len(ts) * 1e3:.2f}ms")
            if self.samples[name]:
                line += f" rate={self.rate(name) / 1e6:.2f} Msamp/s"
            lines.append(line)
        return "\n".join(lines)

    def log_report(self):
        for line in self.report().splitlines():
            log_info(f"profile: {line}")


def cuda_ms(fn: Callable[[], object], warm: int = 3, reps: int = 10) -> float:
    """Median milliseconds of ``fn()`` on the card: CUDA events around each
    of ``reps`` calls after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_each(fn: Callable[[], object], calls: int = 10) -> float:
    """Milliseconds a call of ``fn()`` keeps the card busy: :func:`cuda_ms`
    of ``calls`` back-to-back calls, divided by ``calls``.  The host queues
    each call while the card runs the one before, so a wrapper's host time
    shows only where it exceeds the kernel's."""
    return cuda_ms(lambda: [fn() for _ in range(calls)]) / calls


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def require_cuda(what: str) -> None:
    """Raise unless a CUDA card is present: a measurement never falls back
    to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{what} measures the card: no CUDA device")


def busy_share(intervals: Iterable[Tuple[float, float]],
               window: Tuple[float, float]) -> Optional[float]:
    """Length of the union of ``(start, end)`` intervals, clipped to
    ``window``, over the window's length; None when there are no
    intervals (absent, not 0%)."""
    spans = sorted((max(s, window[0]), min(e, window[1]))
                   for s, e in intervals)
    if not spans:
        return None
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = window[1] - window[0]
    return busy / span if span > 0 else None


def device_busy_share(prof) -> Tuple[Optional[float], float]:
    """(busy share, window seconds) of a finished ``torch.profiler``
    profile: the union of its CUDA device intervals (kernels, memcpy,
    memset) over the traced wall window, from the first to the last event
    of any kind.  The share is None when the trace holds no CUDA event (a
    run on the CPU)."""
    events = prof.events()
    if not events:
        return None, 0.0
    window = (min(e.time_range.start for e in events),
              max(e.time_range.end for e in events))
    device = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return busy_share(device, window), (window[1] - window[0]) * 1e-6


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` trace of the block into ``trace_dir`` (or
    ``KSPEC_TRACE_DIR``); a no-op when neither is set.  Logs ``profile:
    device busy X% of Y s``, or that the share is absent when no CUDA event
    was traced."""
    trace_dir = trace_dir or os.environ.get("KSPEC_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            # The queued device work belongs to the traced window.
            torch.cuda.synchronize()
    path = os.path.join(trace_dir, f"kspec_trace_{os.getpid()}_"
                                   f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    share, seconds = device_busy_share(prof)
    if share is None:
        log_info(f"profile: device busy share absent (no CUDA activity in "
                 f"the trace) over {seconds:.3f} s")
    else:
        log_info(f"profile: device busy {share * 100:.1f}% of {seconds:.3f} s")
    log_info(f"profiler trace written to {path}")
