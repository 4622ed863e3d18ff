"""Tracing of the port's sessions — the counterpart of
``kspecanal_tpu.utils.profiling``.

  * :func:`span` puts a ``torch.profiler`` range named ``kspec.<name>``
    around a block; while no profiler records it costs one flag check and
    calls nothing of torch's RecordFunction;
  * :class:`StageTimer` counts and totals the host time of a session
    loop's stages and of its waits (``timer.wait(site)``: the host blocked
    on the card or on the acquire worker), each inside its own span
    (``kspec.<stage>``, ``kspec.wait.<site>``); :func:`wait` is the wait
    site of code without a session handle, recorded into the timer a
    session installs (:func:`installed`), as is :func:`tally`, a count
    without time (the route each step's display chain took);
  * :func:`trace` wraps a block in ``torch.profiler`` (CPU and CUDA
    activities), writes a Chrome trace into the directory given (``tpuProfile
    <dir>`` on the CLI, or ``KSPEC_TRACE_DIR``) and logs the card's busy
    share of the traced window, :func:`device_busy_share`: the card's time
    per layer is read from that trace, never from :class:`StageTimer`;
  * :func:`cuda_ms`, :func:`cuda_ms_each` and :func:`card_line` time work
    on the card and name the card for the forensics scripts
    (``kspecanal_tpu_torch/scripts``).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import torch
from torch._C._autograd import _profiler_enabled

from kspecanal_tpu_torch.utils.logging import log_info

SPAN_PREFIX = "kspec."
WAIT = "wait."
_NO_SPAN = contextlib.nullcontext()
_clock = time.perf_counter


def span(name: str):
    """A profiler range ``kspec.<name>`` around a ``with`` block, in the
    same trace as the card's operations; a shared no-op while no profiler
    records."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


class _Timed:
    """One stage or wait of a :class:`StageTimer`: host seconds from entry
    to exit, inside its span, added to ``st``, the stage's ``[count,
    total s, longest s, samples]``."""
    __slots__ = ("st", "name", "samples", "rf", "t0")

    def __init__(self, st: list, name: str, samples: int):
        self.st, self.name, self.samples = st, name, samples

    def __enter__(self) -> None:
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.t0 = _clock()

    def __exit__(self, et, ev, tb) -> bool:
        dt = _clock() - self.t0
        if self.rf is not None:
            self.rf.__exit__(et, ev, tb)
        st = self.st
        st[0] += 1
        st[1] += dt
        if dt > st[2]:
            st[2] = dt
        st[3] += self.samples
        return False


class StageTimer:
    """Host time of a session loop, by stage: a count, a total and the
    longest of each, and samples/s rates.  A stage times the host's own
    work on it, the enqueue of the card's work and any wait inside it
    (``dsp`` is the enqueue plus the waits inside it); each wait is also
    kept on its own line, ``wait.<site>``, and each tallied event (no
    time) on its own line last.  The card's time per layer comes from the
    ``tpuProfile`` trace."""

    def __init__(self):
        # name -> [count, total s, longest s, samples]
        self.stats: Dict[str, list] = {}
        # name -> count of an untimed event (the display chain's route)
        self.tallies: Dict[str, int] = {}

    def stage(self, name: str, samples: int = 0) -> _Timed:
        """Time a ``with`` block as stage ``name``, in span
        ``kspec.<name>``."""
        st = self.stats.get(name)
        if st is None:
            st = self.stats.setdefault(name, [0, 0.0, 0.0, 0])
        return _Timed(st, name, samples)

    def wait(self, site: str) -> _Timed:
        """Time a ``with`` block in which the host waits (for the card or
        a worker thread) as ``wait.<site>``, in span
        ``kspec.wait.<site>``."""
        return self.stage(WAIT + site)

    def tally(self, name: str) -> None:
        """Count one untimed ``name`` event (``display.fold`` or
        ``display.plain``: the route a step's display chain took)."""
        self.tallies[name] = self.tallies.get(name, 0) + 1

    def count(self, name: str) -> int:
        """Times stage (or ``wait.<site>``, or tallied event) ``name``
        ran."""
        if name in self.stats:
            return self.stats[name][0]
        return self.tallies.get(name, 0)

    def total(self, name: str) -> float:
        """Host seconds of stage (or ``wait.<site>``) ``name``."""
        return self.stats.get(name, (0, 0.0))[1]

    def rate(self, name: str) -> float:
        """Samples/s over everything recorded for a stage."""
        _, total, _, samples = self.stats.get(name, (0, 0.0, 0.0, 0))
        return samples / total if total else 0.0

    def report(self) -> str:
        lines = ["host time by stage (the card's time is in the tpuProfile "
                 "trace); a stage includes the waits inside it:"]
        for name in sorted(self.stats, key=lambda k: k.startswith(WAIT)):
            n, total, longest, samples = self.stats[name]
            line = (f"{name}: n={n} total={total * 1e3:.3f}ms "
                    f"mean={total / n * 1e3:.3f}ms max={longest * 1e3:.3f}ms")
            if samples:
                line += f" rate={self.rate(name) / 1e6:.2f} Msamp/s"
            lines.append(line)
        lines += [f"{name}: n={n}" for name, n in sorted(self.tallies.items())]
        return "\n".join(lines)

    def log_report(self):
        for line in self.report().splitlines():
            log_info(f"profile: {line}")


_installed: contextvars.ContextVar[Optional[StageTimer]] = (
    contextvars.ContextVar("kspec_stage_timer", default=None))


@contextlib.contextmanager
def installed(timer: StageTimer) -> Iterator[StageTimer]:
    """Make ``timer`` the one that :func:`wait` records into while the
    block runs (a session loop installs its own)."""
    token = _installed.set(timer)
    try:
        yield timer
    finally:
        _installed.reset(token)


def wait(site: str):
    """The wait site ``site`` of code without a session handle: recorded
    into the installed :class:`StageTimer`, else the span alone."""
    timer = _installed.get()
    if timer is not None:
        return timer.stage(WAIT + site)
    return span(WAIT + site)


def tally(name: str) -> None:
    """Count one untimed ``name`` event into the installed
    :class:`StageTimer`; nothing without one."""
    timer = _installed.get()
    if timer is not None:
        timer.tally(name)


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
