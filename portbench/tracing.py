"""The traced run: the benchmark's spans around the program's layers, the
profiler over a steady stretch of session steps, and the reading of its
trace.

Spans wrap module attributes of the program with
``torch.profiler.record_function`` for the traced run only, so a layer
that a later change rewrites is read the same way.  The profiler starts
at a step boundary after ``after_steps`` steps of the window, runs for
``steps`` steps, waits for the card and stops; its Chrome trace is written
under ``TMPDIR``, read, and deleted.  A device operation belongs to the
stretch when the runtime call that launched it is in the trace, and to a
span when that call lies inside the span.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_OP_CATS = ("cpu_op", "user_annotation")
# Runtime calls on which the host waits for the card.
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemcpyFromSymbol", "cudaMemcpyToSymbol",
              "cuCtxSynchronize", "cuStreamSynchronize",
              "cuEventSynchronize")


@contextlib.contextmanager
def spans(targets: Dict[str, str]) -> Iterator[None]:
    """Wrap each ``"module:attribute"`` of ``targets`` in a profiler range
    named ``portbench.<span>`` while the block runs."""
    done = []
    try:
        for name, where in targets.items():
            mod_name, attr = where.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            setattr(mod, attr, _ranged(SPAN_PREFIX + name, orig))
            done.append((mod, attr, orig))
        yield
    finally:
        for mod, attr, orig in reversed(done):
            setattr(mod, attr, orig)


def _ranged(label: str, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def merge(intervals: Iterable[Tuple[float, float]],
          window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to ``window``, as sorted
    disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, window[0]), min(e, window[1]))
                       for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Event:
    name: str
    ts: float       # microseconds
    dur: float
    corr: Optional[int]

    @property
    def end(self) -> float:
        return self.ts + self.dur


class TraceView:
    """The events of a traced stretch of ``steps`` session steps, and
    ``cell``: the numbers of the cell that readers need (sizes, batch)."""

    def __init__(self, trace: Dict, steps: int, cell: Dict):
        self.steps = steps
        self.cell = cell
        runtime, device, host = [], [], []
        self.span_ranges: Dict[str, List[Tuple[float, float]]] = (
            defaultdict(list))
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            e = Event(ev.get("name", ""), float(ev.get("ts", 0.0)),
                      float(ev.get("dur", 0.0)),
                      (ev.get("args") or {}).get("correlation"))
            if cat in DEVICE_CATS:
                device.append(e)
            elif cat in RUNTIME_CATS:
                runtime.append(e)
            elif cat in HOST_OP_CATS:
                host.append(e)
                if cat == "user_annotation" and e.name.startswith(
                        SPAN_PREFIX):
                    self.span_ranges[e.name[len(SPAN_PREFIX):]].append(
                        (e.ts, e.end))
        for v in self.span_ranges.values():
            v.sort()
        self.runtime = sorted(runtime, key=lambda e: e.ts)
        launch = {e.corr: e for e in self.runtime if e.corr is not None}
        # Device operations launched inside the trace, with their launch.
        self.device = sorted(((d, launch[d.corr]) for d in device
                              if d.corr in launch),
                             key=lambda p: p[0].ts)
        self.host = sorted(host, key=lambda e: e.ts)
        self._host_ts = [e.ts for e in self.host]

    # -- what readers ask -------------------------------------------------
    @property
    def has_device(self) -> bool:
        return bool(self.device)

    def in_span(self, name: str, t: float) -> bool:
        """Whether host time ``t`` lies inside a ``name`` span."""
        ranges = self.span_ranges.get(name, [])
        i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
        return i >= 0 and ranges[i][0] <= t <= ranges[i][1]

    def stretch(self) -> Optional[Tuple[float, float]]:
        """Host time from the first step span's start to the last's end."""
        steps = self.span_ranges.get("step")
        if not steps:
            return None
        return steps[0][0], max(e for _, e in steps)

    def launched_in(self, name: str) -> List[Event]:
        """Device operations launched inside ``name`` spans."""
        return [d for d, r in self.device if self.in_span(name, r.ts)]

    def launched_in_stretch(self) -> List[Event]:
        st = self.stretch()
        if st is None:
            return []
        return [d for d, r in self.device if st[0] <= r.ts <= st[1]]

    def syncs_in_stretch(self) -> List[Event]:
        """Runtime calls on which the host waited for the card, from the
        first step's start to the last step's end."""
        st = self.stretch()
        if st is None:
            return []
        return [e for e in self.runtime
                if e.name in SYNC_CALLS and st[0] <= e.ts <= st[1]]

    def window(self) -> Optional[Tuple[float, float]]:
        """Device time from the first traced operation's start to the last
        one's end (microseconds)."""
        if not self.device:
            return None
        return (self.device[0][0].ts,
                max(d.end for d, _ in self.device))

    def busy_us(self) -> float:
        win = self.window()
        if win is None:
            return 0.0
        return sum(e - s for s, e in merge(
            ((d.ts, d.end) for d, _ in self.device), win))

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was launching when the card went
        idle: the innermost host operation around the launch that ended
        the gap, with the benchmark's span around it."""
        per_op: Dict[str, float] = defaultdict(float)
        for d, _ in self.device:
            per_op[d.name] += d.dur * 1e-6
        gaps: Dict[str, float] = defaultdict(float)
        busy_end = None
        for d, r in self.device:
            if busy_end is not None and d.ts > busy_end:
                gaps[self._label(r.ts)] += (d.ts - busy_end) * 1e-6
            busy_end = d.end if busy_end is None else max(busy_end, d.end)

        def ranked(table):
            return [[k, v] for k, v in sorted(table.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(per_op), "idle_gaps": ranked(gaps)}

    def _label(self, t: float) -> str:
        i = bisect.bisect_right(self._host_ts, t) - 1
        op = None
        for j in range(i, max(-1, i - 256), -1):
            e = self.host[j]
            if e.ts <= t <= e.end and not e.name.startswith(SPAN_PREFIX):
                op = e.name
                break
        span = next((n for n in self.span_ranges
                     if n != "step" and self.in_span(n, t)), "step")
        return f"{span}: {op or 'python'}"


class StepProfiler:
    """A source hook that profiles steps ``after + 1`` to ``after +
    steps`` of a session, and the :class:`TraceView` of them
    (``view``)."""

    def __init__(self, after: int, steps: int, cell: Dict):
        self.after, self.steps, self.cell = after, steps, cell
        self.seen = 0
        self.prof = None
        self.view: Optional[TraceView] = None

    def __call__(self, _source) -> None:
        self.seen += 1
        if self.seen == self.after + 1:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        elif self.seen == self.after + self.steps + 1:
            self._stop(self.steps)

    def finish(self) -> Optional[TraceView]:
        """Stop a profiler that the window's end left running."""
        if self.prof is not None and self.view is None:
            self._stop(self.seen - self.after)
        return self.view

    def _stop(self, steps: int) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        self.view = TraceView(trace, steps, self.cell)
