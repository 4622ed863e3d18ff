"""The readers of the program's own spans (``kspec.step``,
``kspec.curscan``, ``kspec.display``, ``kspec.wait.*``; the port's
``utils/profiling``) on hand-made traces: the split of each complete
step's host time into waits, session loop, curscan wrapper and display
chain."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells, tracing  # noqa: E402

METRICS = ("host_wait_ms_per_step", "loop_host_ms_per_step",
           "curscan_host_ms_per_step", "display_host_ms_per_step")


def _event(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _span(name, start, end):
    return _event("user_annotation", "kspec." + name, start, end - start)


def program_trace(with_steps=True):
    """A stretch (microseconds) that the profiler starts inside a step's
    acquire and stops inside a later one: the cut first step leaves its
    curscan and display (and a wait) without a step span, the cut last
    step ends where its open acquire and wait end.  Between them two
    complete steps:

    A (1000 us): a wait of 30 in acquire, curscan 200 holding a wait of
    20, display 400 holding three waits of 50;
    B (800 us): curscan 100, display 300 holding three waits of 20."""
    ev = [_span("curscan", 0, 50), _event("cpu_op", "aten::empty", 10, 5),
          _span("display", 60, 100), _span("wait.display_weights", 70, 80),
          _event("cuda_runtime", "cudaLaunchKernel", 20, 5, 1),
          _event("kernel", "fft", 30, 60, 1)]
    steps = [(200, 1200), (1300, 2100), (2200, 2500)]
    ev += [_span("acquire", 210, 260), _span("wait.acquire_worker", 220, 250),
           _span("curscan", 300, 500), _span("wait.plan", 320, 340),
           _event("cuda_runtime", "cudaLaunchKernel", 400, 5, 2),
           _event("kernel", "fft", 410, 300, 2),
           _span("display", 600, 1000)]
    ev += [_span("wait.display_weights", t, t + 50) for t in (650, 750, 850)]
    ev += [_span("curscan", 1400, 1500), _span("display", 1600, 1900)]
    ev += [_span("wait.display_weights", t, t + 20)
           for t in (1650, 1700, 1750)]
    ev += [_span("acquire", 2210, 2500), _span("wait.acquire_worker",
                                               2220, 2500),
           _event("cuda_runtime", "cudaDeviceSynchronize", 2300, 190)]
    if with_steps:
        ev += [_span("step", s, e) for s, e in steps]
    return tracing.TraceView({"traceEvents": ev}, 2, {})


@pytest.mark.parametrize("metric,want_us", [
    ("host_wait_ms_per_step", ((30 + 20 + 150) + 60) / 2),
    ("loop_host_ms_per_step", ((1000 - 200 - 400 - 30) + (800 - 400)) / 2),
    ("curscan_host_ms_per_step", ((200 - 20) + 100) / 2),
    ("display_host_ms_per_step", ((400 - 150) + (300 - 60)) / 2),
])
def test_reader_splits_the_complete_steps(metric, want_us):
    assert cells.reader(metric)(program_trace()) == pytest.approx(
        want_us * 1e-3)


def test_the_four_sum_to_the_mean_complete_step():
    view = program_trace()
    total = sum(cells.reader(m)(view) for m in METRICS)
    assert total == pytest.approx((1000 + 800) / 2 * 1e-3)


@pytest.mark.parametrize("case", ["no_step_span", "no_device_event",
                                  "only_cut_steps"])
def test_readers_find_nothing_without_complete_steps(case):
    if case == "no_step_span":      # a program without the spans
        view = program_trace(with_steps=False)
    elif case == "no_device_event":
        view = tracing.TraceView({"traceEvents": [
            _span("step", 0, 100), _event("cpu_op", "aten::add", 120, 5)]},
            1, {})
    else:                           # the profiler cuts the only step
        view = tracing.TraceView({"traceEvents": [
            _span("step", 0, 100), _span("acquire", 10, 100),
            _event("cuda_runtime", "cudaLaunchKernel", 20, 5, 1),
            _event("kernel", "fft", 30, 60, 1)]}, 1, {})
    for m in METRICS:
        assert cells.reader(m)(view) is None


def test_the_benchmark_declares_the_four():
    per_layer = {m["name"]: m for m in cells.load(
        "zs2048k50.u8-capture").per_layer}
    for m in METRICS:
        assert per_layer[m]["unit"] == "ms/step"
        assert per_layer[m]["moves"] == "capture_msamp_s"
        assert per_layer[m]["source"] == "device_trace"
