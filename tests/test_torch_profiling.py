"""The port's profiler hook (``kspecanal_tpu_torch/utils/profiling.py``):
the busy share of a set of device intervals, and ``tpuProfile`` through
the CLI on the CPU, where no CUDA event exists and the share is reported as
absent rather than as 0%."""
import json
import logging
import os

import pytest
import torch

from kspecanal_tpu_torch import cli as tcli
from kspecanal_tpu_torch.utils import profiling

ZS_ARGS = ["zeroSpan", "centerFreq", "92e6", "fftSize", "2048", "window",
           "kaiser", "curScanNonOverlap", "0.5", "tpuLogIter", "false",
           "tpuHeadless", "true"]


@pytest.mark.parametrize("intervals,window,want", [
    ([(0.0, 2.0), (1.0, 3.0), (2.5, 4.0)], (0.0, 10.0), 0.4),  # overlapping
    ([(0.0, 1.0), (2.0, 3.0), (5.0, 9.0)], (0.0, 10.0), 0.6),  # disjoint
    ([(3.0, 5.0), (1.0, 2.0), (1.5, 4.0)], (0.0, 8.0), 0.5),   # unsorted
    ([(-2.0, 1.0), (9.0, 12.0)], (0.0, 10.0), 0.2),            # clipped
    ([(0.0, 10.0), (2.0, 3.0)], (0.0, 10.0), 1.0),             # nested
    ([(4.0, 4.0)], (0.0, 10.0), 0.0),                          # empty span
])
def test_busy_share_is_the_union_over_the_window(intervals, window, want):
    assert profiling.busy_share(intervals, window) == pytest.approx(want)


def test_busy_share_without_device_intervals_is_absent():
    assert profiling.busy_share([], (0.0, 1.0)) is None


def test_device_busy_share_of_a_cpu_profile_is_absent():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.fft.fft(torch.randn(4096, dtype=torch.complex64))
    share, seconds = profiling.device_busy_share(prof)
    assert share is None and seconds > 0


def trace_files(path):
    return [f for f in os.listdir(path) if f.endswith(".json")]


@pytest.mark.parametrize("source,extra", [
    ("devicesynth", ["tpuCatchUp", "4", "prgLoopCnt", "8"]),
    ("synth", ["prgLoopCnt", "2"])])
def test_tpu_profile_writes_a_trace_and_reports_the_share_absent(
        tmp_path, caplog, source, extra):
    caplog.set_level(logging.INFO, logger="kspecanal_tpu")
    out = tmp_path / "trace"
    assert tcli.main(ZS_ARGS + ["tpuSource", source, "tpuProfile", str(out)]
                     + extra, device="cpu") == 0
    files = trace_files(out)
    assert len(files) == 1
    with open(out / files[0]) as f:
        assert "traceEvents" in json.load(f)
    text = caplog.text
    assert "device busy share absent" in text
    assert "profiler trace written to" in text
    assert "device busy 0" not in text


def test_trace_directory_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("KSPEC_TRACE_DIR", str(tmp_path))
    with profiling.trace():
        torch.ones(8).sum()
    assert len(trace_files(tmp_path)) == 1


def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.delenv("KSPEC_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace(None):
        torch.ones(8).sum()
    assert os.listdir(tmp_path) == []
