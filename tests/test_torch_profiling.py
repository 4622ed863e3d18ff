"""The port's profiler hook (``kspecanal_tpu_torch/utils/profiling.py``):
the busy share of a set of device intervals, ``tpuProfile`` through the
CLI on the CPU, where no CUDA event exists and the share is reported as
absent rather than as 0%, the ``kspec.*`` spans and wait sites a session
puts in that trace, and ``StageTimer``'s host-time report."""
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


def kspec_spans(trace):
    """``name -> [(start, end), ...]`` of the trace's ``kspec.*`` ranges."""
    out = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name", "").startswith("kspec."):
            out.setdefault(ev["name"], []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    return out


def inside(spans, outer):
    return [s for s in spans if outer[0] <= s[0] and s[1] <= outer[1]]


@pytest.mark.parametrize("source,extra,steps,waits", [
    ("devicesynth", ["tpuCatchUp", "4", "prgLoopCnt", "8"], 2,
     {"kspec.wait.display_weights": 3}),
    ("synth", ["prgLoopCnt", "3"], 3, {"kspec.wait.upload": 1})],
    ids=["catchup4", "serial"])
def test_tpu_profile_traces_the_session_steps_and_their_waits(
        tmp_path, caplog, source, extra, steps, waits):
    """One ``kspec.step`` a step, each holding one ``kspec.curscan``, one
    ``kspec.display`` and the step's wait sites; the report counts each
    wait site on its own line."""
    caplog.set_level(logging.INFO, logger="kspecanal_tpu_torch")
    out = tmp_path / "trace"
    assert tcli.main(ZS_ARGS + ["tpuSource", source, "tpuProfile", str(out)]
                     + extra, device="cpu") == 0
    with open(out / trace_files(out)[0]) as f:
        spans = kspec_spans(json.load(f))
    assert len(spans["kspec.step"]) == steps
    for step in spans["kspec.step"]:
        for name in ("kspec.curscan", "kspec.display", "kspec.acquire",
                     "kspec.dsp"):
            assert len(inside(spans[name], step)) == 1, name
        for name, n in waits.items():
            assert len(inside(spans[name], step)) == n, name
    assert len(spans["kspec.wait.drain"]) == 1
    assert not inside(spans["kspec.wait.drain"],
                      (spans["kspec.step"][0][0], spans["kspec.step"][-1][1]))
    text = caplog.text
    assert f"profile: step: n={steps} " in text
    for name, n in waits.items():
        site = name[len("kspec."):]
        assert f"profile: {site}: n={n * steps} " in text
    assert "profile: wait.drain: n=1 " in text


def test_spans_call_no_record_function_while_no_profiler_records(
        monkeypatch):
    """With the RecordFunction entry made to raise, a catch-up session
    runs while no profiler records, and the same session under a profiler
    reaches it."""
    from kspecanal_tpu_torch import session as sess_mod
    from kspecanal_tpu_torch.config import SpecConfig
    from kspecanal_tpu_torch.io.sources import DeviceSynthIQSource
    from torch.profiler import ProfilerActivity, profile

    def refuse(*args, **kwargs):
        raise AssertionError("RecordFunction entered")
    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", refuse)
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=256, x_res=128,
                     prg_loop_cnt=4).finalize()

    def run():
        sess = sess_mod.Session(cfg, DeviceSynthIQSource(device="cpu"),
                                device="cpu", catch_up=2)
        sess_mod.do_run(sess)
        return sess
    sess = run()
    assert sess.timer.count("step") == 2
    assert sess.timer.count("wait.display_weights") == 6
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="RecordFunction entered"):
            run()


def test_stage_timer_keeps_count_total_and_longest(monkeypatch):
    ticks = iter([0.0, 0.002, 1.0, 1.005, 2.0, 2.001, 3.0, 3.004])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("dsp", 10):
            pass
    with timer.wait("emit"):
        pass
    assert timer.count("dsp") == 3 and timer.count("render") == 0
    assert timer.total("dsp") == pytest.approx(0.008)
    assert timer.stats["dsp"][2] == pytest.approx(0.005)
    assert timer.rate("dsp") == pytest.approx(30 / 0.008)
    lines = timer.report().splitlines()
    assert lines[0].startswith("host time by stage")
    assert lines[1].startswith("dsp: n=3 total=8.000ms mean=2.667ms "
                               "max=5.000ms rate=")
    assert lines[2] == ("wait.emit: n=1 total=4.000ms mean=4.000ms "
                        "max=4.000ms")


def test_wait_records_into_the_installed_timer_only():
    outer, inner = profiling.StageTimer(), profiling.StageTimer()
    with profiling.wait("site"):         # no timer: the span alone
        pass
    with profiling.installed(outer):
        with profiling.installed(inner):
            with profiling.wait("site"):
                pass
        with profiling.wait("site"):
            pass
    with profiling.wait("site"):
        pass
    assert inner.count("wait.site") == 1 and outer.count("wait.site") == 1
