"""CPU tests of the benchmark harness (``portbench/``).

Each cell is rehearsed at a tiny size on CPU tensors, through the same
entry and source as on the card; the port's kernels then run their plain
PyTorch versions.  Run with ``python -m pytest portbench/tests``; the test
marked ``gpu`` runs each cell on the card and skips without one.
"""
from __future__ import annotations

import ast
import copy
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import (cells, controls, reference, roofline, run,  # noqa: E402
                       tracing)

CELLS = ["zs2048k50.u8-capture", "zs16384o90.u8-capture"]
SEED = (1 << 31) + 977      # past 32 signed bits
# On the CPU the port runs its float32 plain chain, whose rounding reaches
# 2.2e-5 of a bin at fft 16384; the configurations' limits hold the card's
# float64 kernel, and a float32 chain fails them.
CPU_LIMITS = {"spectra_rel_err": 1e-4, "display_db_err": 1e-2}


def tiny(cell, blocks=8, batch=2):
    """The cell's traffic mix at ``blocks`` capture blocks, ``batch``
    blocks a step, and a profile of three steps after the first."""
    full = reference.geometry(cell.config["spec"]).full_size
    t = copy.deepcopy(cell.traffic)
    t.update(capture_samples=blocks * full, step_samples=batch * full,
             kept_from=4, kept_steps=2, warm_steps=1,
             trace={"after_steps": 1, "steps": 3})
    return t


def rehearse(workload, seconds=None, trace=False, root=ROOT,
             limits=CPU_LIMITS, size=(8, 2), **kw):
    """A CPU run of ``workload`` at :func:`tiny` size ``(blocks, batch)``,
    held to ``limits`` (None: the configuration's); a traced one runs long
    enough for the profiler to start on the CPU."""
    cell = cells.load(workload, root)
    seconds = seconds or (4.0 if trace else 0.3)
    return run.run_cell(workload, SEED, seconds, trace, "cpu",
                        time.perf_counter(), traffic=tiny(cell, *size),
                        root=root, limits=limits, **kw)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_rehearse_cell(workload, trace):
    result, checks = rehearse(workload, trace=trace)
    assert set(checks) == {"spectra_rel_err", "display_db_err",
                           "hm_index_err", "blocks_err"}
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert checks["hm_index_err"][0] == 0 and checks["blocks_err"][0] == 0
    assert checks["display_db_err"][0] <= checks["display_db_err"][1]
    assert 0 < checks["spectra_rel_err"][0] < CPU_LIMITS["spectra_rel_err"]
    assert list(result)[-1] == "checks"
    if trace:
        assert "breakdown" in result and result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {"capture_msamp_s", "setup_s"}
        assert result["metrics"]["capture_msamp_s"]["value"] > 0


def test_fft2048_rehearsal_is_correct():
    result, _ = rehearse(CELLS[0])
    assert result["correct"]


_CHILD = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench import run, cells
import copy
cell = cells.load({w!r})
t = json.loads({t!r})
res, _ = run.run_cell({w!r}, {seed}, 0.2, {trace}, "cpu", time.perf_counter(),
                      traffic=t)
print(json.dumps({{"forbidden": run.forbidden_loaded(),
                  "port": "kspecanal_tpu_torch" in sys.modules}}))
"""


@pytest.mark.parametrize("workload", CELLS)
def test_run_loads_no_jax(workload):
    """After a rehearsal, the process holds no module whose top-level name
    is jax, jaxlib, flax or kspecanal_tpu (the port's own name begins with
    the last and does not count)."""
    t = json.dumps(tiny(cells.load(workload)))
    code = _CHILD.format(root=str(ROOT), w=workload, t=t, seed=SEED,
                         trace=True)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port": True}


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kspecanal_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_loaded() == ["jax"]


@pytest.mark.parametrize("name", ["reference.py", "capture.py",
                                  "roofline.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    tree = ast.parse((ROOT / "portbench" / name).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods <= {"__future__", "dataclasses", "math", "typing", "numpy",
                    "torch", "time", "portbench"}, mods


def test_reference_process_holds_no_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference, "
            "portbench.capture, portbench.roofline; print(sorted({m.split('.')"
            "[0] for m in sys.modules} & {'kspecanal_tpu_torch', "
            "'kspecanal_tpu', 'jax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


@pytest.mark.parametrize("workload,ms", [(CELLS[0], 0.111),
                                         (CELLS[1], 0.658)])
def test_frozen_bound_per_step(workload, ms):
    cell = cells.load(workload)
    g = reference.geometry(cell.config["spec"])
    batch = int(cell.traffic["step_samples"]) // g.full_size
    got, by = roofline.curscan_bound_ms(g.fft_size, g.num_windows,
                                        g.full_size, batch, 1)
    assert by == "operations"
    assert round(got, 3) == ms


def _copy_bench(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_parts_found_by_name(tmp_path):
    """A configuration, a mix and a metric added as files and entries, in a
    copy, run without a change to any file the benchmark has."""
    root = _copy_bench(tmp_path)
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "zs-fft2048-kaiser50.json")
                      .read_text())
    conf["name"] = "zs-fft1024-hann50"
    conf["spec"].update(fft_size=1024, window="WIN.HANNING")
    (pb / "configs" / "zs-fft1024-hann50.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "u8-capture.json").read_text())
    mix.update(name="cf32-capture", format="cf32")
    (pb / "traffic" / "cf32-capture.json").write_text(json.dumps(mix))
    (pb / "metrics" / "steps_traced.py").write_text(
        "def read(view):\n    return float(view.steps)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "zs-fft1024-hann50", "source": "https://example.org/x",
        "file": "portbench/configs/zs-fft1024-hann50.json", "reduced": [],
        "why": "throwaway"})
    bench["workloads"].append({
        "name": "zs1024h50.cf32-capture", "config": "zs-fft1024-hann50",
        "traffic": "cf32-capture", "chips": 1, "why": "throwaway"})
    bench["per_layer"].append({
        "name": "steps_traced", "unit": "steps", "better": "higher",
        "source": "device_trace", "layer": "session step",
        "moves": "capture_msamp_s", "workloads": ["zs1024h50.cf32-capture"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load("zs1024h50.cf32-capture", root)
    assert cell.config["spec"]["fft_size"] == 1024
    assert cell.traffic["format"] == "cf32"
    assert [m["name"] for m in cell.per_layer] == ["steps_traced"]
    result, checks = rehearse("zs1024h50.cf32-capture", trace=True,
                              root=root)
    assert list(result["metrics"]) == ["steps_traced"]
    assert 1.0 <= result["metrics"]["steps_traced"]["value"] <= 3.0
    assert result["correct"], checks


def test_no_result_without_a_card_or_the_program(tmp_path):
    """Without CUDA, or in a directory holding only BENCHMARK.json and the
    benchmark's files, a run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cmd = [sys.executable, "portbench/run.py", "--workload", CELLS[0],
           "--seed", str(SEED), "--seconds", "1", "--trace", "0"]
    for cwd in (ROOT, _copy_bench(tmp_path)):
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300, cwd=str(cwd))
        assert out.returncode != 0 and out.stdout == ""


def _event(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def synthetic_view():
    """Two steps: a curscan kernel (100 us) and a display kernel (20 us)
    each, one host sync a step, and a gap of 30 us before each display
    kernel while the host launches it."""
    ev = []
    for i, t in enumerate((0.0, 1000.0)):
        ev.append(_event("user_annotation", "portbench.step", t, 400))
        ev.append(_event("user_annotation", "portbench.curscan", t + 10, 50))
        ev.append(_event("cuda_runtime", "cudaLaunchKernel", t + 20, 5,
                         10 * i + 1))
        ev.append(_event("kernel", "fft", t + 30, 100, 10 * i + 1))
        ev.append(_event("user_annotation", "portbench.display", t + 100,
                         200))
        ev.append(_event("cuda_runtime", "cudaStreamSynchronize", t + 110,
                         30))
        ev.append(_event("cpu_op", "aten::log10", t + 150, 20))
        ev.append(_event("cuda_runtime", "cudaLaunchKernel", t + 155, 5,
                         10 * i + 2))
        ev.append(_event("kernel", "log10", t + 160, 20, 10 * i + 2))
    ev.append(_event("kernel", "queued_before", -50.0, 40, 99))
    cell = {"fft_size": 2048, "num_windows": 15, "full_size": 16384,
            "batch": 4096, "plane_bytes": 1}
    return tracing.TraceView({"traceEvents": ev}, 2, cell)


@pytest.mark.parametrize("metric,want", [
    ("host_syncs_per_step", 1.0),
    ("launches_per_step", 2.0),
    ("display_ms_per_step", 0.02),
    ("curscan_roofline",
     100 * roofline.curscan_bound_ms(2048, 15, 16384, 4096, 1)[0] / 0.1),
    ("device_idle_share", 100 * (1 - 240 / 1150)),
])
def test_metric_readers(metric, want):
    assert cells.reader(metric)(synthetic_view()) == pytest.approx(want)


def test_breakdown_and_window():
    view = synthetic_view()
    assert view.window() == (30.0, 1180.0)
    assert view.busy_us() == 240.0
    b = view.breakdown()
    assert b["device_ops"][0] == ["fft", pytest.approx(200e-6)]
    labels = dict((k, v) for k, v in b["idle_gaps"])
    assert labels["display: aten::log10"] == pytest.approx(60e-6)
    assert labels["curscan: python"] == pytest.approx(850e-6)


def test_readers_find_nothing_without_device_events():
    view = tracing.TraceView({"traceEvents": []}, 3, {})
    for m in ("host_syncs_per_step", "launches_per_step",
              "display_ms_per_step", "curscan_roofline",
              "device_idle_share"):
        assert cells.reader(m)(view) is None


def test_merge_arithmetic():
    assert tracing.merge([(0, 2), (1, 3), (5, 6), (9, 12)], (0, 10)) == [
        (0, 3), (5, 6), (9, 10)]
    assert tracing.merge([], (0, 10)) == []


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    """One short run of each cell on the card: correct, with its end-to-end
    metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1500, cwd=str(ROOT),
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("control", ["DEFAULT", "HIGH", "float32"])
def test_control_comes_out_not_correct(workload, control):
    """The controls, held to the configuration's own limits: the program's
    bfloat16 paths at tpuPrecision DEFAULT and HIGH (on the CPU their
    plain versions, which round the operands as the kernels do), and the
    plain reference computed in float32 in the program's place.  Steps of
    8 blocks: the float32 chain's worst bin at fft 2048 grows with the
    rows compared, and 2 blocks a step can read under the limit."""
    spec = cells.load(workload).config["spec"]
    with controls.planted(control, spec) as precision:
        result, checks = rehearse(workload, precision=precision,
                                  limits=None, size=(32, 8))
    assert not result["correct"]
    value, limit = checks["spectra_rel_err"]
    assert value > (limit if control == "float32" else 10 * limit)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault,check", [
    ("state_unchanged", "blocks_err"),
    ("half_batch", "spectra_rel_err"),
    ("altered", "spectra_rel_err"),
])
def test_broken_path_comes_out_not_correct(workload, fault, check):
    """The run with the timed path broken underneath: a step that returns
    its state unchanged; half of each batch left out and the mean of the
    rest in its place; one answer altered where it is made.  (One card: no
    exchange between chips to leave out.)"""
    with controls.planted(fault, cells.load(workload).config["spec"]):
        result, checks = rehearse(workload)
    assert not result["correct"]
    value, limit = checks[check]
    assert value > limit
