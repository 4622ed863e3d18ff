"""The port stands alone: ``kspecanal_tpu_torch`` imports nothing of the JAX
package, and its copies of the JAX package's host modules (config, CLI
parser, host sources, replay, logging) stay equal to their originals.

  * a subprocess with ``jax``, ``jaxlib`` and ``kspecanal_tpu`` made
    unimportable imports every module of the port and runs sessions through
    the port's ``cli.main`` on the CPU (zero-span serial, catch-up and from
    a u8 file, fmScan, quickFullScan, zeroSpanSave then zeroSpanPlay at
    fftSize 3000, ``tpuStateFile`` resumes and a ``tpuRenderer png:``
    session), ``tools.main`` analyses a capture from the port's
    ``make_fixture``, and a 2-rank gloo world runs a ``tpuMeshTime 2``
    session the same way;
  * an AST walk finds no import of ``kspecanal_tpu`` (module level or inside
    a function) in the package (``parallel/`` and ``scripts/`` among it),
    ``chip_smoke.py``, ``tests/test_torch_gpu.py`` or the gloo worker
    ``tests/torch_mp_worker.py``;
  * drift tests hold each copy to its original: parsed configs and run
    options over a table of argument lists, the window tables, weights,
    window starts and scan plan over a grid, the host sources' samples
    from one seed, the checkpoint fingerprint of ``io/state`` and the
    route's factor rule (``_factorize``, ``supports_fused``), and the
    sharded paths' copies (``make_time_shard_plan``, ``_dft_tables_for``,
    ``supports_fft_sharding``), the matplotlib renderer ``gui.py`` (its
    code, docstrings aside) and the fixture writer's ``make_capture``."""
import ast
import dataclasses
import os
import subprocess
import sys

import json

import numpy as np
import pytest

import kspecanal_tpu.cli as jcli
import kspecanal_tpu.config as jcfg
from kspecanal_tpu.io import replay as jreplay
from kspecanal_tpu.io import sources as jsrc
from kspecanal_tpu.models import scan as jscan
from kspecanal_tpu_torch import cli as tcli
from kspecanal_tpu_torch import config as tcfg
from kspecanal_tpu_torch.io import replay as treplay
from kspecanal_tpu_torch.io import sources as tsrc
from kspecanal_tpu_torch.models import scan as tscan
from torch_parity import write_capture

import torch_mp_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZS = ["zeroSpan", "centerFreq", "92e6", "fftSize", "2048", "window",
      "kaiser", "curScanNonOverlap", "0.5", "tpuLogIter", "false",
      "tpuHeadless", "true"]

FM = ["fmScan", "tpuSource", "synth", "tpuHeadless", "true", "tpuLogIter",
      "false"]
ZS3000 = [a if a != "2048" else "3000" for a in ZS]
# Each session: the argument lists of the cli.main calls it makes in turn.
SESSIONS = {
    "zerospan-serial": [ZS + ["prgLoopCnt", "3", "tpuSource", "synth"]],
    "zerospan-catchup": [ZS + ["prgLoopCnt", "8", "tpuCatchUp", "4",
                               "tpuSource", "synth"]],
    "zerospan-u8-file": [ZS + ["prgLoopCnt", "3", "tpuSource",
                               "file:{cap}"]],
    "fmscan-catchup": [FM + ["prgLoopCnt", "2", "tpuCatchUp", "2"]],
    "quickfullscan-prefetch": [["quickFullScan", "prgLoopCnt", "2",
                                "tpuPrefetch", "true", "tpuSource", "synth",
                                "tpuHeadless", "true", "tpuLogIter",
                                "false"]],
    "zerospan-save-play-3000": [
        ["zeroSpanSave"] + ZS3000[1:] + [
            "zeroSpanSaveFile", "rec.save", "prgLoopCnt", "4", "tpuSource",
            "file:{cap}", "tpuCatchUp", "2"],
        ["zeroSpanPlay", "zeroSpanPlayFile", "rec.save", "tpuHeadless",
         "true", "tpuLogIter", "false"]],
    "zerospan-state-resume": [
        ZS + ["prgLoopCnt", "2", "tpuSource", "synth", "tpuStateFile", "ck"],
        ZS + ["prgLoopCnt", "2", "tpuSource", "synth", "tpuStateFile", "ck",
              "tpuCatchUp", "2"]],
    "fmscan-state-resume": [
        FM + ["prgLoopCnt", "1", "tpuStateFile", "ck"],
        FM + ["prgLoopCnt", "1", "tpuStateFile", "ck"]],
    "zerospan-png-renderer": [ZS + ["prgLoopCnt", "2", "tpuSource", "synth",
                                    "tpuRenderer", "png:Frames"]],
}


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_port_runs_with_jax_and_the_jax_package_blocked(tmp_path, name):
    """Every module of the port imports, and the session runs through
    ``cli.main`` on the CPU, with ``jax``, ``jaxlib`` and ``kspecanal_tpu``
    unimportable."""
    cap = str(tmp_path / "cap.iq")
    cfg, _ = tcli.parse_args(ZS3000)
    write_capture(cap, cfg, 4 * cfg.full_size, seed=47)
    runs = [[a.format(cap=cap) for a in argv] for argv in SESSIONS[name]]
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'kspecanal_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import kspecanal_tpu_torch\n"
        "for m in pkgutil.walk_packages(kspecanal_tpu_torch.__path__,\n"
        "                               'kspecanal_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import kspecanal_tpu_torch.cli as cli\n"
        "for argv in %r:\n"
        "    assert cli.main(argv, device='cpu') == 0\n"
        "assert not any(k == 'jax'\n"
        "               or k.startswith(('jax.', 'kspecanal_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('standalone ok')\n" % runs)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "standalone ok" in proc.stdout
    if name.endswith("state-resume"):
        assert proc.stderr.count("resume: restored state from ck.npz") == 1
    if name.endswith("png-renderer"):
        assert sorted(os.listdir(tmp_path / "Frames")) == [
            "frame_000000.png", "frame_000001.png"]


def test_analyzer_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    """``python -m kspecanal_tpu_torch.tools`` on the CPU (its ``main``
    with ``device="cpu"``), on a capture the port's ``make_fixture``
    writes, with ``jax``, ``jaxlib`` and ``kspecanal_tpu`` unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'kspecanal_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from kspecanal_tpu_torch import tools\n"
        "from kspecanal_tpu_torch.scripts import make_fixture\n"
        "make_fixture.make_capture('cap.iq', 40000)\n"
        "for a in ([], ['decimate', '2']):\n"
        "    assert tools.main(['cap.iq', 'fftSize', '128', 'out',\n"
        "                       'z.npz'] + a, device='cpu') == 0\n"
        "assert not any(k == 'jax'\n"
        "               or k.startswith(('jax.', 'kspecanal_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('analyzer ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "analyzer ok" in proc.stdout
    assert (tmp_path / "z.npz").exists()


def test_mesh_session_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    """A ``tpuMeshTime 2`` zero-span session through ``cli.main`` on each
    rank of a 2-rank gloo world, every rank with ``jax``, ``jaxlib`` and
    ``kspecanal_tpu`` unimportable (the worker checks that none loaded)."""
    argv = ZS + ["prgLoopCnt", "2", "tpuSource", "synth", "tpuMeshTime",
                 "2", "tpuStateFile", str(tmp_path / "ck")]
    (tmp_path / "cli.json").write_text(
        json.dumps([{"argv": argv, "time": 2, "band": 1}]))
    ranks = torch_mp_worker.spawn_world("cli", 2, str(tmp_path))
    for rc, out in ranks:
        assert rc == 0, out[-3000:]
        assert "cli ok" in out
    assert (tmp_path / "ck.npz").exists()


def _imports_of_the_jax_package(path):
    """(line, module) of every import of ``kspecanal_tpu`` in the file,
    anywhere in its syntax tree."""
    tree = ast.parse(open(path).read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == "kspecanal_tpu" or n.startswith("kspecanal_tpu.")]
    return found


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "test_torch_gpu.py"),
             os.path.join(REPO, "tests", "torch_mp_worker.py")]
    for root, _, names in os.walk(os.path.join(REPO, "kspecanal_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_file_of_the_port_imports_the_jax_package():
    files = _port_files()
    assert len(files) > 25
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"kspecanal_tpu_torch/parallel/mesh.py",
            "kspecanal_tpu_torch/parallel/timeshard.py",
            "kspecanal_tpu_torch/parallel/fftshard.py",
            "kspecanal_tpu_torch/parallel/bandshard.py",
            "kspecanal_tpu_torch/scripts/scaling_bench.py",
            "kspecanal_tpu_torch/scripts/collective_bytes.py",
            "kspecanal_tpu_torch/scripts/dryrun_multichip.py",
            "kspecanal_tpu_torch/gui.py", "kspecanal_tpu_torch/tools.py",
            "kspecanal_tpu_torch/scripts/render_demo.py",
            "kspecanal_tpu_torch/scripts/make_fixture.py",
            "kspecanal_tpu_torch/scripts/probe_membw.py",
            "kspecanal_tpu_torch/scripts/fm_ablate.py",
            "kspecanal_tpu_torch/scripts/session_file_ablate.py",
            "kspecanal_tpu_torch/scripts/perf_followup.py",
            "kspecanal_tpu_torch/scripts/perf_r2.py",
            "kspecanal_tpu_torch/scripts/perf_probe.py"} <= rel
    found = {os.path.relpath(f, REPO): _imports_of_the_jax_package(f)
             for f in files}
    assert {f: v for f, v in found.items() if v} == {}


def test_the_ast_walk_sees_imports_inside_functions(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("def f():\n    from kspecanal_tpu.cli import parse_args\n"
                    "import kspecanal_tpu_torch.config\n")
    assert _imports_of_the_jax_package(str(path)) == [(2, "kspecanal_tpu.cli")]


ARGV_TABLE = [
    [],
    ["zeroSpan", "centerFreq", "92e6", "fftSize", "2048", "window", "kaiser",
     "curScanNonOverlap", "0.5"],
    ["ZEROSPAN", "fftsize", "1280", "xRes", "5000", "curScanCumuMode", "max"],
    ["zeroSpan", "fftSize", "512", "xRes", "300", "window", "hanning",
     "curScanCumuMode", "min", "tpuCatchUp", "64", "tpuPrefetch", "true"],
    ["zeroSpanSave", "zeroSpanSaveFile", "rec.bin", "prgLoopCnt", "5"],
    ["zeroSpanPlay", "zeroSpanPlayFile", "rec.bin"],
    ["scan", "startFreq", "88e6", "endFreq", "96e6", "samplingRate", "2e6",
     "fftSize", "128", "xRes", "128", "window", "hanning"],
    ["fmScan"],
    ["fmScan", "tpuCatchUp", "8", "tpuRenderEvery", "band",
     "scanRangeNonOverlap", "0.75"],
    ["quickFullScan"],
    ["quickFullScan", "tpuSource", "file:cap.iq", "tpuDecimate", "2"],
    ["zeroSpan", "tpuPrecision", "high", "tpuEdgeSkipBins", "4",
     "tpuMeshTime", "2", "tpuMeshBand", "2", "tpuProfile", "trace/dir"],
    ["zeroSpan", "tpuRenderer", "PNG:Out/Dir", "tpuStateFile", "s.npz",
     "tpuHeadless", "TRUE", "tpuLogIter", "false", "bDataMin", "false",
     "pltCompress", "avg", "bPltHeatMap", "true", "gain", "30"],
    ["zeroSpan", "saveSigLvls", "base.bin", "adjSigLvls", "base.bin",
     "bUsePSD", "true", "minAmp4Clip", "-80"],
]


@pytest.mark.parametrize("argv", ARGV_TABLE,
                         ids=[" ".join(a[:2]) or "defaults"
                              for a in ARGV_TABLE])
def test_parse_args_copy_equals_the_original(argv):
    jc, jr = jcli.parse_args(argv)
    tc, tr = tcli.parse_args(argv)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tc.window_starts == jc.window_starts
    assert (tc.full_size, tc.x_res, tc.num_windows) == (
        jc.full_size, jc.x_res, jc.num_windows)


@pytest.mark.parametrize("argv", [
    ["zeroSpan", "fftSize"], ["bogusKey", "1"], ["tpuPrecision", "fast"],
    ["tpuRenderEvery", "never"]])
def test_parse_args_copy_raises_the_same_errors(argv):
    with pytest.raises(jcli.CliError) as want:
        jcli.parse_args(argv)
    with pytest.raises(tcli.CliError) as got:
        tcli.parse_args(argv)
    assert str(got.value) == str(want.value)


def test_config_constants_equal_the_original():
    names = [n for n in dir(jcfg) if n.isupper() and not n.startswith("_")]
    assert len(names) > 10
    for n in names:
        assert getattr(tcfg, n) == getattr(jcfg, n), n


@pytest.mark.parametrize("window", [jcfg.WINDOW_KAISER, jcfg.WINDOW_HANNING,
                                    jcfg.WINDOW_ONES])
def test_window_tables_equal_the_original(window):
    for n in (32, 64, 200, 1000, 1280, 2048, 16384):
        np.testing.assert_array_equal(tcfg.window_lut(window, n),
                                      jcfg.window_lut(window, n))
        assert tcfg.win_adj(window, n) == jcfg.win_adj(window, n)


@pytest.mark.parametrize("mode", ["AVG", "RAW", "MAX", "MIN"])
def test_cumu_weights_and_window_starts_equal_the_original(mode):
    for w in (1, 2, 15, 71, 1226):
        a, b = tcfg.cumu_weights(mode, w), jcfg.cumu_weights(mode, w)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for fft in (64, 256, 1280, 2048, 20480):
        for nono in (0.1, 0.25, 0.5, 0.75, 1.0):
            kw = dict(prg_mode="ZEROSPAN", fft_size=fft, x_res=min(fft, 512),
                      cur_scan_non_overlap=nono, cur_scan_cumu_mode=mode)
            assert (tcfg.SpecConfig(**kw).finalize().window_starts
                    == jcfg.SpecConfig(**kw).finalize().window_starts)


@pytest.mark.parametrize("argv", [["fmScan"], ["quickFullScan"], [
    "scan", "startFreq", "88e6", "endFreq", "96e6", "samplingRate", "2e6",
    "fftSize", "128", "xRes", "128", "scanRangeNonOverlap", "0.5"]],
    ids=["fmScan", "quickFullScan", "small"])
def test_scan_plan_of_the_copied_config_equals_the_original(argv):
    jp = jscan.make_scan_plan(jcli.parse_args(argv)[0])
    tp = tscan.make_scan_plan(tcli.parse_args(argv)[0])
    assert tp.num_bands == jp.num_bands
    np.testing.assert_array_equal(np.asarray(tp.freqs_all),
                                  np.asarray(jp.freqs_all))


def test_host_sources_equal_the_original(tmp_path):
    jsyn = jsrc.SynthIQSource(92e6, 2.4e6, seed=48)
    tsyn = tsrc.SynthIQSource(92e6, 2.4e6, seed=48)
    for _ in range(2):
        for a, b in zip(tsyn.read(4096), jsyn.read(4096)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsrc._grid_tone_offsets(92e6, 2.4e6, 1e6),
                                  jsrc._grid_tone_offsets(92e6, 2.4e6, 1e6))
    cfg, _ = tcli.parse_args(ZS)
    cap = str(tmp_path / "cap.iq")
    write_capture(cap, cfg, 3 * cfg.full_size + 5, seed=49)
    pairs = [(tsrc.FileIQSource(cap), jsrc.FileIQSource(cap)),
             (tsrc.DecimatingSource(tsrc.FileIQSource(cap), 2),
              jsrc.DecimatingSource(jsrc.FileIQSource(cap), 2))]
    made = tsrc.make_file_source(cap, 92e6, 2.4e6, 19.1)[0]
    pairs.append((made, jsrc.make_file_source(cap, 92e6, 2.4e6, 19.1)[0]))
    assert type(made).__name__ == type(pairs[-1][1]).__name__
    for t, j in pairs:
        for n in (cfg.full_size, cfg.full_size, 777):
            for a, b in zip(t.read(n), j.read(n)):
                np.testing.assert_array_equal(a, b)
        t.close()
        j.close()
    raw = np.fromfile(cap, np.uint8)[:4000]
    for a, b in zip(tsrc.split_u8_planes(raw), jsrc.split_u8_planes(raw)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsrc.load_rtlsdr_capture(cap, 1000, 7),
                    jsrc.load_rtlsdr_capture(cap, 1000, 7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv", ARGV_TABLE[:-3] + [
    ["scan", "startFreq", "90.8e6", "endFreq", "93.2e6", "fftSize", "512"]],
    ids=[" ".join(a[:2]) or "defaults" for a in ARGV_TABLE[:-3]] + ["scan"])
def test_state_fingerprint_copy_equals_the_original(argv):
    """The port's ``io/state`` names a checkpoint file and fingerprints a
    config as the JAX package's does, so each loads the other's files."""
    from kspecanal_tpu.io import state as jstate
    from kspecanal_tpu_torch.io import state as tstate
    jc, tc = jcli.parse_args(argv)[0], tcli.parse_args(argv)[0]
    np.testing.assert_array_equal(tstate._fingerprint(tc),
                                  jstate._fingerprint(jc))
    for path in ("ck", "ck.npz", "dir/ck.state"):
        assert tstate.state_path(path) == jstate.state_path(path)


def test_factor_rule_copy_equals_the_original():
    """``cuda_curscan._factorize`` and ``FACTOR_OVERRIDES`` (the route's
    copy of ``mxu_fft``'s factor rule) at every n below 4096 and at a
    stride up to 2^20, and ``supports_fused`` on configs from the table."""
    from kspecanal_tpu.ops import mxu_fft
    from kspecanal_tpu.ops import pallas_curscan as jpk
    from kspecanal_tpu_torch.ops import cuda_curscan
    for n in list(range(1, 4096)) + list(range(4096, (1 << 20) + 1, 997)):
        assert cuda_curscan._factorize(n) == mxu_fft._factorize(n), n
    assert cuda_curscan.FACTOR_OVERRIDES == mxu_fft.FACTOR_OVERRIDES
    for argv in ARGV_TABLE:
        for fft in ("2048", "2500", "3000", "39800"):
            jc, tc = (m.parse_args(argv + ["fftSize", fft])[0]
                      for m in (jcli, tcli))
            assert cuda_curscan.supports_fused(tc) == jpk.supports_fused(jc)


def _code_without_docstrings(path, package):
    """The module's syntax tree with every docstring removed and the
    package's name in its imports written as ``kspecanal_tpu``."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], "value", None), ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace(package, "kspecanal_tpu")
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["gui.py", "scripts/make_fixture.py"])
def test_renderer_and_fixture_copies_equal_the_original(module):
    """``gui.py`` is the JAX package's matplotlib renderer with its imports
    taken from the port: the same code, docstrings aside; ``make_capture``
    of the fixture script is the JAX script's."""
    if module == "gui.py":
        got = _code_without_docstrings(
            os.path.join(REPO, "kspecanal_tpu_torch", "gui.py"),
            "kspecanal_tpu_torch")
        want = _code_without_docstrings(
            os.path.join(REPO, "kspecanal_tpu", "gui.py"), "kspecanal_tpu")
        assert got == want
        return

    def make_capture(path):
        fns = [n for n in ast.parse(open(path).read()).body
               if isinstance(n, ast.FunctionDef) and n.name == "make_capture"]
        return ast.dump(fns[0])
    assert make_capture(os.path.join(
        REPO, "kspecanal_tpu_torch", module)) == make_capture(
        os.path.join(REPO, module))


def test_replay_copy_reads_what_the_original_writes(tmp_path):
    path = str(tmp_path / "lvls.bin")
    lvls = np.linspace(-90, -20, 64).astype(np.float32)
    jreplay.save_sig_lvls(path, 88e6, 96e6, lvls)
    got = treplay.load_sig_lvls(path)
    want = jreplay.load_sig_lvls(path)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_time_shard_plan_copy_equals_the_original(shards):
    """``parallel/timeshard.make_time_shard_plan`` against the JAX
    package's over ffts, overlaps and cumulate modes (and the same
    refusals)."""
    from kspecanal_tpu.parallel import timeshard as jtime
    from kspecanal_tpu_torch.parallel import timeshard as ttime
    for fft in (128, 256, 2048, 3000, 16384):
        for nono in (0.1, 0.5, 0.75):
            for mode in ("AVG", "MAX", "RAW"):
                kw = dict(prg_mode="ZEROSPAN", fft_size=fft,
                          x_res=min(fft, 512), cur_scan_non_overlap=nono,
                          cur_scan_cumu_mode=mode)
                tc = tcfg.SpecConfig(**kw).finalize()
                jc = jcfg.SpecConfig(**kw).finalize()
                try:
                    want = dataclasses.asdict(
                        jtime.make_time_shard_plan(jc, shards))
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)):
                        ttime.make_time_shard_plan(tc, shards)
                    continue
                assert dataclasses.asdict(
                    ttime.make_time_shard_plan(tc, shards)) == want


def test_dft_tables_and_fft_sharding_copies_equal_the_original():
    """``ops/mxu_fft._dft_tables_for`` / ``_dft_tables`` and
    ``parallel/fftshard.supports_fft_sharding`` against the JAX
    package's."""
    from kspecanal_tpu.ops import mxu_fft as jmxu
    from kspecanal_tpu.parallel import fftshard as jfft
    from kspecanal_tpu_torch.ops import mxu_fft as tmxu
    from kspecanal_tpu_torch.parallel import fftshard as tfft
    for n in (64, 256, 1280, 2048, 3000, 16384):
        for a, b in zip(tmxu._dft_tables(n), jmxu._dft_tables(n)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tmxu._dft_tables_for(96, 12, 8),
                    jmxu._dft_tables_for(96, 12, 8)):
        np.testing.assert_array_equal(a, b)
    for fft in (127, 128, 256, 1280, 2048, 3000, 16384, 65536):
        for shards in (1, 2, 3, 4, 8, 16):
            kw = dict(prg_mode="ZEROSPAN", fft_size=fft, x_res=min(fft, 512))
            assert tfft.supports_fft_sharding(
                tcfg.SpecConfig(**kw).finalize(), shards) == \
                jfft.supports_fft_sharding(
                    jcfg.SpecConfig(**kw).finalize(), shards)
