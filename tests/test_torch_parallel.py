"""The port's sharded paths (``kspecanal_tpu_torch/parallel``) against the
JAX package's, on the CPU.

The JAX side runs in this process on conftest's 8 virtual CPU devices.
The port's side runs in gloo worlds of 1, 2 and 4 ranks, each a set of
processes of ``tests/torch_mp_worker.py`` with JAX blocked, spawned once
by a module fixture that computes every case of that world size; a fourth
world (2 ranks) runs the two CLI sessions.  Cases, mirroring
tests/test_parallel.py: the time-sharded curscan in every cumulate mode
and at a fractional hop, the fft-sharded curscan (AVG, MAX), the
band-sharded sweep (8 bands, and 7 with a failed retune: sentinel
padding), the sharded stream (float32 and u8 planes; rows gathered to rank
0); the plan and its refusal on the host; ``zeroSpan ... tpuMeshTime 2``,
``scan ... tpuMeshBand 2`` and ``scan ... tpuMeshTime 2`` (an axis the
mode does not split) through both CLIs, their ``tpuStateFile`` checkpoints
compared.

Tolerance: the per-bin bound of ``torch_parity`` (rtol 5e-5 plus atol 1e-6
of the peak), on linear spectra and on dB curves alike; against the
port's unsharded run MAX/MIN of the time-sharded curscan are bit-identical
(the per-window spectra are) and the band-sharded sweep equals
``sweep_step`` exactly.  Plans and padding are exact."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu import cli as jcli
from kspecanal_tpu.config import SpecConfig as JSpecConfig
from kspecanal_tpu.models import scan as jscan
from kspecanal_tpu.parallel import bandshard as jband
from kspecanal_tpu.parallel import fftshard as jfft
from kspecanal_tpu.parallel import stream as jstream
from kspecanal_tpu.parallel import timeshard as jtime
from kspecanal_tpu.parallel.mesh import make_mesh as jmesh
from kspecanal_tpu_torch import cli as tcli
from kspecanal_tpu_torch.models import scan as tscan
from kspecanal_tpu_torch.models.convert import scan_state_to_numpy
from kspecanal_tpu_torch.ops import spectrum as tspec
from kspecanal_tpu_torch.parallel import fftshard as tfft
from kspecanal_tpu_torch.parallel import timeshard as ttime
from torch_parity import (assert_spectra_close,  # noqa: F401
                          restore_jax_iter_logging, write_capture)

import torch_mp_worker as W

WORLDS = (1, 2, 4)


def assert_bound(got, want):
    """Per bin: rtol 5e-5 plus atol 1e-6 of the peak (dB curves too)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=5e-5,
                               atol=1e-6 * np.max(np.abs(want)))


def jcfg_of(cfg):
    """The JAX package's SpecConfig of the port's (the same fields)."""
    return JSpecConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(S)``: the cases' results of a gloo world of S ranks, spawned
    on first use."""
    done = {}

    def get(s):
        if s not in done:
            out = str(tmp_path_factory.mktemp(f"world{s}"))
            ranks = W.spawn_world("cases", s, out)
            for rc, text in ranks:
                assert rc == 0, text[-3000:]
            done[s] = dict(np.load(os.path.join(out, f"world{s}.npz")))
        return done[s]
    return get


CURSCAN_CASES = W.TIME_CASES + W.FFT_CASES


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("case", CURSCAN_CASES,
                         ids=[c[0] for c in CURSCAN_CASES])
def test_sharded_curscan_matches_jax(world, case, s):
    """The time-sharded (halo exchange, every cumulate mode, a fractional
    hop) and the fft-sharded curscan against JAX's at the same S, and
    against the port's unsharded curscan."""
    name, *c = case
    seed = CURSCAN_CASES.index(case)
    cfg = W.zs_cfg(*c)
    re, im = W.iq(cfg, seed)
    jmod = jfft.curscan_fft_sharded if name.startswith("fft") \
        else jtime.curscan_time_sharded
    want = np.asarray(jmod(jnp.asarray(re), jnp.asarray(im), jcfg_of(cfg),
                           jmesh(time=s)))
    got = world(s)[name]
    assert_spectra_close(got, want)
    plain = tspec.curscan(torch.from_numpy(re), torch.from_numpy(im),
                          cfg).numpy()
    if name in ("time-MAX", "time-MIN"):
        np.testing.assert_array_equal(got, plain)
    else:
        assert_spectra_close(got, plain)


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("case", W.FFT_CLASS_CASES,
                         ids=[c[0] for c in W.FFT_CLASS_CASES])
def test_fft_sharded_classes_match_jax(world, case, s):
    """The fft-sharded curscan's products at HIGH and DEFAULT
    (``mxu_fft.class_matmul``) against JAX's at the same S, whose float32
    dots ignore the class on the CPU: the class tolerances of
    test_torch_precision.py."""
    from test_torch_precision import assert_class_close, window_peak
    name, *c = case
    cfg = W.zs_cfg(*c)
    re, im = W.iq(cfg, (CURSCAN_CASES + W.FFT_CLASS_CASES).index(case))
    want = np.asarray(jfft.curscan_fft_sharded(
        jnp.asarray(re), jnp.asarray(im), jcfg_of(cfg), jmesh(time=s)))
    assert_class_close(world(s)[name], want, cfg.tpu_precision,
                       window_peak(re[None], im[None], cfg))


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("case", W.BAND_CASES, ids=[c[0] for c in
                                                    W.BAND_CASES])
def test_band_sharded_sweeps_match_jax(world, case, s):
    """Two sweeps through ``sweep_step_band_sharded`` against JAX's at the
    same S (its padding and stitch) and against the port's unsharded
    ``sweep_step``."""
    name, end, srno, failed = case
    cfg = W.scan_cfg(end, srno)
    plan = tscan.make_scan_plan(cfg)
    re, im, oks = W.sweep(cfg, plan.num_bands, failed,
                          200 + W.BAND_CASES.index(case))
    jc = jcfg_of(cfg)
    jplan = jscan.make_scan_plan(jc)
    jst = jscan.init_state(jc, jplan)
    tst = tscan.init_state(cfg, plan, "cpu")
    for _ in range(2):
        jst = jband.sweep_step_band_sharded(
            jst, jnp.asarray(re), jnp.asarray(im), jnp.asarray(oks), jc,
            jplan, jmesh(time=1, band=s))
        tst = tscan.sweep_step(tst, torch.from_numpy(re),
                               torch.from_numpy(im), torch.from_numpy(oks),
                               cfg, plan)
    got = world(s)
    for f, v in scan_state_to_numpy(tst).items():
        np.testing.assert_array_equal(got[f"{name}-{f}"], v, err_msg=f)
        if f in ("hm_index", "sweep"):
            np.testing.assert_array_equal(got[f"{name}-{f}"],
                                          np.asarray(getattr(jst, f)))
        else:
            assert_bound(got[f"{name}-{f}"], np.asarray(getattr(jst, f)))


@pytest.mark.parametrize("s", WORLDS)
@pytest.mark.parametrize("name", W.STREAM_CASES)
def test_sharded_stream_matches_jax(world, name, s):
    """The sharded stream, float32 and raw u8 planes: rows gathered to rank
    0 and the four curves against JAX's ``waterfall_stream_sharded``."""
    cfg = W.zs_cfg(256, 0.5, "WIN.HANNING", "AVG")
    re, im = W.stream_planes(cfg, name, 100 + W.STREAM_CASES.index(name))
    want = jstream.waterfall_stream_sharded(jnp.asarray(re), jnp.asarray(im),
                                            jcfg_of(cfg), jmesh(time=s))
    got = world(s)
    assert got[f"{name}-rows"].shape == (W.STREAM_T, cfg.x_res)
    for f in ("rows", "fft_max", "fft_min", "fft_avg", "fft_cur"):
        assert_bound(got[f"{name}-{f}"], np.asarray(getattr(want, f)))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_plan_copy_equals_jax(shards):
    """The copied plan equals JAX's (every table), and partitions the
    windows exactly once with AVG weights summing to 1."""
    for nono in (0.5, 0.1):
        cfg = W.zs_cfg(256, nono, "WIN.KAISER", "AVG")
        got = ttime.make_time_shard_plan(cfg, shards)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jtime.make_time_shard_plan(jcfg_of(cfg), shards))
        assert sum(map(sum, got.valid)) == cfg.num_windows
        assert (got.block, got.halo) == (cfg.full_size // shards,
                                         cfg.fft_size)
        assert abs(sum(map(sum, got.weights)) - 1.0) < 1e-9


def test_too_many_shards_rejected():
    cfg = W.zs_cfg(1024, 0.5, "WIN.KAISER", "AVG")
    for shards in (16, 8192):
        with pytest.raises(ValueError, match="too many shards"):
            ttime.make_time_shard_plan(cfg, shards)
    with pytest.raises(ValueError, match="not divisible"):
        ttime.make_time_shard_plan(cfg, 3)
    assert not tfft.supports_fft_sharding(cfg, 64)


def test_mesh_without_a_launched_world_names_torchrun(caplog, monkeypatch):
    """``tpuMeshTime 2`` in a process no launcher started exits non-zero,
    and the message names the torchrun command."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rc = tcli.main(["zeroSpan", "tpuMeshTime", "2", "tpuLogIter", "false",
                    "tpuSource", "synth", "prgLoopCnt", "1"], device="cpu")
    assert rc != 0
    assert "torchrun --nproc-per-node N -m kspecanal_tpu_torch" in caplog.text


ZS_ARGS = ["zeroSpan", "centerFreq", "92e6", "fftSize", "2048", "window",
           "kaiser", "curScanNonOverlap", "0.5", "tpuLogIter", "false",
           "tpuHeadless", "true", "prgLoopCnt", "3"]
SCAN_ARGS = ["scan", "startFreq", "88e6", "endFreq", "97e6", "samplingRate",
             "2e6", "fftSize", "128", "xRes", "128", "window", "hanning",
             "curScanNonOverlap", "0.5", "scanRangeNonOverlap", "0.75",
             "tpuLogIter", "false", "tpuHeadless", "true", "prgLoopCnt", "2"]
# (argv, time, band); the last: a mesh axis the mode does not split, run
# on rank 0 alone while rank 1 waits
CLI_RUNS = {"zerospan-time2": (ZS_ARGS + ["tpuMeshTime", "2"], 2, 1),
            "scan-band2": (SCAN_ARGS + ["tpuMeshBand", "2"], 1, 2),
            "scan-time2-unsplit": (SCAN_ARGS + ["tpuMeshTime", "2"], 2, 1)}


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """Both CLI sessions in one 2-rank gloo world; each reads an rtl_sdr
    capture (float32 planes into the sharded body) and checkpoints to
    ``<name>.npz``.  Returns the directory."""
    out = str(tmp_path_factory.mktemp("cli"))
    runs = []
    for name, (argv, t, b) in CLI_RUNS.items():
        cfg = tcli.parse_args(argv)[0]
        cap = os.path.join(out, f"{name}.iq")
        write_capture(cap, cfg, 30 * cfg.full_size, seed=61)
        runs.append({"argv": argv + ["tpuSource", f"file:{cap}",
                                     "tpuStateFile",
                                     os.path.join(out, f"{name}-port")],
                     "time": t, "band": b})
    with open(os.path.join(out, "cli.json"), "w") as f:
        json.dump(runs, f)
    for rc, text in W.spawn_world("cli", 2, out):
        assert rc == 0, text[-3000:]
    return out


@pytest.mark.parametrize("name", sorted(CLI_RUNS))
def test_mesh_cli_session_matches_jax_cli(cli_world, name):
    """The port's CLI in a 2-rank world and the JAX CLI on its virtual
    mesh, same arguments and capture: the ``tpuStateFile`` checkpoints
    hold the same state."""
    argv = CLI_RUNS[name][0]
    cap = os.path.join(cli_world, f"{name}.iq")
    jpath = os.path.join(cli_world, f"{name}-jax")
    assert jcli.main(argv + ["tpuSource", f"file:{cap}", "tpuStateFile",
                             jpath]) == 0
    with np.load(jpath + ".npz") as j, \
            np.load(os.path.join(cli_world, f"{name}-port.npz")) as t:
        assert sorted(j.files) == sorted(t.files)
        assert str(t["__kind__"]) == str(j["__kind__"])
        for f in j.files:
            if f == "__kind__":
                continue
            if j[f].dtype.kind in "iub" or f == "__fingerprint__":
                np.testing.assert_array_equal(t[f], j[f], err_msg=f)
            else:
                assert_bound(t[f], j[f])
