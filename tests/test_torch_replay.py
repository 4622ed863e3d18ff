"""The rest of the zero-span path in the port: ``zeroSpanSave``,
``zeroSpanPlay`` and ``tpuStateFile`` checkpoints, through the port's CLI
on the CPU, against the JAX package.

Runs of the port that need no JAX go through ``cli.main`` in a subprocess
in which ``jax``, ``jaxlib`` and ``kspecanal_tpu`` are unimportable; the
JAX package's runs, and the loads across packages, run in this process.

  * the committed recording ``tests/fixtures/reference_zerospan_1024.save``
    (written by the reference program) replays through the port's CLI to
    the JAX replay's final average;
  * save then play at fftSize 3000 (a size the JAX package sends to its
    lane kernel) from one u8 capture file: the recorded spectra and the
    replayed average against the JAX package's save then play;
  * checkpoints: a second session resumes the first one's zero-span and
    scan state; a file written by either package loads in the other; a
    fingerprint or kind mismatch is ignored with a warning.
Tolerances as in ``torch_parity``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kspecanal_tpu import cli as jcli
from kspecanal_tpu import session as jsess
from kspecanal_tpu.io import replay as jreplay
from kspecanal_tpu.io import state as jstate
from kspecanal_tpu.io.sources import SynthIQSource
from kspecanal_tpu_torch import session as tsess
from kspecanal_tpu_torch.io import state as tstate
from kspecanal_tpu_torch.models.convert import (scan_state_to_numpy,
                                                state_to_numpy)
from torch_parity import (assert_db_close, assert_spectra_close,  # noqa: F401
                          restore_jax_iter_logging, write_capture, zs_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures",
                       "reference_zerospan_1024.save")
QUIET = ["tpuLogIter", "false", "tpuHeadless", "true"]
ZS = ["centerFreq", "92e6", "window", "kaiser", "curScanNonOverlap", "0.5"]
SCAN = ["scan", "startFreq", "88e6", "endFreq", "92e6", "samplingRate",
        "2e6", "fftSize", "128", "xRes", "128", "window", "hanning"]


def run_port_blocked(cwd, runs, after=""):
    """``cli.main(argv, device='cpu')`` for each argv of ``runs`` in one
    subprocess with ``jax``, ``jaxlib`` and ``kspecanal_tpu`` blocked; then
    the Python code ``after``.  Returns (return codes, the subprocess'
    stdout and stderr)."""
    code = (
        "import sys, json\n"
        "for m in ('jax', 'jaxlib', 'kspecanal_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import kspecanal_tpu_torch.cli as cli\n"
        "rcs = [cli.main(a, device='cpu') for a in %r]\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', "
        "'kspecanal_tpu.')) for k, v in sys.modules.items() if v is not None)\n"
        "print('RCS', json.dumps(rcs))\n%s" % (runs, after))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RCS ")]
    return json.loads(line[0][4:]), proc.stdout, proc.stderr


def test_reference_recording_replays_like_jax(tmp_path):
    """The reference program's recording (fft 1024, six frames) through the
    port's CLI, with the JAX package blocked, against the JAX CLI's
    replay: the same final average."""
    args = ["zeroSpanPlay", "zeroSpanPlayFile", FIXTURE] + QUIET
    rcs, _, err = run_port_blocked(
        tmp_path, [args + ["saveSigLvls", "port.bin"],
                   args + ["saveSigLvls", "port2.bin", "tpuCatchUp", "4"]])
    assert rcs == [0, 0]
    assert jcli.main(args + ["saveSigLvls", str(tmp_path / "jax.bin")]) == 0
    want = jreplay.load_sig_lvls(str(tmp_path / "jax.bin"))
    for name in ("port.bin", "port2.bin"):
        got = jreplay.load_sig_lvls(str(tmp_path / name))
        assert got[:2] == want[:2] and got[2].shape == (1024,)
        assert_db_close(got[2], want[2])
    # The header carries no fftSize: the first frame's length sets it.
    assert "fftSize[16384] -> recorded frame length [1024]" in err
    freqs = np.fft.fftshift(np.fft.fftfreq(1024, 1 / 2.4e6)) + 92e6
    for f in freqs[np.argsort(want[2])[-3:]]:
        assert abs(f - round(f / 1e6) * 1e6) < 2.4e6 / 1024


def _frames(path):
    with jreplay.ZeroSpanPlayer(path) as p:
        return p.header, [(ts, np.asarray(f)) for ts, f in p.frames()]


def test_save_then_play_at_fft_3000_matches_jax(tmp_path):
    """zeroSpanSave at fftSize 3000 from one u8 capture (the port ships the
    u8 planes to the curscan wrapper, 3 frames a chunk), then zeroSpanPlay
    of the recording, in the port with the JAX package blocked and in the
    JAX package: equal headers, frame count and ascending timestamps,
    spectra within the per-bin bound, replayed averages within 1e-3 dB;
    the replay puts the tones on 91/92/93 MHz."""
    cfg = zs_cfg(3000)
    cap = str(tmp_path / "cap.iq")
    write_capture(cap, cfg, 6 * cfg.full_size, seed=61)
    src = ["tpuSource", f"file:{cap}", "fftSize", "3000"]

    def save(name, extra=()):
        return (["zeroSpanSave", "zeroSpanSaveFile", str(tmp_path / name),
                 "prgLoopCnt", "5"] + ZS + src + QUIET + list(extra))

    def play(name, lvls):
        return (["zeroSpanPlay", "zeroSpanPlayFile", str(tmp_path / name),
                 "saveSigLvls", str(tmp_path / lvls)] + ZS + QUIET)

    rcs, _, _ = run_port_blocked(tmp_path, [
        save("port.save", ["tpuCatchUp", "3"]), play("port.save", "p.bin")])
    assert rcs == [0, 0]
    assert jcli.main(save("jax.save")) == 0
    assert jcli.main(play("jax.save", "j.bin")) == 0
    (ph, pf), (jh, jf) = _frames(str(tmp_path / "port.save")), _frames(
        str(tmp_path / "jax.save"))
    assert ph == jh and len(pf) == len(jf) == 5
    stamps = [ts for ts, _ in pf]
    assert stamps == sorted(stamps) and len(set(stamps)) == 5
    for (_, a), (_, b) in zip(pf, jf):
        assert a.shape == (3000,) and a.dtype == np.float64
        assert_spectra_close(a, b)
    got = jreplay.load_sig_lvls(str(tmp_path / "p.bin"))[2]
    want = jreplay.load_sig_lvls(str(tmp_path / "j.bin"))[2]
    assert_db_close(got, want)
    freqs = np.fft.fftshift(np.fft.fftfreq(3000, 1 / 2.4e6)) + 92e6
    top = sorted(freqs[np.argsort(got)[-3:]])
    np.testing.assert_allclose(top, [91e6, 92e6, 93e6], atol=2.4e6 / 3000)


@pytest.mark.parametrize("kind", ["zerospan", "scan"])
def test_second_session_resumes_the_first(tmp_path, kind):
    """``tpuStateFile``: the second session logs ``resume: restored`` and
    continues the first one's counters (zero-span: 2 + 2 iterations,
    serial then catch-up; scan: 1 + 1 sweeps).  Replaying the checkpoint,
    which is no save stream, returns 1 with an error."""
    base = (["zeroSpan", "fftSize", "2048"] + ZS if kind == "zerospan"
            else SCAN) + ["tpuSource", "synth", "tpuStateFile", "ck"] + QUIET
    runs = ([base + ["prgLoopCnt", "2"],
             base + ["prgLoopCnt", "2", "tpuCatchUp", "2"]]
            if kind == "zerospan" else [base + ["prgLoopCnt", "1"]] * 2)
    after = ("import numpy as np\n"
             "z = np.load('ck.npz')\n"
             "print('STATE', str(z['__kind__']), int(z['%s']))\n"
             % ("iteration" if kind == "zerospan" else "sweep"))
    rcs, out, err = run_port_blocked(
        tmp_path, runs + [["zeroSpanPlay", "zeroSpanPlayFile", "ck.npz"]
                          + QUIET], after)
    assert rcs == [0, 0, 1]
    assert "ck.npz is not a kspecanal save stream" in err
    assert err.count("resume: restored state from ck.npz") == 1
    assert err.count("checkpoint: saved state to ck.npz") == 2
    assert f"STATE {kind} {4 if kind == 'zerospan' else 2}" in out


def _cfg_and_source(kind, tmp_path):
    if kind == "zerospan":
        cfg = zs_cfg(2048, prg_loop_cnt=2, x_res=256)
    else:
        cfg = jcli.parse_args(SCAN + ["prgLoopCnt", "1"])[0]
    return cfg, lambda: SynthIQSource(cfg.center_freq, cfg.sampling_rate,
                                      seed=62)


@pytest.mark.parametrize("kind", ["zerospan", "scan"])
def test_checkpoints_load_in_the_other_package(tmp_path, kind):
    """A state the JAX package checkpoints resumes in the port, on the
    port's device, with every field equal; a state the port checkpoints
    loads in the JAX package, every field equal."""
    cfg, src = _cfg_and_source(kind, tmp_path)
    run_j = jsess.run_zero_span if kind == "zerospan" else jsess.run_scan
    run_t = tsess.run_zero_span if kind == "zerospan" else tsess.run_scan
    to_np = state_to_numpy if kind == "zerospan" else scan_state_to_numpy
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port")
    jst = run_j(jsess.Session(cfg, src(), state_file=jpath))
    got = tsess.Session(cfg, None, device="cpu",
                        state_file=jpath)._resume_state(cfg, kind)
    assert got is not None and got.fft_avg.device == torch.device("cpu")
    for f, v in to_np(got).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jst, f)), f)
    tst = run_t(tsess.Session(cfg, src(), device="cpu", state_file=tpath))
    assert os.path.exists(tpath + ".npz")
    back = jstate.load_state(tpath, cfg, kind=kind)
    for f, v in to_np(tst).items():
        assert np.asarray(getattr(back, f)).dtype == v.dtype
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), v, f)


def test_mismatched_checkpoints_are_ignored_with_a_warning(tmp_path,
                                                           caplog):
    """Another config's checkpoint (fft, x_res) and the other mode's state
    with an equal fingerprint (zero-span 92e6/2.4e6 and scan 90.8-93.2
    MHz) start fresh with a warning, in the port as in the JAX package."""
    import dataclasses
    from kspecanal_tpu_torch.models import zerospan as zs
    caplog.set_level("WARNING", logger="kspecanal_tpu_torch")
    cfg = zs_cfg(512, x_res=256)
    path = str(tmp_path / "ck")
    tstate.save_state(path, zs.init_state(cfg, "cpu"), cfg)
    sess = tsess.Session(cfg, None, device="cpu", state_file=path)
    assert sess._resume_state(cfg, "zerospan") is not None
    for other in (dataclasses.replace(cfg, fft_size=256).finalize(),
                  dataclasses.replace(cfg, x_res=128).finalize()):
        assert sess._resume_state(other, "zerospan") is None
        assert jstate.load_state(path, other, kind="zerospan") is None
    assert sess._resume_state(cfg, "scan") is None
    assert jstate.load_state(path, cfg, kind="scan") is None
    for logger in ("kspecanal_tpu_torch", "kspecanal_tpu"):
        text = "".join(r.getMessage() for r in caplog.records
                       if r.name == logger)
        assert text.count("was written for a different config") == 2
        assert text.count("holds a zerospan state, current mode needs "
                          "scan") == 1
    scan_cfg = jcli.parse_args(["scan", "startFreq", "90.8e6", "endFreq",
                                "93.2e6", "fftSize", "512", "xRes", "256"]
                               + ZS[2:])[0]
    assert np.array_equal(tstate._fingerprint(scan_cfg),
                          tstate._fingerprint(cfg))
