"""Smoke test of the PyTorch/CUDA port (``kspecanal_tpu_torch``) on one
NVIDIA card: builds the CUDA kernels from ``kspecanal_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the
zero-span waterfall path through its entry points and checks the results.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. environment: torch, CUDA, nvcc, the card and its power limit;
  2. build of the kernels, with ptxas' register/shared-memory report;
  3. the curscan kernel against its plain version (``torch.fft``) at the
     main path's config (fft 2048, kaiser, 50% overlap, 2.4 Msps) in all
     four cumulate modes, u8 input bit-identical to decoded float32, the
     error of both against a complex128 reference, and fft 2048 at 90%
     overlap, fft 256 hanning and the largest fft the kernel takes;
  4. ``parallel.stream`` over 16384 blocks (268 M samples, ~112 s of
     2.4 Msps IQ made on the card) in chunks of 1024, against the plain
     path on the same data;
  5. the main path: ``kspecanal_tpu_torch.cli.main`` serial, catch-up and
     on a u8 capture file; every run must launch the kernel and put the
     synth peaks of its final average on 91/92/93 MHz;
  6. kernel and plain times at T=4096 (CUDA events, median of 10).
The line before the last lists each kernel with its launches on the main
path, its error and times; the last line is the device record.
"""
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
MAIN_ARGS = ["zeroSpan", "centerFreq", "92e6", "fftSize", "2048", "window",
             "kaiser", "curScanNonOverlap", "0.5", "tpuLogIter", "false"]
PEAKS_HZ = (91e6, 92e6, 93e6)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cfg_of(fft=2048, nono=0.5, mode="AVG", window="WIN.KAISER"):
    from kspecanal_tpu_torch import SpecConfig
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=window, cur_scan_non_overlap=nono,
                      cur_scan_cumu_mode=mode,
                      x_res=min(512, fft)).finalize()


def noise(cfg, t, u8, gen):
    shape = (t, cfg.full_size)
    if u8:
        return tuple(torch.randint(0, 256, shape, generator=gen,
                                   device="cuda", dtype=torch.uint8)
                     for _ in range(2))
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 for _ in range(2))


def spectra_error(got, want):
    """(max abs error, max-rel = max abs / peak, worst per-bin relative
    error, whether |err| <= 5e-5*|want| + 1e-6*peak holds everywhere)."""
    err = (got.double() - want.double()).abs()
    ref = want.double().abs()
    peak = ref.max().item()
    ok = bool((err <= 5e-5 * ref + 1e-6 * peak).all())
    return (err.max().item(), err.max().item() / peak,
            (err / ref.clamp_min(1e-30)).max().item(), ok)


def phase_kernels(cc, spec, gen):
    """Kernel vs plain on the card.  Returns the main config's AVG max abs
    error."""
    print("== kernel vs plain (bound: |err| <= 5e-5*|plain| + 1e-6*peak per "
          "bin, and max-rel < 1e-5)")
    main_err = None
    cases = [(cfg_of(2048, 0.5, m), 256) for m in ("AVG", "MAX", "MIN", "RAW")]
    cases += [(cfg_of(2048, 0.1, m), 64) for m in ("AVG", "MIN")]
    cases += [(cfg_of(256, 0.5, "AVG", "WIN.HANNING"), 256),
              (cfg_of(cc.MAX_FFT_SIZE, 0.5, "AVG"), 64),
              (cfg_of(cc.MAX_FFT_SIZE, 0.5, "MAX"), 64)]
    for cfg, t in cases:
        re, im = noise(cfg, t, False, gen)
        got = cc.curscan_fused_sublane(re, im, cfg)
        want = cc.curscan_fused_sublane_plain(re, im, cfg)
        torch.cuda.synchronize()
        check(got.shape == (t, cfg.fft_size) and bool(got.isfinite().all()),
              "kernel output shape/finite")
        mx, mrel, bin_rel, ok = spectra_error(got, want)
        print(f"fft {cfg.fft_size} ovl {1 - cfg.cur_scan_non_overlap:.1f} "
              f"{cfg.window} {cfg.cur_scan_cumu_mode} W={cfg.num_windows} "
              f"T={t}: max_abs {mx:.3e} max_rel {mrel:.3e} worst_bin_rel "
              f"{bin_rel:.3e} {'PASS' if ok and mrel < 1e-5 else 'FAIL'}")
        check(ok and mrel < 1e-5, f"kernel vs plain at {cfg.fft_size}/"
              f"{cfg.cur_scan_non_overlap}/{cfg.cur_scan_cumu_mode}")
        if cfg.fft_size == 2048 and cfg.cur_scan_non_overlap == 0.5:
            if cfg.cur_scan_cumu_mode == "AVG":
                main_err = mx
                ref = spec.curscan_batched(re.double(), im.double(), cfg)
                for name, out in (("kernel", got), ("plain", want)):
                    print(f"  {name} vs complex128 torch.fft reference: "
                          f"max_rel {spectra_error(out, ref)[1]:.3e}")
    for nono in (0.5, 0.1):
        cfg = cfg_of(2048, nono)
        re, im = noise(cfg, 256, True, gen)
        got = cc.curscan_fused_sublane(re, im, cfg)
        dec = cc.curscan_fused_sublane(spec.decode_u8(re), spec.decode_u8(im),
                                       cfg)
        same = torch.equal(got, dec)
        print(f"u8 planes vs decoded f32 through the kernel, ovl "
              f"{1 - nono:.1f}: {'bit-identical' if same else 'DIFFER'}")
        check(same, "u8 kernel input bit-identical to decoded f32")
    return main_err


def stream_iq(cfg, blocks, gen):
    """1-D float32 planes of ``blocks`` main-path blocks made on the card:
    tones at -1/0/+1 MHz (91/92/93 MHz) over white noise."""
    n = blocks * cfg.full_size
    re = torch.randn(n, generator=gen, device="cuda")
    im = torch.randn(n, generator=gen, device="cuda")
    step = 1 << 24
    for f in (-1e6, 0.0, 1e6):
        for s in range(0, n, step):
            k = torch.arange(s, min(n, s + step), device="cuda",
                             dtype=torch.float64)
            ph = (2 * np.pi * torch.frac(k * (f / cfg.sampling_rate))).float()
            re[s:s + k.numel()] += 8.0 * torch.cos(ph)
            im[s:s + k.numel()] += 8.0 * torch.sin(ph)
    return re, im


def assert_db_close(got, want, what, span_db=100.0, tol_db=1e-3):
    got, want = got.double().cpu(), want.double().cpu()
    mask = want >= want.max() - span_db
    err = (got - want).abs()[mask].max().item()
    print(f"  {what}: max |dB err| {err:.3e} over {int(mask.sum())} bins")
    check(err <= tol_db, f"{what} within {tol_db} dB")


def phase_stream(cc, st, gen):
    cfg = cfg_of()
    blocks, chunk = 16384, 1024
    re, im = stream_iq(cfg, blocks, gen)
    torch.cuda.synchronize()
    print(f"== stream: {blocks} blocks x {cfg.full_size} samples "
          f"({blocks * cfg.full_size / 1e6:.0f} M samples, "
          f"{blocks * cfg.full_size / cfg.sampling_rate:.1f} s of IQ) in "
          f"chunks of {chunk}")
    # In turns (plain, kernel, kernel, plain): the first run of each pays
    # one-time set-up; compare the two within this call only.
    results = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        before = cc.launches
        t0 = time.perf_counter()
        if name == "kernel":
            res = st.run_stream_session(re, im, cfg, "cuda", chunk)
        else:
            with mock.patch.object(cc, "curscan_fused_sublane",
                                   cc.curscan_fused_sublane_plain):
                res = st.run_stream_session(re, im, cfg, "cuda", chunk)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        results[name] = res
        print(f"  {name}: {dt:.3f} s, {blocks * cfg.full_size / dt / 1e6:.1f}"
              f" Msamp/s, kernel launches {cc.launches - before}")
        want = blocks // chunk if name == "kernel" else 0
        check(cc.launches - before == want, f"stream {name} launches")
    k, p = results["kernel"], results["plain"]
    check(k.rows.shape == (blocks, cfg.x_res), "stream rows shape")
    for f in ("fft_max", "fft_min", "fft_avg", "fft_cur"):
        check(bool(getattr(k, f).isfinite().all()), f"stream {f} finite")
        assert_db_close(getattr(k, f), getattr(p, f), f"stream {f}")
    assert_db_close(k.rows[::997], p.rows[::997], "stream rows (every 997th)")


def write_capture(path, cfg, n_samples, seed):
    """An rtl_sdr capture (u8, value-127 offset, I then Q) of tones at every
    integer MHz in the band over noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / cfg.sampling_rate
    x = rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples)
    for f in PEAKS_HZ:
        x += 30 * np.exp(2j * np.pi * (f - cfg.center_freq) * t)
    raw = np.empty(2 * n_samples, np.uint8)
    raw[0::2] = np.clip(np.round(x.real + 127), 0, 255)
    raw[1::2] = np.clip(np.round(x.imag + 127), 0, 255)
    raw.tofile(path)


def avg_peaks(cfg, avg):
    """The three strongest peaks of a final average curve, compressed for
    display as the session's views are."""
    from kspecanal_tpu_torch.ops import dsp
    from kspecanal_tpu_torch.ops.peaks import find_peaks
    from kspecanal_tpu_torch.ops.spectrum import fft_freqs
    x, y = dsp.compress_xy(torch.as_tensor(fft_freqs(cfg), dtype=torch.float32),
                           torch.as_tensor(avg, dtype=torch.float32),
                           cfg.plt_compress, cfg.x_res)
    return sorted(p.freq for p in find_peaks(
        x.numpy(), y.numpy(), cfg.plt_highs_num_markers,
        cfg.plt_highs_delta4marking)[:3])


def load_avg(path):
    """The final average a session saved with ``saveSigLvls`` (pickled
    start, end, curve; kspecanal.py:736-748)."""
    with open(path, "rb") as f:
        pickle.load(f)
        pickle.load(f)
        return np.asarray(pickle.load(f))


def phase_sessions(cc, cli, tmp):
    """The main path through the entry point.  Returns kernel launches."""
    cfg = cfg_of()
    cap = os.path.join(tmp, "capture.iq")
    write_capture(cap, cfg, 64 * cfg.full_size, seed=7)
    runs = [("serial", ["tpuSource", "synth", "prgLoopCnt", "8"], 8),
            ("catch-up", ["tpuSource", "synth", "prgLoopCnt", "512",
                          "tpuCatchUp", "128"], 512),
            ("u8 file", ["tpuSource", f"file:{cap}", "prgLoopCnt", "64",
                         "tpuCatchUp", "16"], 64)]
    print("== sessions through kspecanal_tpu_torch.cli.main")
    cc.launches = 0
    for name, args, iters in runs:
        lvls = os.path.join(tmp, f"lvls_{len(args)}.bin")
        before = cc.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(MAIN_ARGS + args + ["tpuHeadless", "true",
                                          "saveSigLvls", lvls])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(rc == 0, f"{name} session rc")
        avg = load_avg(lvls)
        # -inf is a legitimate LogNoGain of an exactly-zero bin (the
        # noiseless synth has some); NaN and +inf are not.
        check(avg.shape == (2048,) and not np.isnan(avg).any()
              and not np.isposinf(avg).any(), f"{name} final average")
        peaks = avg_peaks(cfg, avg)
        cell = cfg.sampling_rate / cfg.x_res
        on = len(peaks) == 3 and all(abs(p - w) <= cell
                                     for p, w in zip(peaks, PEAKS_HZ))
        print(f"  {name}: {iters} iterations in {dt:.3f} s "
              f"({iters * cfg.full_size / dt / 1e6:.2f} Msamp/s end to end, "
              f"host source included), kernel launches "
              f"{cc.launches - before}, peaks "
              f"{[round(p / 1e6, 4) for p in peaks]} MHz "
              f"{'PASS' if on else 'FAIL'}")
        check(cc.launches > before, f"{name} session launched the kernel")
        check(on, f"{name} peaks on 91/92/93 MHz")
    return cc.launches


def time_ms(fn, warm=3, reps=10):
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


def phase_timing(cc, gen, gpu):
    cfg = cfg_of()
    t = 4096
    out = {}
    print("== timing at T=4096 blocks, fft 2048 kaiser 50% (CUDA events, "
          "3 warm-ups, median of 10)")
    for u8 in (False, True):
        re, im = noise(cfg, t, u8, gen)
        ks = time_ms(lambda: cc.curscan_fused_sublane(re, im, cfg))
        ps = time_ms(lambda: cc.curscan_fused_sublane_plain(re, im, cfg))
        gs = t * cfg.full_size / 1e9
        kind = "u8" if u8 else "f32"
        print(f"  {kind}: kernel {ks:.3f} ms = {gs / ks * 1e3:.2f} Gsamp/s, "
              f"plain torch.fft {ps:.3f} ms = {gs / ps * 1e3:.2f} Gsamp/s "
              f"[{gpu}]")
        out[kind] = (ks, ps)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from kspecanal_tpu_torch import cli
    from kspecanal_tpu_torch.ops import _build
    from kspecanal_tpu_torch.ops import cuda_curscan as cc
    from kspecanal_tpu_torch.ops import spectrum as spec
    from kspecanal_tpu_torch.parallel import stream as st

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    print(f"== environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{[ln for ln in nvcc.splitlines() if 'release' in ln][0].strip()}")
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    print(gpu)

    t0 = time.perf_counter()
    _build.load()
    print(f"== build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s) -> {_build.library_path()}")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "Compiling entry" in ln or "spill" in ln:
            print(f"  {ln.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(20260817)
    main_err = phase_kernels(cc, spec, gen)
    phase_stream(cc, st, gen)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_sessions(cc, cli, tmp)
    times = phase_timing(cc, gen, gpu)
    print(json.dumps({"kernels": [{
        "name": "curscan_sublane", "route": "cuda",
        "source": "kspecanal_tpu_torch/csrc/curscan_sublane.cu",
        "replaces": "kspecanal_tpu/ops/pallas_curscan.py:423",
        "launches": launches, "max_abs_err": main_err,
        "ms": times["f32"][0], "plain_ms": times["f32"][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
