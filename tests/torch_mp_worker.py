"""Rank process of the port's gloo worlds on the CPU
(tests/test_torch_parallel.py, tests/test_torch_standalone.py).

    python torch_mp_worker.py <mode> <rank> <world> <store> <out_dir>

Each rank blocks ``jax``, ``jaxlib`` and ``kspecanal_tpu`` before it
imports anything, joins the world through the ``file://`` store (no TCP
port, so parallel test workers cannot race for one), and runs on the CPU:

  * mode ``cases``: every sharded case of :data:`TIME_CASES`,
    :data:`FFT_CASES`, :data:`BAND_CASES` and :data:`STREAM_CASES` on the
    inputs :func:`iq`, :func:`sweep` and :func:`stream_planes` make from
    their seeds; rank 0 saves the results to ``<out_dir>/world<S>.npz``;
  * mode ``cli``: the ``cli.main`` runs listed in ``<out_dir>/cli.json``
    (``[{"argv": [...], "time": t, "band": b}, ...]``), each rank on a
    mesh it builds, and rank 0 checks that nothing of JAX was imported.

The tests import this module for :func:`spawn_world` and the case tables;
only ``__main__`` blocks JAX."""
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)
TIMEOUT_S = 240   # each world, and each collective inside it

# (name, fft, curScanNonOverlap, window, cumulate mode)
TIME_CASES = [(f"time-{m}", 256, 0.5, "WIN.HANNING", m)
              for m in ("AVG", "MAX", "MIN", "RAW")] + [
    ("time-fractional-hop", 256, 0.1, "WIN.KAISER", "AVG")]
FFT_CASES = [("fft-AVG", 2048, 0.5, "WIN.KAISER", "AVG"),
             ("fft-MAX", 2048, 0.5, "WIN.HANNING", "MAX")]
# the fft-sharded products at the HIGH and DEFAULT classes (+ tpuPrecision)
FFT_CLASS_CASES = [("fft-AVG-HIGH", 2048, 0.5, "WIN.KAISER", "AVG", "HIGH"),
                   ("fft-MAX-DEFAULT", 2048, 0.5, "WIN.HANNING", "MAX",
                    "DEFAULT")]
# (name, endFreq, scanRangeNonOverlap, index of a failed retune or -1): 8
# bands, and 7 (sentinel padding at 2 and 4 ranks) with a failed retune
BAND_CASES = [("band-8", 96e6, 0.5, -1), ("band-7", 97e6, 0.75, 3)]
STREAM_CASES = ["stream-f32", "stream-u8"]
STREAM_T = 8


def zs_cfg(fft, nono, window, mode, prec="HIGHEST"):
    from kspecanal_tpu_torch.config import SpecConfig
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=window, cur_scan_non_overlap=nono,
                      cur_scan_cumu_mode=mode, x_res=min(fft, 256),
                      tpu_precision=prec).finalize()


def scan_cfg(end_freq, scan_non_overlap):
    from kspecanal_tpu_torch.config import SpecConfig
    return SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=end_freq,
                      sampling_rate=2e6, fft_size=128, x_res=128,
                      window="WIN.HANNING", cur_scan_non_overlap=0.5,
                      scan_range_non_overlap=scan_non_overlap).finalize()


def iq(cfg, seed):
    """One block of white noise: float32 ``(full_size,)`` planes."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(cfg.full_size).astype(np.float32)
                 for _ in range(2))


def sweep(cfg, num_bands, failed, seed):
    """One sweep: ``(B, full_size)`` float32 planes and ``(B,)`` flags."""
    rng = np.random.default_rng(seed)
    re, im = (rng.standard_normal((num_bands, cfg.full_size))
              .astype(np.float32) for _ in range(2))
    oks = np.ones(num_bands, bool)
    if failed >= 0:
        oks[failed] = False
    return re, im, oks


def stream_planes(cfg, name, seed):
    """``(STREAM_T, full_size)`` planes: float32 noise or raw u8 bytes."""
    rng = np.random.default_rng(seed)
    if name == "stream-u8":
        return tuple(rng.integers(0, 256, (STREAM_T, cfg.full_size))
                     .astype(np.uint8) for _ in range(2))
    return tuple(rng.standard_normal((STREAM_T, cfg.full_size))
                 .astype(np.float32) for _ in range(2))


def spawn_world(mode, world, out_dir, timeout_s=TIMEOUT_S):
    """Run ``world`` ranks of this script in ``mode``; returns each rank's
    ``(returncode, output)``.  All ranks are killed at the timeout."""
    store = os.path.join(out_dir, f"store-{mode}-{world}")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(r), str(world), store, out_dir],
        env=env, cwd=out_dir, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    out = []
    try:
        for p in procs:
            out.append((p.wait(timeout=timeout_s), p.stdout.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
    return out


def run_cases(mesh_mod):
    import torch
    from kspecanal_tpu_torch.models import scan as scan_mod
    from kspecanal_tpu_torch.models.convert import scan_state_to_numpy
    from kspecanal_tpu_torch.parallel import stream
    from kspecanal_tpu_torch.parallel.bandshard import \
        sweep_step_band_sharded
    from kspecanal_tpu_torch.parallel.fftshard import curscan_fft_sharded
    from kspecanal_tpu_torch.parallel.timeshard import curscan_time_sharded
    import torch.distributed as dist

    world = dist.get_world_size()
    root = dist.get_rank() == 0
    res = {}

    def tensors(arrays):
        return [torch.from_numpy(a) for a in arrays] if root else None

    mesh_t = mesh_mod.make_mesh(time=world, device_type="cpu")
    for seed, (name, *c) in enumerate(TIME_CASES + FFT_CASES
                                      + FFT_CLASS_CASES):
        cfg = zs_cfg(*c)
        fn = curscan_fft_sharded if name.startswith("fft") \
            else curscan_time_sharded
        planes = tensors(iq(cfg, seed))
        spec = fn(*(planes or (None, None)), cfg, mesh_t)
        res[name] = spec.numpy()
    for seed, name in enumerate(STREAM_CASES):
        cfg = zs_cfg(256, 0.5, "WIN.HANNING", "AVG")
        planes = tensors(stream_planes(cfg, name, 100 + seed))
        out = stream.waterfall_stream_sharded(*(planes or (None, None)),
                                              cfg, mesh_t)
        rows = mesh_mod.gather_rows(out.rows, mesh_t)
        for f in ("fft_max", "fft_min", "fft_avg", "fft_cur"):
            res[f"{name}-{f}"] = getattr(out, f).numpy()
        if root:
            res[f"{name}-rows"] = rows.numpy()
    mesh_b = mesh_mod.make_mesh(band=world, device_type="cpu")
    for seed, (name, end, srno, failed) in enumerate(BAND_CASES):
        cfg = scan_cfg(end, srno)
        plan = scan_mod.make_scan_plan(cfg)
        state = scan_mod.init_state(cfg, plan, "cpu")
        data = tensors(sweep(cfg, plan.num_bands, failed, 200 + seed))
        for _ in range(2):
            state = sweep_step_band_sharded(state, *(data or (None,) * 3),
                                            cfg, plan, mesh_b)
        for f, v in scan_state_to_numpy(state).items():
            res[f"{name}-{f}"] = v
    return res


def run_cli(out_dir, mesh_mod):
    from kspecanal_tpu_torch import cli
    with open(os.path.join(out_dir, "cli.json")) as f:
        runs = json.load(f)
    for run in runs:
        mesh = mesh_mod.make_mesh(run["time"], run["band"], device_type="cpu")
        rc = cli.main(run["argv"], mesh=mesh)
        assert rc == 0, (run, rc)


def main():
    for m in ("jax", "jaxlib", "kspecanal_tpu"):
        sys.modules[m] = None
    sys.path.insert(0, REPO)
    mode, rank, world, store, out_dir = sys.argv[1:]
    rank, world = int(rank), int(world)
    import torch.distributed as dist
    from kspecanal_tpu_torch.parallel import mesh as mesh_mod
    mesh_mod.init_distributed("gloo", init_method=f"file://{store}",
                              world_size=world, rank=rank,
                              timeout_s=TIMEOUT_S)
    try:
        if mode == "cases":
            res = run_cases(mesh_mod)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"world{world}.npz"), **res)
        else:
            run_cli(out_dir, mesh_mod)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    assert not any(k == "jax" or k.startswith(("jax.", "kspecanal_tpu."))
                   for k, v in sys.modules.items() if v is not None)
    print(f"rank {rank}/{world}: {mode} ok", flush=True)


if __name__ == "__main__":
    main()
