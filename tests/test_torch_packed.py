"""Port parity of the packed tiny-FFT kernel's wrapper, the direct DFT, the
sublane kernel at fft 16384 and the kernel build.

On the CPU the wrapper ``curscan_fused_packed`` runs its plain version (the
``torch.fft`` chain); it is held against the JAX package's Pallas kernel
``curscan_fused_packed`` in interpret mode (bounds in
``torch_parity.assert_spectra_close``).  The card's tests are in
test_torch_gpu.py."""
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.config import (WINDOW_HANNING, WINDOW_KAISER, WINDOW_ONES,
                                  cumu_weights, win_adj, window_lut)
from kspecanal_tpu.ops import pallas_curscan as jpk
from kspecanal_tpu.ops import spectrum as jspec
from kspecanal_tpu_torch.ops import _build, cuda_curscan, cuda_packed
from kspecanal_tpu_torch.ops import spectrum as tspec
from torch_parity import MODES, assert_spectra_close, decoded, zs_cfg

# The cases of the JAX package's packed-kernel test
# (tests/test_round2_fixes.py:396-398), then quickFullScan's geometry (fft
# 64, ones, 90% overlap: 71 windows over 512 samples) in every mode.
PACKED_CASES = [(fft, nono, mode, WINDOW_KAISER) for fft, nono, mode in (
    (64, 0.5, "AVG"), (64, 0.1, "AVG"), (128, 0.5, "MAX"), (64, 0.5, "MIN"),
    (32, 0.25, "RAW"), (64, 1.0, "AVG"))]
PACKED_CASES += [(64, 0.1, m, WINDOW_ONES) for m in MODES]


def noise_planes(cfg, t, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((t, cfg.full_size)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("fft,nono,mode,window", PACKED_CASES)
def test_packed_plain_matches_jax_kernel(fft, nono, mode, window):
    cfg = zs_cfg(fft, nono, mode, window=window, x_res=fft)
    assert cuda_packed.supports_fused_packed(cfg)
    re, im = noise_planes(cfg, 4, seed=fft + int(nono * 100) + len(mode))
    want = np.asarray(jpk.curscan_fused_packed(
        jnp.asarray(re), jnp.asarray(im), cfg, t_tile=2))
    got = cuda_packed.curscan_fused_packed(torch.from_numpy(re),
                                           torch.from_numpy(im), cfg)
    assert got.dtype == torch.float32 and got.shape == (4, fft)
    assert_spectra_close(got.numpy(), want)


def test_packed_u8_planes_equal_decoded_f32():
    cfg = zs_cfg(64, 0.1, window=WINDOW_ONES, x_res=64)
    rng = np.random.default_rng(3)
    re, im = (rng.integers(0, 256, (5, cfg.full_size), dtype=np.uint8)
              for _ in range(2))
    got = cuda_packed.curscan_fused_packed(torch.from_numpy(re),
                                           torch.from_numpy(im), cfg)
    want = cuda_packed.curscan_fused_packed(torch.from_numpy(decoded(re)),
                                            torch.from_numpy(decoded(im)), cfg)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_packed_predicate_is_jax_without_vmem_clause():
    """At the reference's fft2FullMult the shared-memory bound never bites,
    so the port's predicate equals the JAX one; a huge multiplier trips
    only the port's."""
    for fft in (8, 16, 32, 48, 64, 96, 128, 256):
        for nono in (0.5, 0.1, 0.25, 1.0):
            cfg = zs_cfg(fft, nono, x_res=fft)
            assert (cuda_packed.supports_fused_packed(cfg)
                    == jpk.supports_fused_packed(cfg)), (fft, nono)
    big = zs_cfg(128, 0.5, x_res=128, fft2full_mult4less=64)
    assert not cuda_packed.supports_fused_packed(big)
    assert cuda_packed.smem_bytes(zs_cfg(64, 0.1, x_res=64)) == 49152


def test_packed_tables_match_jax_kernel_constants():
    """The kernel's table is the JAX kernel's float32 window-folded DFT
    block (pallas_curscan.py:948-959) and its weights the float32
    closed-form weights (:965-968)."""
    for mode in MODES:
        cfg = zs_cfg(64, 0.1, mode, window=WINDOW_KAISER, x_res=64)
        n = cfg.fft_size
        starts, weights, table = cuda_packed._tables(
            n, cfg.window, cfg.window_starts, mode, torch.device("cpu"))
        k = np.arange(n)
        dft = np.exp(-2j * np.pi * np.outer(k, k) / n)
        adj = win_adj(cfg.window, n) * 2.0 / n
        win = window_lut(cfg.window, n)
        np.testing.assert_array_equal(
            table[..., 0].numpy(),
            (dft.real * win[:, None] * adj).astype(np.float32))
        np.testing.assert_array_equal(
            table[..., 1].numpy(),
            (dft.imag * win[:, None] * adj).astype(np.float32))
        w = cumu_weights(mode, cfg.num_windows)
        np.testing.assert_array_equal(
            weights.numpy(),
            (np.ones(cfg.num_windows) if w is None else w).astype(np.float32))
        assert starts.tolist() == list(cfg.window_starts)


def test_wrapper_rejects_what_the_packed_kernel_does_not_take():
    cfg = zs_cfg(64, 0.5, x_res=64)
    f32 = torch.zeros((2, cfg.full_size))
    with pytest.raises(TypeError):
        cuda_packed.curscan_fused_packed(f32.double(), f32.double(), cfg)
    with pytest.raises(ValueError):
        cuda_packed.curscan_fused_packed(f32[:, :-128], f32[:, :-128], cfg)
    wide = torch.zeros((2, 2 * cfg.full_size))
    with pytest.raises(ValueError):
        cuda_packed.curscan_fused_packed(wide[:, ::2], wide[:, ::2], cfg)
    big = zs_cfg(256, 0.5)
    z = torch.zeros((1, big.full_size))
    with pytest.raises(ValueError):
        cuda_packed.curscan_fused_packed(z, z, big)


@pytest.mark.parametrize("fft,window", [(64, WINDOW_KAISER),
                                        (200, WINDOW_HANNING)])
def test_direct_dft_matches_jax(fft, window):
    cfg = zs_cfg(fft, 0.5, window=window, x_res=fft)
    re, im = noise_planes(cfg, 3, seed=fft)
    want = np.asarray(jspec.curscan_direct_batched(jnp.asarray(re),
                                                   jnp.asarray(im), cfg))
    got = tspec.curscan_direct_batched(torch.from_numpy(re),
                                       torch.from_numpy(im), cfg)
    assert_spectra_close(got.numpy(), want)


def test_sublane_plain_at_lane_kernel_cell_matches_jax_lane_kernel():
    """K3's only cell: float32, fft 16384, kaiser, 50% overlap (aligned
    starts).  The port routes it to the sublane kernel, whose plain version
    is held here against the JAX lane kernel in interpret mode at T=1."""
    cfg = zs_cfg(16384, 0.5, x_res=512)
    assert jpk.supports_fused(cfg) and cuda_curscan.supports_fused_sublane(cfg)
    re, im = noise_planes(cfg, 1, seed=16)
    want = np.asarray(jpk.curscan_fused(jnp.asarray(re), jnp.asarray(im), cfg))
    got = tspec.curscan_auto_batched(torch.from_numpy(re),
                                     torch.from_numpy(im), cfg)
    assert_spectra_close(got.numpy(), want)


def test_auto_dispatch_packed_on_cpu_never_builds(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    before = cuda_packed.launches
    for cfg in (zs_cfg(64, 0.1, window=WINDOW_ONES, x_res=64),
                zs_cfg(128, 0.5, x_res=128), zs_cfg(200, 0.5, x_res=200)):
        re, im = noise_planes(cfg, 2, seed=4)
        out = tspec.curscan_auto_batched(torch.from_numpy(re),
                                         torch.from_numpy(im), cfg)
        want = tspec.curscan_batched(torch.from_numpy(re),
                                     torch.from_numpy(im), cfg)
        np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert cuda_packed.launches == before


def test_build_runs_one_nvcc_per_source_then_links(tmp_path, monkeypatch):
    """With a stand-in for nvcc that logs its arguments: every csrc/*.cu is
    compiled on its own (all started together), the objects are linked into
    the hash-named library, and the objects are removed."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then touch \"$2\"; fi\n"
                    "  shift\n"
                    "done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    so = _build.library_path()
    _build._compile(so)
    calls = log.read_text().splitlines()
    sources = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    assert sources == ["curscan_fft.cu", "curscan_mixed.cu",
                       "curscan_mixed_planes.cu", "curscan_packed.cu",
                       "curscan_sublane.cu"]
    compiles = [c for c in calls if " -c " in c]
    assert sorted(os.path.basename(c.split()[-1]) for c in compiles) \
        == sources
    assert all("arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert calls[-1].startswith("-shared")
    assert so.exists() and so.parent == tmp_path / "build"
    assert [p.name for p in so.parent.iterdir()] == [so.name]
    assert os.path.basename(so).startswith("libkspec_kernels_")
