"""Port parity of the curscan chain and the sublane kernel's wrapper.

On the CPU the wrapper ``curscan_fused_sublane`` runs its plain version (the
``torch.fft`` chain); it is held against the JAX package's Pallas kernel
``curscan_fused_sublane`` in interpret mode and against the JAX XLA chain
``curscan_batched`` (bounds in ``torch_parity.assert_spectra_close``).  u8
planes must equal decoded f32 exactly.  The grid at fft 2048 (the main
path's size) is here; fft 256 and 512 have files of their own, and the
card's tests are in test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.config import WINDOW_HANNING, cumu_weights, win_adj
from kspecanal_tpu.ops import pallas_curscan as jpk
from kspecanal_tpu.ops import spectrum as jspec
from kspecanal_tpu_torch.ops import _build, cuda_curscan
from kspecanal_tpu_torch.ops import spectrum as tspec
from torch_parity import (MODES, assert_spectra_close, check_grid_case,
                          decoded, raw_planes, zs_cfg)


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nono", [0.5, 0.1])
def test_plain_matches_jax_kernel_and_chain(nono, mode, u8):
    check_grid_case(2048, nono, mode, u8)


@pytest.mark.parametrize("nono", [0.5, 0.1])
def test_u8_planes_equal_decoded_f32(nono):
    cfg = zs_cfg(512, nono)
    re, im = (torch.from_numpy(p) for p in raw_planes(cfg, 3, seed=5))
    want = cuda_curscan.curscan_fused_sublane(tspec.decode_u8(re),
                                              tspec.decode_u8(im), cfg)
    for fn in (cuda_curscan.curscan_fused_sublane,
               tspec.curscan_auto_batched):
        np.testing.assert_array_equal(fn(re, im, cfg).numpy(), want.numpy())


def test_auto_dispatch_on_cpu_never_builds(monkeypatch):
    """CPU tensors take the plain path for every config, kernel-supported
    or not, without touching nvcc or counting a launch."""
    def no_build():
        raise AssertionError("the CPU path must not build CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    before = cuda_curscan.launches
    for cfg in (zs_cfg(2048), zs_cfg(2048, 0.1), zs_cfg(16384),
                zs_cfg(1000, window=WINDOW_HANNING, x_res=500)):
        re, im = (torch.from_numpy(p) for p in raw_planes(cfg, 2, seed=6))
        out = tspec.curscan_auto_batched(re, im, cfg)
        want = tspec.curscan_batched(tspec.decode_u8(re),
                                     tspec.decode_u8(im), cfg)
        assert out.shape == (2, cfg.fft_size)
        np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert cuda_curscan.launches == before


def test_supports_matches_jax_predicate_up_to_smem_limit():
    for fft in (128, 256, 384, 512, 1000, 2048, 4096, 8192, 16384):
        for nono in (0.5, 0.1, 0.25):
            cfg = zs_cfg(fft, nono, x_res=min(fft, 512))
            want = (jpk.supports_fused_sublane(cfg)
                    and fft <= cuda_curscan.MAX_FFT_SIZE)
            assert cuda_curscan.supports_fused_sublane(cfg) == want


def test_wrapper_rejects_what_the_kernel_does_not_take():
    cfg = zs_cfg(2048)
    f32 = torch.zeros((2, cfg.full_size))
    with pytest.raises(TypeError):
        cuda_curscan.curscan_fused_sublane(f32.double(), f32.double(), cfg)
    with pytest.raises(TypeError):
        cuda_curscan.curscan_fused_sublane(f32, f32.to(torch.uint8), cfg)
    with pytest.raises(ValueError):
        cuda_curscan.curscan_fused_sublane(f32[:, :-128], f32[:, :-128], cfg)
    with pytest.raises(ValueError):
        cuda_curscan.curscan_fused_sublane(f32[0], f32[0], cfg)
    wide = torch.zeros((2, 2 * cfg.full_size))
    with pytest.raises(ValueError):
        cuda_curscan.curscan_fused_sublane(wide[:, ::2], wide[:, ::2], cfg)
    big = zs_cfg(2 * cuda_curscan.MAX_FFT_SIZE)
    z = torch.zeros((1, big.full_size))
    with pytest.raises(ValueError):
        cuda_curscan.curscan_fused_sublane(z, z, big)


def test_kernel_tables_match_jax_kernel_constants():
    """The kernel's per-window weights are the JAX kernel's
    ``float32(w * winAdj*2/N)`` and its starts are the config's."""
    for mode in MODES:
        cfg = zs_cfg(2048, 0.1, mode)
        starts, weights, window, roots = cuda_curscan._tables(
            cfg.fft_size, cfg.window, cfg.window_starts, mode,
            torch.device("cpu"))
        assert starts.tolist() == list(cfg.window_starts)
        scale = win_adj(cfg.window, cfg.fft_size) * 2.0 / cfg.fft_size
        w = cumu_weights(mode, cfg.num_windows)
        w = np.ones(cfg.num_windows) if w is None else w
        np.testing.assert_array_equal(weights.numpy(),
                                      (w * scale).astype(np.float32))
        assert roots.shape == (cfg.fft_size, 2)
        np.testing.assert_allclose(roots[1].numpy(), [
            np.cos(2 * np.pi / 2048), -np.sin(2 * np.pi / 2048)], rtol=1e-7)


def test_psd_and_frames_match_jax():
    cfg = zs_cfg(2048, window=WINDOW_HANNING)
    re, im = (decoded(p) for p in raw_planes(cfg, 2, seed=7))
    got = tspec.psd_welch(torch.from_numpy(re), torch.from_numpy(im), cfg)
    want = np.stack([np.asarray(jspec.psd_welch(jnp.asarray(r),
                                                jnp.asarray(i), cfg))
                     for r, i in zip(re, im)])
    assert_spectra_close(got.numpy(), want)
    np.testing.assert_array_equal(tspec.fft_freqs(cfg), jspec.fft_freqs(cfg))
    np.testing.assert_array_equal(
        tspec.frame_signal(torch.from_numpy(re[0]), cfg.window_starts,
                           cfg.fft_size).numpy(),
        np.asarray(jspec.frame_signal(jnp.asarray(re[0]), cfg.window_starts,
                                      cfg.fft_size)))
