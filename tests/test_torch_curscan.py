"""Port parity of the curscan chain and K1's wrapper.

On the CPU the wrapper ``curscan_fused_sublane`` runs its plain version (the
``torch.fft`` chain); it is held against the JAX package's Pallas kernel
``curscan_fused_sublane`` in interpret mode and against the JAX XLA chain
``curscan_batched`` (bounds in ``torch_parity.assert_spectra_close``).  u8
planes must equal decoded f32 exactly.  The grid at fft 2048 (the main
path's size) is here; fft 256 and 512 have files of their own, and the
card's tests are in test_torch_gpu.py.  The dispatch on the card (which
kernel a card tensor reaches) is checked here with 'meta' tensors and a
stand-in library; the FFT kernel's index math is modelled in
test_torch_fft_kernel.py."""
import contextlib
import types

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
    """The FFT kernel takes exactly what the JAX predicate takes, with no
    upper limit on fft (one block's shared memory bounds only n/c)."""
    for fft in (128, 256, 384, 512, 1000, 2048, 4096, 8192, 16384, 20480,
                32768, 65536, 131072, 196608, 262144, 1 << 20):
        for nono in (0.5, 0.1, 0.25):
            cfg = zs_cfg(fft, nono, x_res=min(fft, 512))
            assert cuda_curscan.supports_fused_sublane(cfg) \
                == jpk.supports_fused_sublane(cfg)


class _FakeLib:
    """A stand-in for the kernels' library: records which entry point each
    launch called, with its arguments, and reports success."""

    def __init__(self):
        self.calls = []
        self.args = []
        for name in ("kspec_curscan_fft", "kspec_curscan_sublane",
                     "kspec_curscan_packed"):
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        def fn(*args):
            self.calls.append(name)
            self.args.append(args)
            return 0
        fn.__name__ = name
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """Routes 'meta' tensors as the card's: the library is a
    :class:`_FakeLib`, and the stream, device and SM count are stand-ins, so
    the dispatch runs on the CPU up to the launch without building."""
    lib = _FakeLib()
    monkeypatch.setattr(cuda_curscan, "_cuda_lib", lambda dev: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev=None: types.SimpleNamespace(multi_processor_count=132))
    return lib


NEW_SIZES = (384, 1280, 3072, 16256, 20480, 98304, 130944, 196608, 262144)


def _jax_kernel_configs():
    """Every config, over the powers of two from 256 to 131072, the mixed
    kernel's sizes ``NEW_SIZES`` and overlaps 0.5, 0.1 and 0.25, that the
    JAX dispatcher sends to a Pallas kernel (sublane or lane)."""
    for fft in [1 << e for e in range(8, 18)] + list(NEW_SIZES):
        for nono in (0.5, 0.1, 0.25):
            cfg = zs_cfg(fft, nono, x_res=512)
            if (jpk.supports_fused_sublane(cfg)
                    and jspec._fused_choice(cfg) is not None):
                yield cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_jax_kernel_configs_launch_a_kernel_on_the_card(fake_card, dtype):
    """Wherever the JAX dispatcher picks a Pallas kernel, the port's
    dispatcher sends a card tensor to a hand-written kernel, never to the
    ``torch.fft`` chain: at these powers of two and mixed sizes, one launch
    of the FFT kernel, counted in ``launches`` and not in
    ``direct_launches``."""
    for cfg in _jax_kernel_configs():
        planes = torch.empty((2, cfg.full_size), device="meta", dtype=dtype)
        fake_card.calls.clear()
        before = (cuda_curscan.launches, cuda_curscan.direct_launches)
        out = tspec.curscan_auto_batched(planes, planes, cfg)
        assert out.shape == (2, cfg.fft_size)
        assert fake_card.calls == ["kspec_curscan_fft"], (
            cfg.fft_size, cfg.cur_scan_non_overlap, fake_card.calls)
        assert (cuda_curscan.launches, cuda_curscan.direct_launches) == (
            before[0] + 1, before[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_lane_sizes_launch_the_fft_kernel_with_a_valid_plan(fake_card,
                                                             dtype):
    """The lane kernel's sizes off the 128 grid launch the FFT kernel once,
    with the block split of ``fft_plan`` (one block; a cluster of a power
    of two <= 8; the scratch route, chunked) and a window-group plan the
    kernel's entry accepts: n/c <= 16384 points a block, 1 <= G <= W."""
    for fft, nono, t in ((2500, 0.5, 3), (3000, 0.1, 3), (10000, 0.25, 3),
                         (24000, 0.5, 2), (39800, 0.1, 2), (33250, 0.5, 2),
                         (131100, 0.5, 2)):
        cfg = zs_cfg(fft, nono, x_res=500)
        assert cuda_curscan.kernel_route(cfg) == "fft"
        planes = torch.empty((t, cfg.full_size), device="meta", dtype=dtype)
        fake_card.calls.clear()
        fake_card.args.clear()
        before = cuda_curscan.launches
        out = tspec.curscan_auto_batched(planes, planes, cfg)
        assert out.shape == (t, fft) and cuda_curscan.launches == before + 1
        assert fake_card.calls == ["kspec_curscan_fft"]
        (is_u8, t_, full, n, c, chunk, w, groups,
         fold) = (fake_card.args[0][i] for i in (2, 11, 12, 13, 14, 15, 16,
                                                 17, 18))
        assert (is_u8, t_, full, n) == (int(dtype == torch.uint8), t,
                                        cfg.full_size, fft)
        c_plan, via_scratch = cuda_curscan.fft_plan(fft)
        assert c == c_plan and n % c == 0 and n // c <= 16384
        if via_scratch:
            assert 1 <= chunk <= t and fft > 16384
        else:
            assert chunk == t and c <= 8 and c & (c - 1) == 0
        assert w == cfg.num_windows and 1 <= groups <= w and fold == 0
        assert groups == cuda_curscan.window_groups(chunk, fft, w, 132)


def test_non_power_of_two_takes_the_direct_kernel(fake_card):
    """The multiples of 128 that are not powers of two, which the direct
    kernel served up to fft 16384, now take the FFT kernel (its mixed-radix
    form) like every other size: no session launches the direct kernel,
    which only :func:`curscan_sublane_direct` still calls."""
    for fft in (384, 1280, 5120, 16256):
        cfg = zs_cfg(fft, 0.5, window=WINDOW_HANNING, x_res=fft // 4)
        planes = torch.empty((2, cfg.full_size), device="meta")
        fake_card.calls.clear()
        before = (cuda_curscan.launches, cuda_curscan.direct_launches)
        out = tspec.curscan_auto_batched(planes, planes, cfg)
        assert out.shape == (2, fft)
        assert fake_card.calls == ["kspec_curscan_fft"]
        assert (cuda_curscan.launches, cuda_curscan.direct_launches) == (
            before[0] + 1, before[1])
        fake_card.calls.clear()
        cuda_curscan.curscan_sublane_direct(planes, planes, cfg)
        assert fake_card.calls == ["kspec_curscan_sublane"]
        assert cuda_curscan.direct_launches == before[1] + 1


@pytest.mark.parametrize("fft", [3000, 16256, 39800, 262144])
def test_mixed_stage_launches_the_fft_kernel_with_its_cutoff(fake_card, fft):
    """The mixed kernel's stage table (profiling only): each stage is one
    launch of the FFT kernel's entry with its cut-off (0 = 'full', i + 1
    after ``MIXED_STAGES[i]``), counted in ``forensic_launches`` and not in
    ``launches``; production launches pass 0."""
    cfg = zs_cfg(fft, 0.5, x_res=500)
    planes = torch.empty((2, cfg.full_size), device="meta")
    for i, stage in enumerate(cuda_curscan.MIXED_STAGES):
        fake_card.calls.clear()
        fake_card.args.clear()
        before = (cuda_curscan.launches, cuda_curscan.forensic_launches)
        out = cuda_curscan.curscan_mixed_stage(planes, planes, cfg, stage)
        assert out.shape == (2, fft)
        assert fake_card.calls == ["kspec_curscan_fft"]
        assert fake_card.args[0][19] == (i + 1) % 4
        assert (cuda_curscan.launches, cuda_curscan.forensic_launches) == (
            before[0], before[1] + 1)
    fake_card.args.clear()
    cuda_curscan.curscan_fused_sublane(planes, planes, cfg)
    assert fake_card.args[0][19] == 0


def test_mixed_stage_refuses_what_the_mixed_kernel_does_not_run():
    """Powers of two up to 131072 run the power-of-two kernel, whose
    cut-offs are forensic builds of their own (``curscan_fft_stage``), not
    the mixed kernel's; sizes no kernel takes and unknown stages raise.  On
    CPU tensors 'full' is the plain version in float64."""
    for fft in (2048, 131072, 1000):
        cfg = zs_cfg(fft, 0.5, x_res=500)
        z = torch.zeros((1, cfg.full_size))
        with pytest.raises(ValueError):
            cuda_curscan.curscan_mixed_stage(z, z, cfg, "odd")
    cfg = zs_cfg(3000, 0.5, x_res=500)
    re, im = (torch.from_numpy(decoded(p)) for p in raw_planes(cfg, 1, 3))
    with pytest.raises(ValueError, match="unknown stage"):
        cuda_curscan.curscan_mixed_stage(re, im, cfg, "s2")
    np.testing.assert_array_equal(
        cuda_curscan.curscan_mixed_stage(re, im, cfg, "full").numpy(),
        cuda_curscan.curscan_fused_sublane_plain(re.double(), im.double(),
                                                 cfg).numpy())


def test_the_remaining_gap_is_non_powers_of_two_above_16384():
    """The gap is closed: of the configs the JAX dispatcher sends to a
    Pallas kernel, none takes the torch.fft chain on the card, over every
    multiple of 128 up to 262144 and at 2^20 (the non-powers of two above
    16384 and every fft above 131072 used to)."""
    gap = []
    for fft in list(range(128, 262144 + 1, 128)) + [1 << 20]:
        cfg = zs_cfg(fft, 0.5, x_res=128)
        if jspec._fused_choice(cfg) is None:
            continue
        if cuda_curscan.kernel_route(cfg) != "fft":
            gap.append(fft)
    assert gap == []


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
    odd = zs_cfg(1000, x_res=500)
    z = torch.zeros((1, odd.full_size))
    with pytest.raises(ValueError):
        cuda_curscan.curscan_fused_sublane(z, z, odd)
    big = zs_cfg(2 * cuda_curscan.DIRECT_MAX_FFT_SIZE)
    z = torch.zeros((1, big.full_size))
    with pytest.raises(ValueError):
        cuda_curscan.curscan_sublane_direct(z, z, big)
    # The ablate keys take the sublane kernel's configs at every fft (fault
    # C5: above fft 16384 they raised); off the 128 grid they raise.
    lane = zs_cfg(3000)
    z = torch.zeros((1, lane.full_size))
    with pytest.raises(ValueError, match="sublane"):
        cuda_curscan.curscan_fused_sublane(z, z, lane, ablate=("win",))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fft", [1280, 20480])
def test_mixed_sizes_plain_matches_jax_chain(fft, mode):
    """fft 1280 and 20480, which the JAX package sends to its sublane
    kernel and the port's mixed-radix kernel serves on the card: the
    wrapper on CPU tensors (its plain version) against the JAX chain, u8
    and decoded float32 equal."""
    cfg = zs_cfg(fft, 0.1, mode, x_res=512)
    re, im = raw_planes(cfg, 2, seed=fft + 11)
    want = np.asarray(jspec.curscan_batched(jnp.asarray(decoded(re)),
                                            jnp.asarray(decoded(im)), cfg))
    got = cuda_curscan.curscan_fused_sublane(torch.from_numpy(decoded(re)),
                                             torch.from_numpy(decoded(im)),
                                             cfg)
    assert_spectra_close(got.numpy(), want)
    u8 = cuda_curscan.curscan_fused_sublane(torch.from_numpy(re),
                                            torch.from_numpy(im), cfg)
    np.testing.assert_array_equal(u8.numpy(), got.numpy())


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
