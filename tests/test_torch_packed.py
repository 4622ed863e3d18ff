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


def jax_structural_clause(cfg):
    """JAX's packed predicate without its VMEM clause
    (pallas_curscan.py:849-853)."""
    n = cfg.fft_size
    return (n <= 128 and 128 % n == 0 and cfg.full_size % 128 == 0
            and cfg.full_size >= 256)


def test_packed_predicate_is_jax_without_vmem_clause():
    """The port's predicate is JAX's structural clause, so it takes every
    config JAX's kernel takes (fault C2: a shared-memory clause refused fft
    128 with fft2FullMult 50-81 at 50% overlap, 64 with 98-162, 2-32 up to
    392); where JAX's VMEM clause refuses (fft 64 at 90% with mult 40-96)
    the port still takes the kernel."""
    for fft in (2, 3, 4, 8, 16, 32, 48, 64, 96, 120, 128):
        for nono in (0.5, 0.25, 0.1):
            for mult in range(1, 400):
                cfg = zs_cfg(fft, nono, x_res=fft, fft2full_mult4less=mult)
                port = cuda_packed.supports_fused_packed(cfg)
                assert port == jax_structural_clause(cfg), (fft, nono, mult)
                assert port or not jpk.supports_fused_packed(cfg), \
                    (fft, nono, mult)
    for fft, nono, mult in ((128, 0.5, 81), (64, 0.5, 162), (16, 0.5, 392)):
        cfg = zs_cfg(fft, nono, x_res=fft, fft2full_mult4less=mult)
        assert jpk.supports_fused_packed(cfg)
        assert cuda_packed.supports_fused_packed(cfg)


def jax_dft_block(cfg):
    """The real part of the JAX kernel's window-folded DFT block, built as
    ``_build_packed`` builds it (pallas_curscan.py:948-959)."""
    n = cfg.fft_size
    k = np.arange(n)
    dft = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return (dft.real * window_lut(cfg.window, n)[:, None]
            * (win_adj(cfg.window, n) * 2.0 / n)).astype(np.float32)


def test_packed_tables_match_jax_kernel_constants():
    """The kernel's window-and-scale table is win[j] * winAdj*2/N in float64,
    which rounds to the JAX kernel's float32 DFT block at bin 0
    (pallas_curscan.py:948-959); its twiddles are the float64 roots, and
    its weights the float32 closed-form weights (:965-968)."""
    for mode in MODES:
        cfg = zs_cfg(64, 0.1, mode, window=WINDOW_KAISER, x_res=64)
        n = cfg.fft_size
        starts, weights, wscale, tw = cuda_packed._tables(
            n, cfg.window, cfg.window_starts, mode, torch.device("cpu"))
        adj = win_adj(cfg.window, n) * 2.0 / n
        assert wscale.dtype == tw.dtype == torch.float64
        np.testing.assert_array_equal(wscale.numpy(),
                                      window_lut(cfg.window, n) * adj)
        np.testing.assert_array_equal(wscale.numpy().astype(np.float32),
                                      jax_dft_block(cfg)[:, 0])
        roots = np.exp(-2j * np.pi * np.arange(n) / n)
        np.testing.assert_array_equal(tw[:, 0].numpy(), roots.real)
        np.testing.assert_array_equal(tw[:, 1].numpy(), roots.imag)
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
                       "curscan_packed_tc.cu", "curscan_sublane.cu",
                       "curscan_tc.cu", "curscan_tc_high.cu",
                       "curscan_tc_split.cu", "curscan_tc_split_high.cu"]
    compiles = [c for c in calls if " -c " in c]
    assert sorted(os.path.basename(c.split()[-1]) for c in compiles) \
        == sources
    assert all("arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert calls[-1].startswith("-shared")
    assert so.exists() and so.parent == tmp_path / "build"
    assert [p.name for p in so.parent.iterdir()] == [so.name]
    assert os.path.basename(so).startswith("libkspec_kernels_")


# fault C2, both directions: cells JAX's kernel takes that the port ran
# through the matmul (fft 128 mult 81 at 50%; fft 16 at 90% with the
# largest multiplier JAX's predicate accepts there, 152), and a cell JAX
# sends to its matmul that the port's kernel takes (fft 64 mult 96 at 90%).
@pytest.mark.parametrize("fft,nono,mult,mode", [(128, 0.5, 81, "AVG"),
                                                (128, 0.5, 81, "MIN"),
                                                (16, 0.1, 152, "AVG"),
                                                (16, 0.1, 152, "MAX")])
def test_packed_plain_matches_jax_kernel_at_c2_cells(fft, nono, mult, mode):
    cfg = zs_cfg(fft, nono, mode, x_res=fft, fft2full_mult4less=mult)
    assert jpk.supports_fused_packed(cfg)
    assert cuda_packed.supports_fused_packed(cfg)
    assert not jpk.supports_fused_packed(
        zs_cfg(fft, nono, x_res=fft, fft2full_mult4less=mult + 1))
    re, im = noise_planes(cfg, 2, seed=mult)
    want = np.asarray(jpk.curscan_fused_packed(
        jnp.asarray(re), jnp.asarray(im), cfg, t_tile=2))
    got = cuda_packed.curscan_fused_packed(torch.from_numpy(re),
                                           torch.from_numpy(im), cfg)
    assert_spectra_close(got.numpy(), want)


def test_packed_plain_matches_jax_matmul_where_only_the_port_takes_k2():
    cfg = zs_cfg(64, 0.1, x_res=64, fft2full_mult4less=96)
    assert cfg.full_size == 6144
    assert cuda_packed.supports_fused_packed(cfg)
    assert not jpk.supports_fused_packed(cfg)
    re, im = noise_planes(cfg, 3, seed=96)
    want = np.asarray(jspec.curscan_direct_batched(jnp.asarray(re),
                                                   jnp.asarray(im), cfg))
    got = tspec.curscan_auto_batched(torch.from_numpy(re),
                                     torch.from_numpy(im), cfg)
    assert_spectra_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# A NumPy model of csrc/curscan_packed.cu's index plan: thread blocks of
# `blocks` IQ blocks, G lane groups an IQ block, L lanes of P points a
# window, the staged chunk spans, the radix-2 passes in registers and across
# lanes (the exchange of __shfl_xor_sync), the bins each lane folds, and the
# partial folds combined in group order; the FFT in float64 (complex128),
# |X| as the float32 square root of |X|^2 rounded to float32, float32 folds.
# It is held to the plain version run in float64, as the card's check is.
# ---------------------------------------------------------------------------

def bitrev(x, bits):
    r = np.zeros_like(x)
    for i in range(bits):
        r = (r << 1) | ((x >> i) & 1)
    return r


def model_bins(p, lanes):
    """bin_of: the bin register r of lane l holds, (L, P)."""
    lp, ll = p.bit_length() - 1, lanes.bit_length() - 1
    lane = np.arange(lanes)[:, None]
    r = np.arange(p)[None, :]
    pos, rk = np.zeros((lanes, p), int), np.broadcast_to(r, (lanes, p)).copy()
    for s in range(ll):
        h, pb = lanes >> (s + 1), p >> (s + 1)
        rk &= ~pb
        pos |= np.where(r & pb, h, 0)
        rk |= np.where(lane & h, pb, 0)
    return bitrev(rk, lp) + p * bitrev(pos, ll)


def model_window(x, wsr, tw, p, lanes):
    """One window in registers: x (L, P) complex samples x[l + L*r] -> the
    (L, P) values after the passes (register r of lane l)."""
    n = p * lanes
    lane = np.arange(lanes)
    v = x * wsr
    for s in range(p.bit_length() - 1):                  # fft_regs
        half = p >> (s + 1)
        for blk in range(0, p, 2 * half):
            for i in range(half):
                a, b = v[:, blk + i].copy(), v[:, blk + i + half].copy()
                m = i * (p // (2 * half))
                v[:, blk + i] = a + b
                d = a - b
                v[:, blk + i + half] = (d if m == 0 else
                                        d * -1j if 4 * m == p
                                        else d * tw[m * lanes])
    if lanes > 1:                                        # W_N^(l*k1)
        k1 = bitrev(np.arange(p), p.bit_length() - 1)
        v = v * tw[(lane[:, None] * k1[None, :]) % n]
    for s in range(lanes.bit_length() - 1):              # cross_lanes
        h, pb = lanes >> (s + 1), p >> (s + 1)
        hi = (lane & h) != 0
        sgn = np.where(hi, -1.0, 1.0)
        w = sgn * (tw[(lane % h) * (n // (2 * h))] if h > 1 else 1.0)
        for r in range(p):
            if r & pb:
                continue
            own = np.where(hi, v[:, r | pb], v[:, r])
            send = np.where(hi, v[:, r], v[:, r | pb])
            recv = send[lane ^ h]                       # __shfl_xor_sync
            v[:, r] = own + recv
            v[:, r | pb] = (own - recv) * w
    return v


def model_kernel(re, im, cfg, plan):
    """What the kernel writes for planes (T, full_size), float32 or u8."""
    n, p, lanes = cfg.fft_size, plan.p, plan.lanes
    t = re.shape[0]
    align = 16 // re.itemsize
    st, wts, wscale, tw = (a.numpy() for a in cuda_packed._tables(
        n, cfg.window, cfg.window_starts, cfg.cur_scan_cumu_mode,
        torch.device("cpu")))
    tw = tw[:, 0] + 1j * tw[:, 1]
    fold = cuda_curscan._FOLD[cfg.cur_scan_cumu_mode]
    init = (0.0, -np.inf, np.inf)[fold]
    fold1 = (lambda acc, wt, x: acc + wt * x, lambda acc, wt, x:
             np.maximum(acc, x), lambda acc, wt, x: np.minimum(acc, x))[fold]
    lane = np.arange(lanes)
    wsr = wscale[lane[:, None] + lanes * np.arange(p)[None, :]]
    bins = model_bins(p, lanes)
    assert sorted(bins.ravel()) == list(range(n))      # a permutation
    w_cnt = len(st)
    assert plan.blocks * plan.groups * lanes == cuda_packed.THREADS
    assert plan.n_chunks == -(-w_cnt // plan.chunk)
    out = np.full((t, n), np.nan, np.float32)
    seen = np.zeros((t, w_cnt), int)
    for b in range(t):                   # thread block b // blocks
        partial = np.full((plan.groups, n), init, np.float32)
        for g in range(plan.groups):
            acc = np.full((lanes, p), init, np.float32)
            for c in range(plan.n_chunks):
                a0 = st[c * plan.chunk] // align * align
                last = st[min(w_cnt, (c + 1) * plan.chunk) - 1]
                a1 = -(-(last + n) // align) * align
                assert a1 - a0 <= plan.stride and a1 <= cfg.full_size
                xr, xi = (cuda_packed.spectrum.decode_u8(torch.from_numpy(
                    x[b, a0:a1])).numpy().astype(np.float64) for x in (re, im))
                for w in range(c * plan.chunk + g,
                               min(w_cnt, (c + 1) * plan.chunk), plan.groups):
                    seen[b, w] += 1
                    off = st[w] - a0 + lane[:, None] + lanes * np.arange(p)
                    v = model_window(xr[off] + 1j * xi[off], wsr, tw, p,
                                     lanes)
                    mag = np.sqrt((v.real ** 2 + v.imag ** 2)
                                  .astype(np.float32))
                    acc = fold1(acc, wts[w], mag).astype(np.float32)
            partial[g, bins] = acc
        res = partial[0]
        for g in range(1, plan.groups):                 # in group order
            res = fold1(res, 1.0, partial[g]).astype(np.float32)
        out[b, (np.arange(n) + n // 2) % n] = res
    assert (seen == 1).all()                            # every window once
    return out


MODEL_CASES = [  # (fft, overlap, mult, mode, window, T, groups, chunk)
    (2, 0.1, 128, "AVG", WINDOW_KAISER, 2, 32, 160),      # ragged chunks
    (2, 0.5, 192, "MIN", WINDOW_ONES, 2, 1, 0),
    (8, 0.25, 32, "MAX", WINDOW_KAISER, 3, 4, 12),
    (8, 0.1, 48, "RAW", WINDOW_KAISER, 2, 8, 0),
    (64, 0.1, 8, "AVG", WINDOW_ONES, 3, 4, 0),            # quickFullScan
    (64, 0.1, 8, "MIN", WINDOW_ONES, 2, 32, 0),
    (64, 0.5, 16, "AVG", WINDOW_KAISER, 3, 2, 6),
    (128, 0.5, 12, "MAX", WINDOW_KAISER, 2, 4, 8),
    (128, 0.1, 4, "AVG", WINDOW_KAISER, 2, 8, 8),
    (128, 1.0, 3, "RAW", WINDOW_HANNING, 2, 1, 2),
    (64, 0.1, 96, "MIN", WINDOW_KAISER, 2, 32, 0)]     # 951 windows


@pytest.mark.parametrize("fft,nono,mult,mode,window,t,groups,chunk",
                         MODEL_CASES)
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_kernel_model_matches_plain(fft, nono, mult, mode, window, t,
                                    groups, chunk, u8):
    """The model of the kernel's index plan, with the wrapper's plan or a
    forced split (groups, and chunks whose last one is ragged), equals the
    plain version run in float64 within the per-bin bound; u8 planes stage
    as bytes."""
    cfg = zs_cfg(fft, nono, mode, window=window, x_res=fft,
                 fft2full_mult4less=mult)
    rng = np.random.default_rng(fft * 1000 + mult)
    re, im = (rng.integers(0, 256, (t, cfg.full_size), dtype=np.uint8)
              for _ in range(2))
    if not u8:
        re, im = decoded(re), decoded(im)
    plan = cuda_packed.launch_plan(fft, cfg.window_starts, t, u8)
    if chunk:
        w = cfg.num_windows
        assert w % chunk                                  # ragged
        plan = plan._replace(
            groups=groups, blocks=cuda_packed.THREADS // plan.lanes // groups,
            chunk=chunk, n_chunks=-(-w // chunk), stride=int(
                cuda_packed.chunk_spans(cfg.window_starts, fft, chunk,
                                        16 // re.itemsize).max()))
    got = model_kernel(re, im, cfg, plan)
    want = cuda_packed.curscan_fused_packed_plain(
        *(torch.from_numpy(decoded(x) if u8 else x).double()
          for x in (re, im)), cfg).numpy()
    assert_spectra_close(got, want)


def test_launch_plan_fills_the_card_and_walks_any_block():
    """quickFullScan's serial sweep (T = 1226) gets 32 groups an IQ block,
    one IQ block a thread block; catch-up's T = 19616 4 groups and 8 IQ
    blocks; fft 128 x 399 walks its block in chunks; a thread block stages
    at most about 80 KiB for every config the predicate takes."""
    qfs = zs_cfg(64, 0.1, window=WINDOW_ONES, x_res=64)
    serial = cuda_packed.launch_plan(64, qfs.window_starts, 1226, False)
    assert (serial.groups, serial.blocks, serial.n_chunks) == (32, 1, 1)
    catch_up = cuda_packed.launch_plan(64, qfs.window_starts, 19616, False)
    assert (catch_up.groups, catch_up.blocks, catch_up.n_chunks) == (4, 8, 1)
    big = zs_cfg(128, 0.5, x_res=128, fft2full_mult4less=399)
    assert big.full_size == 51072
    assert cuda_packed.launch_plan(128, big.window_starts, 1024,
                                   False).n_chunks > 1
    for fft in cuda_packed.SPLIT:
        for nono in (0.5, 0.1, 2.0):
            for mult in range(1, 400, 7):
                cfg = zs_cfg(fft, nono, x_res=fft, fft2full_mult4less=mult)
                if not cuda_packed.supports_fused_packed(cfg):
                    continue
                for t, u8 in ((1226, False), (19616, True), (19616, False)):
                    pl = cuda_packed.launch_plan(fft, cfg.window_starts, t,
                                                 u8)
                    spans = cuda_packed.chunk_spans(
                        cfg.window_starts, fft, pl.chunk, 16 if u8 else 4)
                    assert pl.stride == spans.max()
                    staged = ((2 if pl.n_chunks > 1 else 1) * pl.blocks * 2
                              * pl.stride * (1 if u8 else 4))
                    assert staged + cuda_packed.THREADS * pl.p * 4 \
                        <= 84 << 10, (fft, nono, mult, t, u8, pl)
