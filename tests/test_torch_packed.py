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
# NumPy models of csrc/curscan_packed.cu's two forms: L lanes of P points a
# window (N = P L), the radix-2 passes in registers and the exchange across
# lanes, the bins each lane folds, the staged spans, and the partial folds
# combined in group order; the FFT in float64 (complex128), |X| as the
# float32 square root of |X|^2 rounded to float32, float32 folds.  Each is
# held to the plain version run in float64, as the card's check is.
#
# The parent form (-DKSPEC_PACKED_PARENT=1): thread blocks of `blocks` IQ
# blocks, G lane groups an IQ block, the cross-lane passes as the exchange
# of __shfl_xor_sync.
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


def model_window(x, wsr, tw, p, lanes, stop="full"):
    """One window in registers: x (L, P) complex samples x[l + L*r] -> the
    (L, P) values after the cut-off ``stop`` (register r of lane l)."""
    n = p * lanes
    lane = np.arange(lanes)
    v = x * wsr
    if stop == "input":
        return v
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
    if stop == "regs":
        return v
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


def model_slots(p, lanes, stop="full"):
    """slot_of: the output slot of register r of lane l at the cut-off
    ``stop``, (L, P)."""
    lane = np.arange(lanes)[:, None]
    r = np.arange(p)[None, :]
    if stop == "input":
        return lane + lanes * r
    if stop == "regs":
        return lane + lanes * bitrev(r, p.bit_length() - 1)
    return model_bins(p, lanes)


def model_kernel(re, im, cfg, plan, stop="full"):
    """What the parent form (cut off after ``stop``) writes for planes (T,
    full_size), float32 or u8, at its plan (``parent_plan``)."""
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
    bins = model_slots(p, lanes, stop)
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
                                     lanes, stop)
                    mag = (np.sqrt((v.real ** 2 + v.imag ** 2)
                                   .astype(np.float32)) if stop == "full"
                           else np.abs(v.real + v.imag).astype(np.float32))
                    acc = fold1(acc, wts[w], mag).astype(np.float32)
            partial[g, bins] = acc
        res = partial[0]
        for g in range(1, plan.groups):                 # in group order
            res = fold1(res, 1.0, partial[g]).astype(np.float32)
        out[b, (np.arange(n) + n // 2) % n] = res
    assert (seen == 1).all()                            # every window once
    return out



# The production form: the four-step FFT with each lane's L-point DFTs
# rotated by its lane index (inputs times W_L^(j2 j1)), the lane twiddle,
# the select-free exchange (round q: lane k takes register q from lane
# k - bitrev(q)) and an L-point DFT with exponent + on bit-reversed input;
# one thread block a unit of IQ blocks, its chunks in order.

def w16(k, conj=False):
    """W_16^k (conj: W_16^-k), the kernel's constant twiddles."""
    return np.exp((2j if conj else -2j) * np.pi * k / 16)


def model_dif(v, m, base):
    """dif<M, B>: radix-2 decimation in frequency of columns base..base+m
    of v (L, P); column base + q ends as output bitrev(q)."""
    half = m // 2
    while half >= 1:
        for blk in range(0, m, 2 * half):
            for i in range(half):
                a = v[:, base + blk + i].copy()
                b = v[:, base + blk + i + half].copy()
                v[:, base + blk + i] = a + b
                v[:, base + blk + i + half] = (a - b) * w16(i * (8 // half))
        half //= 2


def model_dit_conj(v, m, base):
    """dit_conj<M, B>: radix-2 decimation in time, exponent +, of columns
    base..base+m holding input bitrev(q) in column base + q."""
    half = 1
    while half < m:
        for blk in range(0, m, 2 * half):
            for i in range(half):
                a = v[:, base + blk + i].copy()
                b = v[:, base + blk + i + half] * w16(i * (8 // half), True)
                v[:, base + blk + i] = a + b
                v[:, base + blk + i + half] = a - b
        half *= 2


def model_prod_window(x, wscale, tw, p, lanes, stop="full"):
    """window<T, P, L>: x (L, P) complex samples x[l + L*r] -> the (L, P)
    values of the lanes' registers after the cut-off ``stop``."""
    n = p * lanes
    c = p // lanes if lanes > 1 else 1
    ll = lanes.bit_length() - 1
    lane = np.arange(lanes)[:, None]
    r = np.arange(p)[None, :]
    ws = wscale[lane + lanes * r]
    if c == 1 and lanes > 1:                # the window times the rotation
        v = x * (ws * tw[((r * lane) % lanes) * (n // lanes)])
    else:
        v = x * ws
    if stop == "input":
        return v
    if lanes == 1:
        model_dif(v, p, 0)
        return v
    if c == 2:                              # the first pass, the rotation
        for j in range(lanes):
            a, b = v[:, j].copy(), v[:, j + lanes].copy()
            v[:, j] = a + b
            v[:, j + lanes] = (a - b) * w16(j * 16 // p)
        um = tw[((np.arange(lanes)[None, :] * lane) % lanes) * (n // lanes)]
        for e in range(2):
            for j in range(1, lanes):
                v[:, e * lanes + j] *= um[:, j]
    for e in range(c):
        model_dif(v, lanes, e * lanes)
    k1 = c * ((bitrev(r % lanes, ll) + lane) % lanes) + r // lanes
    v = v * tw[(lane * k1) % n]             # the lane twiddle W_N^(j1 k1)
    if stop == "regs":
        return v
    for e in range(c):                      # the exchange
        for q in range(1, lanes):
            src = (np.arange(lanes) - bitrev(np.array(q), ll)) % lanes
            v[:, e * lanes + q] = v[src, e * lanes + q]
    for e in range(c):
        model_dit_conj(v, lanes, e * lanes)
    return v


def model_prod_slots(p, lanes, stop="full"):
    """slot<P, L>: the output slot of register r of lane l, (L, P)."""
    lane = np.arange(lanes)[:, None]
    r = np.arange(p)[None, :]
    c = p // lanes if lanes > 1 else 1
    if stop == "input":
        return lane + lanes * r
    if lanes == 1:
        return bitrev(r, p.bit_length() - 1)
    ll = lanes.bit_length() - 1
    e, q = r // lanes, r % lanes
    if stop == "regs":
        return lane + lanes * (c * ((bitrev(q, ll) + lane) % lanes) + e)
    return c * lane + e + p * q


def model_walk(plan, t, starts, n, full_size, align):
    """The production form's walk: thread block u serves unit u, IQ blocks
    u * blocks onward, its chunks in order.  Yields (IQ blocks, w0,
    windows, a0) of each chunk, after checking each staged span lies in
    the planes and within ``stride``."""
    for u in range(-(-t // plan.blocks)):
        b = np.arange(u * plan.blocks, min(t, (u + 1) * plan.blocks))
        for c in range(plan.n_chunks):
            w0 = c * plan.chunk
            cw = min(plan.chunk, len(starts) - w0)
            a0 = starts[w0] // align * align
            a1 = -(-(starts[w0 + cw - 1] + n) // align) * align
            assert a1 - a0 <= plan.stride and a1 <= full_size
            yield b, w0, cw, a0


def model_prod_kernel(re, im, cfg, plan, stop="full"):
    """What the production form (cut off after ``stop``) writes for planes
    (T, full_size), float32 or u8, at ``plan``."""
    n, p, lanes = cfg.fft_size, plan.p, plan.lanes
    t = re.shape[0]
    st, wts, wscale, tw = (a.numpy() for a in cuda_packed._tables(
        n, cfg.window, cfg.window_starts, cfg.cur_scan_cumu_mode,
        torch.device("cpu")))
    tw = tw[:, 0] + 1j * tw[:, 1]
    fold = cuda_curscan._FOLD[cfg.cur_scan_cumu_mode]
    init = (0.0, -np.inf, np.inf)[fold]
    slots = model_prod_slots(p, lanes, stop)
    assert sorted(slots.ravel()) == list(range(n))      # a permutation
    lane = np.arange(lanes)[:, None]
    out = np.full((t, n), np.nan, np.float32)
    seen = np.zeros((t, len(st)), int)
    acc = {}
    for blocks, w0, cw, a0 in model_walk(plan, t, st, n, cfg.full_size,
                                         16 // re.itemsize):
        for b in blocks:
            xr, xi = (cuda_packed.spectrum.decode_u8(torch.from_numpy(
                x[b])).numpy().astype(np.float64) for x in (re, im))
            for g in range(plan.groups):
                a = acc.setdefault((b, g), np.full((lanes, p), init,
                                                   np.float32))
                for w in range(w0 + g, w0 + cw, plan.groups):
                    seen[b, w] += 1
                    off = st[w] + lane + lanes * np.arange(p)
                    v = model_prod_window(xr[off] + 1j * xi[off], wscale, tw,
                                          p, lanes, stop)
                    mag = (np.sqrt((v.real ** 2 + v.imag ** 2)
                                   .astype(np.float32)) if stop == "full"
                           else np.abs(v.real + v.imag).astype(np.float32))
                    a[...] = ((np.float64(wts[w]) * mag + a)   # fmaf
                              .astype(np.float32), np.maximum(a, mag),
                              np.minimum(a, mag))[fold]
            if w0 + cw == len(st):               # the unit's last chunk
                part = np.full((plan.groups, n), init, np.float32)
                for g in range(plan.groups):
                    part[g, slots] = acc.pop((b, g))
                res = part[0]
                for g in range(1, plan.groups):             # group order
                    res = (res + part[g], np.maximum(res, part[g]),
                           np.minimum(res, part[g]))[fold].astype(np.float32)
                out[b] = np.roll(res, n // 2)
    assert (seen == 1).all() and not acc                # every window once
    return out


def forced(plan, cfg, groups, chunk, u8):
    """``plan`` with a forced split: ``groups`` lane groups, chunks of
    ``chunk`` windows."""
    w = cfg.num_windows
    return plan._replace(
        groups=groups, blocks=cuda_packed.THREADS // plan.lanes // groups,
        chunk=chunk, n_chunks=-(-w // chunk), stride=int(
            cuda_packed.chunk_spans(cfg.window_starts, cfg.fft_size, chunk,
                                    16 if u8 else 4).max()))


MODEL_CASES = [  # (fft, overlap, mult, mode, window, T, groups, chunk)
    (2, 0.1, 128, "AVG", WINDOW_KAISER, 2, 32, 160),      # ragged chunks
    (2, 0.5, 192, "MIN", WINDOW_ONES, 2, 1, 0),
    (8, 0.25, 32, "MAX", WINDOW_KAISER, 3, 4, 12),
    (8, 0.1, 48, "RAW", WINDOW_KAISER, 2, 8, 0),
    (64, 0.1, 8, "AVG", WINDOW_ONES, 3, 4, 0),            # quickFullScan
    (64, 0.1, 8, "MIN", WINDOW_ONES, 2, 32, 0),
    (64, 0.5, 16, "AVG", WINDOW_KAISER, 3, 2, 6),
    (32, 0.25, 16, "RAW", WINDOW_KAISER, 3, 8, 10),
    (128, 0.5, 12, "MAX", WINDOW_KAISER, 2, 4, 8),
    (128, 0.1, 4, "AVG", WINDOW_KAISER, 2, 8, 8),
    (128, 1.0, 3, "RAW", WINDOW_HANNING, 2, 1, 2),
    (64, 0.1, 96, "MIN", WINDOW_KAISER, 2, 32, 0)]     # 951 windows


@pytest.mark.parametrize("form", ["new", "parent"])
@pytest.mark.parametrize("fft,nono,mult,mode,window,t,groups,chunk",
                         MODEL_CASES)
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_kernel_model_matches_plain(fft, nono, mult, mode, window, t,
                                    groups, chunk, u8, form):
    """The model of each form's index plan, with the wrapper's plan or a
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
    if form == "parent":
        plan = cuda_packed.parent_plan(fft, cfg.window_starts, t, u8)
    else:
        plan = cuda_packed.launch_plan(fft, cfg.window_starts, t, u8)
    if chunk:
        assert cfg.num_windows % chunk                    # ragged
        plan = forced(plan, cfg, groups, chunk, u8)
    model = model_kernel if form == "parent" else model_prod_kernel
    got = model(re, im, cfg, plan)
    want = cuda_packed.curscan_fused_packed_plain(
        *(torch.from_numpy(decoded(x) if u8 else x).double()
          for x in (re, im)), cfg).numpy()
    assert_spectra_close(got, want)


def test_launch_plan_fills_the_card_and_walks_any_block():
    """The production plan on 132 SMs takes the parent form's groups, so the
    groups fold in the parent's order: quickFullScan's catch-up T = 19616
    gets 4 groups an IQ block and 8 IQ blocks a unit, its windows in one
    buffer, on u8 as on float32; the serial sweep's T = 1226 32 groups, one
    IQ block a unit; fft 128 x 399 walks its block in chunks of a multiple
    of the groups; where one window of the group rule's IQ blocks would not
    fit a chunk (fft 16 at 90% over a million blocks: 256 IQ blocks a unit,
    spans of 20 samples), the groups double."""
    qfs = zs_cfg(64, 0.1, window=WINDOW_ONES, x_res=64)
    for u8 in (False, True):
        for t, want in ((19616, (4, 8, 1)), (1226, (32, 1, 1))):
            pl = cuda_packed.launch_plan(64, qfs.window_starts, t, u8)
            assert (pl.groups, pl.blocks, pl.n_chunks) == want
            assert pl.groups == cuda_packed.parent_plan(
                64, qfs.window_starts, t, u8).groups
    big = zs_cfg(128, 0.5, x_res=128, fft2full_mult4less=399)
    assert big.full_size == 51072
    pl = cuda_packed.launch_plan(128, big.window_starts, 64, False)
    assert pl.n_chunks > 1 and pl.chunk % pl.groups == 0
    tiny = zs_cfg(16, 0.1, x_res=16, fft2full_mult4less=16)
    assert cuda_packed.groups_for(16, tiny.num_windows, 10 ** 6, 132) == 1
    pl = cuda_packed.launch_plan(16, tiny.window_starts, 10 ** 6, False)
    assert (pl.groups, pl.blocks) == (2, 128)


def test_parent_plan_fills_the_card_and_walks_any_block():
    """The parent form's plan: quickFullScan's serial sweep (T = 1226) gets
    32 groups an IQ block, one IQ block a thread block; catch-up's T =
    19616 4 groups and 8 IQ blocks; fft 128 x 399 walks its block in
    chunks; a thread block stages at most about 80 KiB for every config
    the predicate takes."""
    qfs = zs_cfg(64, 0.1, window=WINDOW_ONES, x_res=64)
    serial = cuda_packed.parent_plan(64, qfs.window_starts, 1226, False)
    assert (serial.groups, serial.blocks, serial.n_chunks) == (32, 1, 1)
    catch_up = cuda_packed.parent_plan(64, qfs.window_starts, 19616, False)
    assert (catch_up.groups, catch_up.blocks, catch_up.n_chunks) == (4, 8, 1)
    big = zs_cfg(128, 0.5, x_res=128, fft2full_mult4less=399)
    assert cuda_packed.parent_plan(128, big.window_starts, 1024,
                                   False).n_chunks > 1
    for fft in cuda_packed.SPLIT:
        for nono in (0.5, 0.1, 2.0):
            for mult in range(1, 400, 7):
                cfg = zs_cfg(fft, nono, x_res=fft, fft2full_mult4less=mult)
                if not cuda_packed.supports_fused_packed(cfg):
                    continue
                for t, u8 in ((1226, False), (19616, True), (19616, False)):
                    pl = cuda_packed.parent_plan(fft, cfg.window_starts, t,
                                                 u8)
                    spans = cuda_packed.chunk_spans(
                        cfg.window_starts, fft, pl.chunk, 16 if u8 else 4)
                    assert pl.stride == spans.max()
                    staged = ((2 if pl.n_chunks > 1 else 1) * pl.blocks * 2
                              * pl.stride * (1 if u8 else 4))
                    assert staged + cuda_packed.THREADS * pl.p * 4 \
                        <= 84 << 10, (fft, nono, mult, t, u8, pl)


def shared_bytes(plan, u8):
    """The production kernel's shared memory at ``plan`` as the source's
    layout() adds it up: the lane constants (P L double2; at C = 2 also L L,
    at L > 1 also P L), one chunk buffer or, with several chunks, two (both
    planes of the unit's IQ blocks over ``stride`` samples, the chunk's
    starts and weights, each rounded to 16 bytes), the partial folds
    (THREADS P floats)."""
    p, lanes = plan.p, plan.lanes
    c = p // lanes if lanes > 1 else 1
    consts = 16 * (p * lanes + (lanes * lanes if c == 2 else 0)
                   + (p * lanes if lanes > 1 else 0))
    staged = (-(-plan.blocks * 2 * plan.stride * (1 if u8 else 4) // 16)
              * 16 + 2 * (-(-4 * plan.chunk // 16) * 16))
    return (consts + (2 if plan.n_chunks > 1 else 1) * staged
            + cuda_packed.THREADS * p * 4)


@pytest.mark.parametrize("fft", sorted(cuda_packed.SPLIT))
def test_launch_plan_covers_every_block_and_window_once(fft):
    """For every config the predicate takes at fft 2-128, curScanNonOverlap
    0.5, 0.25 and 0.1 and fft2FullMult 1-399 (u8 and f32 in turns, T from
    1 to about 20000): the units (one thread block each) cover the T IQ
    blocks once; the chunks of a unit cover its windows, each once, in
    window order; every staged span lies in the planes and within
    ``stride``; a chunk fits ``CHUNK_BYTES`` (twice at P = 16; a unit's
    windows in one buffer twice that) and the kernel's shared memory the
    share of four blocks an SM (P <= 8) or two (P = 16) of the H100's 228
    KiB, less 1 KiB a block; the groups are the parent form's and a chunk a multiple of
    them, so the folds add in the parent's order, for u8 and float32 planes
    alike (u8 gives the bits of its decoded float32)."""
    p, _ = cuda_packed.SPLIT[fft]
    limit = (228 << 10) // (4 if p <= 8 else 2) - 1024
    for nono in (0.5, 0.25, 0.1):
        for mult in range(1, 400):
            cfg = zs_cfg(fft, nono, x_res=fft, fft2full_mult4less=mult)
            if not cuda_packed.supports_fused_packed(cfg):
                continue
            u8 = bool(mult % 2)
            t = 1 + (mult * 4999 + int(nono * 100)) % 20000
            starts = np.asarray(cfg.window_starts)
            pl = cuda_packed.launch_plan(fft, cfg.window_starts, t, u8)
            other = cuda_packed.launch_plan(fft, cfg.window_starts, t,
                                            not u8)
            assert (other.groups, other.chunk) == (pl.groups, pl.chunk)
            assert pl.groups == cuda_packed.parent_plan(
                fft, cfg.window_starts, t, u8).groups
            assert pl.n_chunks == 1 or pl.chunk % pl.groups == 0
            units = -(-t // pl.blocks)
            assert units * pl.blocks >= t > (units - 1) * pl.blocks
            assert pl.groups * pl.blocks * pl.lanes == cuda_packed.THREADS
            w0 = np.arange(pl.n_chunks) * pl.chunk
            cw = np.minimum(pl.chunk, len(starts) - w0)
            assert (cw > 0).all() and cw.sum() == len(starts)
            align = 16 if u8 else 4
            a0 = starts[w0] // align * align
            a1 = -(-(starts[w0 + cw - 1] + fft) // align) * align
            assert (a1 - a0 <= pl.stride).all() \
                and (a1 <= cfg.full_size).all()
            staged = (-(-pl.blocks * 2 * pl.stride * (1 if u8 else 4) // 16)
                      * 16 + 2 * (-(-4 * pl.chunk // 16) * 16))
            assert staged <= cuda_packed.CHUNK_BYTES * (
                2 if pl.n_chunks == 1 else 1) * (1 if p <= 8 else 2), \
                (nono, mult, pl)
            assert shared_bytes(pl, u8) <= limit, (nono, mult, pl)


@pytest.mark.parametrize("form", ["new", "parent"])
@pytest.mark.parametrize("stage", cuda_packed.STAGES)
@pytest.mark.parametrize("fft,nono,mult,mode,t,groups,chunk", [
    (64, 0.1, 8, "AVG", 3, 8, 0), (32, 0.25, 16, "RAW", 2, 4, 10),
    (128, 0.5, 12, "MAX", 2, 8, 8), (16, 0.5, 32, "MIN", 2, 16, 0),
    (2, 0.5, 128, "AVG", 2, 64, 0)])
def test_stage_plain_matches_the_models(fft, nono, mult, mode, t, groups,
                                        chunk, stage, form):
    """Each cut-off's plain version (``curscan_packed_stage``'s on CPU
    tensors, float64) against the model of its form cut off there, on u8
    planes, within the per-bin bound (below 'full' the folded value is
    |re + im| at the slot of the value's position)."""
    cfg = zs_cfg(fft, nono, mode, x_res=fft, fft2full_mult4less=mult)
    rng = np.random.default_rng(fft + mult)
    re, im = (rng.integers(0, 256, (t, cfg.full_size), dtype=np.uint8)
              for _ in range(2))
    parent = form == "parent"
    if parent:
        plan = cuda_packed.parent_plan(fft, cfg.window_starts, t, True)
    else:
        plan = cuda_packed.launch_plan(fft, cfg.window_starts, t, True)
    if chunk:
        plan = forced(plan, cfg, groups, chunk, True)
    model = model_kernel if parent else model_prod_kernel
    got = model(re, im, cfg, plan, stage)
    want = cuda_packed.curscan_packed_stage(
        torch.from_numpy(re), torch.from_numpy(im), cfg, stage, parent)
    assert want.dtype == torch.float64 and want.shape == (t, fft)
    assert_spectra_close(got, want.numpy())
