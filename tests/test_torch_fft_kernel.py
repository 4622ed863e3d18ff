"""A NumPy model of the FFT curscan kernel's index math
(``kspecanal_tpu_torch/csrc/curscan_fft.cu``), step by step, held against
``np.fft`` and against the JAX package on the CPU.

The model follows the kernel's decomposition: the pass order and radices
(a first pass of radix ``m / 16**q`` in {2, 4, 8, 16}, then radix-16 passes),
the 16 registers of each of the ``m/16`` threads, the radix-4/radix-2
split of the radix-16 and radix-8 butterflies, the twiddle-table indices into
the one N-point roots table, the padded shared-memory index function and
its banks, the Stockham output order (thread t ends with bins
``t + k*m/16``), the fftshift write, the window-group split with its fixed
combine order, and the c-block cluster split above fft 16384.  It rounds
where the kernel rounds: values are float32 in registers and shared memory,
each butterfly (with its pass twiddle from the float32 table) runs in
float64 and rounds to float32 after its inner DFT-4 stage and at its end.

Tolerances: the model is held to ``np.fft`` in float64 at 1e-6 of the peak
(a float32 radix FFT rounds like ``eps * log2 N``; the model's float64
butterflies stay near 1e-7 of the peak at N = 131072); its folds and the
port's plain path are held to the JAX chain with the HIGHEST-class bounds of
``torch_parity.assert_spectra_close`` that the kernel meets on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.config import CUMU_MAX, CUMU_MIN
from kspecanal_tpu.ops import spectrum as jspec
from kspecanal_tpu_torch.ops import cuda_curscan
from torch_parity import MODES, assert_spectra_close, decoded, raw_planes, \
    zs_cfg

RADIX = 16
BLOCK_N = 16384
POW2 = [1 << e for e in range(8, 18)]          # 256 .. 131072
W16 = np.exp(-2j * np.pi * np.arange(16) / 16)      # float64 constants


def pad(a):
    """The kernel's shared-memory index: one float2 of padding per 16."""
    return a + (a >> 4)


def radices(m):
    """Pass radices of an m-point block FFT (``m = 2**L``, L in 8..14):
    ``q = (L - 1) // 4`` radix-16 passes after a first pass of radix
    ``m >> 4q``."""
    log2m = m.bit_length() - 1
    q = (log2m - 1) // 4
    return [m >> (4 * q)] + [RADIX] * q


def dft4(a, b, c, d):
    s0, d0, s1, d1 = a + c, a - c, b + d, b - d
    mi = -1j * d1                                   # -i * d1
    return s0 + s1, d0 + mi, s0 - s1, d0 - mi


def f32(x):
    """Round complex128 values to complex64 (a float2 store), and back."""
    return x.astype(np.complex64).astype(np.complex128)


def dft(x, tw=None):
    """Natural-order DFT of the list ``x`` (2, 4, 8 or 16 complex64 register
    columns), element r first multiplied by the float32 twiddle ``tw[r]``,
    computed as the kernel computes it: in float64, rounded to float32 at
    the end and, for 16 = 4 x 4 and 8 = 4 x 2, once between the inner DFT-4
    (over stride-``r/4`` values, then ``W16^(e)``) and the outer DFT."""
    r = len(x)
    d = [np.asarray(v, np.complex128) for v in x]
    if tw is not None:
        d = [v if i == 0 else v * np.asarray(tw[i], np.complex128)
             for i, v in enumerate(d)]
    if r == 2:
        return [f32(d[0] + d[1]), f32(d[0] - d[1])]
    if r == 4:
        return [f32(v) for v in dft4(*d)]
    n2s = r // 4                                    # 4 for 16, 2 for 8
    y = {}
    for n2 in range(n2s):
        for k1, v in enumerate(dft4(*(d[n2 + n2s * i] for i in range(4)))):
            y[n2, k1] = f32(v * W16[n2 * k1 * (16 // r)])
    out = [None] * r
    for k1 in range(4):
        col = [y[n2, k1] for n2 in range(n2s)]
        outer = dft4(*col) if n2s == 4 else [col[0] + col[1], col[0] - col[1]]
        for k2, v in enumerate(outer):
            out[k1 + 4 * k2] = f32(v)
    return out


class Banks:
    """Records each warp-wide shared-memory access (one address per thread)
    and its bank conflict degree: 8-byte accesses are served a half-warp at
    a time, and a half-warp's 16 addresses must fall on 16 distinct
    8-byte bank pairs (``addr % 16``)."""

    def __init__(self):
        self.worst = 0

    def access(self, addr):
        for half in np.asarray(addr).reshape(-1, 16):
            _, counts = np.unique(np.unique(half) % 16, return_counts=True)
            self.worst = max(self.worst, int(counts.max()))


def block_fft(v, m, n, roots, banks=None):
    """One thread block's m-point FFT.  ``v[..., t, e]`` is element
    ``t + e*m/16`` in thread t's registers; returns ``[..., t, k]`` = bin
    ``t + k*m/16``.  Twiddles index the n-point table ``roots``."""
    nt = m // RADIX
    t = np.arange(nt)
    rad = radices(m)
    banks = banks or Banks()
    buf = np.zeros(v.shape[:-2] + (pad(m - 1) + 1,), np.complex128)
    r0, nb = rad[0], RADIX // rad[0]
    # Pass 1 (Ns = 1): butterfly j = t + i*nt on elements i + r*nb, which sit
    # at j + r*m/r0; output k goes to j*r0 + k.
    outs = [dft([v[..., i + r * nb] for r in range(r0)]) for i in range(nb)]
    for i in range(nb):
        for k in range(r0):
            addr = pad((t + i * nt) * r0 + k)
            banks.access(addr)
            buf[..., addr] = outs[i][k]
    ns = r0
    for p in range(len(rad) - 1):
        x = []
        for r in range(RADIX):
            addr = pad(t + r * nt)
            banks.access(addr)
            x.append(buf[..., addr])
        stride = n // (ns * RADIX)
        idx = [r * (t % ns) * stride for r in range(RADIX)]
        assert max(i.max() for i in idx) < n
        y = dft(x, [roots[i] for i in idx])
        if p == len(rad) - 2:
            return np.stack(y, axis=-1)
        for k in range(RADIX):
            addr = pad((t // ns) * ns * RADIX + t % ns + k * ns)
            banks.access(addr)
            buf[..., addr] = y[k]
        ns *= RADIX
    raise AssertionError("unreachable: every block FFT has >= 2 passes")


def cluster_size(n):
    return max(1, n // BLOCK_N)


def kernel_fft(a, roots, banks=None):
    """The kernel's n-point FFT of frames ``a[..., n]`` (complex64), natural
    order.  n <= 16384: one block.  Above, a cluster of c = n/16384 blocks:
    block j' holds the chunk ``a[j'*M : (j'+1)*M]`` (M = n/c) in its shared
    memory; block q reads every chunk at its own positions (distributed
    shared memory) and forms ``z_q[m] = W_N^(m q) * sum_j' a[m + M j']
    W_c^(j' q)`` in its registers, then its M-point FFT gives the bins
    ``c*k + q``."""
    n = a.shape[-1]
    c = cluster_size(n)
    m = n // c
    nt = m // RADIX
    pos = np.arange(nt)[:, None] + np.arange(RADIX)[None, :] * nt
    out = np.empty(a.shape, np.complex64)
    for q in range(c):
        z = a[..., pos].astype(np.complex128)
        for j in range(1, c):
            z = z + a[..., j * m + pos] * np.complex128(
                roots[((j * q) % c) * m])
        if q:
            z = z * roots[pos * q].astype(np.complex128)
        out[..., c * pos + q] = block_fft(f32(z), m, n, roots, banks)
    return out


def tables(cfg):
    starts, weights, window, roots = cuda_curscan._tables(
        cfg.fft_size, cfg.window, cfg.window_starts, cfg.cur_scan_cumu_mode,
        torch.device("cpu"))
    return (starts.numpy(), weights.numpy(), window.numpy(),
            (roots[:, 0] + 1j * roots[:, 1]).numpy().astype(np.complex64))


def curscan_model(re, im, cfg, groups):
    """The kernel on float32 planes ``(T, full_size)``: frame and window,
    FFT, ``weights[w] * |X|``, fold each group's windows in order, combine
    the groups' partials in the order g = 0..G-1, fftshift write."""
    n = cfg.fft_size
    starts, weights, window, roots = tables(cfg)
    idx = starts[:, None] + np.arange(n)[None, :]
    a = (re[:, idx] * window + 1j * (im[:, idx] * window)).astype(np.complex64)
    x = kernel_fft(a, roots)
    mag = weights[None, :, None] * np.sqrt(x.real * x.real + x.imag * x.imag)
    mode = cfg.cur_scan_cumu_mode
    op = (np.maximum if mode == CUMU_MAX else np.minimum if mode == CUMU_MIN
          else np.add)
    w = len(starts)
    parts = []
    for g in range(groups):
        lo, hi = g * w // groups, (g + 1) * w // groups
        acc = mag[:, lo]
        for i in range(lo + 1, hi):
            acc = op(acc, mag[:, i])
        parts.append(acc)
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    out = np.empty_like(acc)
    out[:, (np.arange(n) + n // 2) & (n - 1)] = acc
    return out


@pytest.mark.parametrize("n", POW2)
def test_model_fft_matches_numpy(n):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n)))
    roots = np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)
    got = kernel_fft(a.astype(np.complex64), roots)
    want = np.fft.fft(a.astype(np.complex64).astype(np.complex128))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-6


@pytest.mark.parametrize("fft", [2048, 16384, 32768])
def test_float64_butterflies_beat_a_float32_fft(fft):
    """Why the butterflies run in float64: a MIN fold at 90% overlap keeps
    bins near 1% of its peak, where two float32 FFTs differ by up to ~2e-6
    of the peak against the 1e-6 the bound allows.  Against float64 the
    model's fold errs (rms over bins) at most 0.7 times as much as the
    float32 ``torch.fft`` chain (the plain version) on the same planes; the
    ratio is 0.57-0.62 over seeds, and part of what remains is the float32
    windowed frame, which both share."""
    cfg = zs_cfg(fft, 0.1, "MIN")
    rng = np.random.default_rng(fft)
    re, im = (rng.standard_normal((2, cfg.full_size)).astype(np.float32)
              for _ in range(2))
    exact = cuda_curscan.curscan_fused_sublane_plain(
        torch.from_numpy(re).double(), torch.from_numpy(im).double(),
        cfg).numpy()
    plain = cuda_curscan.curscan_fused_sublane_plain(
        torch.from_numpy(re), torch.from_numpy(im), cfg).numpy()
    model = curscan_model(re, im, cfg, 1)
    rms = [np.sqrt(np.mean((x - exact) ** 2)) for x in (model, plain)]
    assert rms[0] <= 0.7 * rms[1]


@pytest.mark.parametrize("m", POW2[:7])
def test_plan_and_shared_memory_banks(m):
    """Every block size runs 16 elements a thread on m/16 threads, the last
    pass is radix 16, and no shared-memory access of any pass has a bank
    conflict; the padded buffer holds m + m/16 float2."""
    rad = radices(m)
    assert int(np.prod(rad)) == m and rad[0] in (2, 4, 8, 16)
    assert rad[1:] == [RADIX] * (len(rad) - 1) and len(rad) >= 2
    assert pad(m - 1) + 1 <= m + m // 16
    banks = Banks()
    v = np.zeros((m // RADIX, RADIX), np.complex64)
    block_fft(v, m, m, np.ones(m, np.complex64), banks)
    assert banks.worst == 1


def test_cluster_split_covers_every_bin_once():
    """Above fft 16384 the c = n/16384 blocks (c <= 8, the portable cluster
    size) write the bins c*k + q, k < 16384: every bin once; the kernel's
    output index is the fftshift (bin + n/2) mod n."""
    for n in POW2:
        c = cluster_size(n)
        m = n // c
        assert c <= 8 and m <= BLOCK_N and c * m == n
        bins = np.concatenate([c * np.arange(m) + q for q in range(c)])
        assert np.array_equal(np.sort(bins), np.arange(n))
        shifted = (bins + n // 2) & (n - 1)
        assert np.array_equal(shifted, (bins + n // 2) % n)


def test_window_groups_rule_and_split():
    """G = min(W, ceil(8 * SMs / (T * c))), at least 1; group g takes the
    windows [g*W//G, (g+1)*W//G): contiguous, in order, none empty."""
    wg = cuda_curscan.window_groups
    assert wg(4096, 2048, 15, 132) == 1          # zero-span main
    assert wg(288, 16384, 71, 132) == 4          # fmScan, 16 sweeps
    assert wg(288, 16384, 15, 132) == 4          # K3's cell
    assert wg(18, 16384, 71, 132) == 59          # fmScan, one sweep
    assert wg(2, 65536, 15, 132) == 15
    assert wg(1, 2048, 1, 132) == 1
    for t, n, w in ((1, 2048, 15), (7, 131072, 71), (100, 16384, 71)):
        g = wg(t, n, w, 132)
        assert 1 <= g <= w
        spans = [(i * w // g, (i + 1) * w // g) for i in range(g)]
        assert spans[0][0] == 0 and spans[-1][1] == w
        assert all(lo < hi for lo, hi in spans)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("mode", MODES)
def test_group_split_changes_only_the_sum_order(mode):
    """MAX/MIN partials combine exactly; AVG/RAW sums differ by rounding
    only."""
    cfg = zs_cfg(2048, 0.5, mode)
    re, im = (decoded(p) for p in raw_planes(cfg, 2, seed=31))
    one = curscan_model(re, im, cfg, 1)
    three = curscan_model(re, im, cfg, 3)
    if mode in (CUMU_MAX, CUMU_MIN):
        np.testing.assert_array_equal(three, one)
    else:
        assert_spectra_close(three, one)


def jax_chain(re, im, cfg):
    return np.asarray(jspec.curscan_batched(jnp.asarray(re), jnp.asarray(im),
                                            cfg))


@pytest.mark.parametrize("nono", [0.5, 0.1])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fft", [2048, 16384])
def test_model_folds_match_jax_chain(fft, mode, nono):
    cfg = zs_cfg(fft, nono, mode)
    re, im = (decoded(p) for p in raw_planes(cfg, 2, seed=fft + 7))
    groups = cuda_curscan.window_groups(2, fft, cfg.num_windows, 132)
    assert_spectra_close(curscan_model(re, im, cfg, groups),
                         jax_chain(re, im, cfg))


@pytest.mark.parametrize("nono", [0.5, 0.1])
@pytest.mark.parametrize("mode", ["AVG", "MIN"])
@pytest.mark.parametrize("fft", [32768, 65536])
def test_large_fft_plain_and_model_match_jax_chain(fft, mode, nono):
    """fft 32768 and 65536, which the JAX package sends to its sublane
    kernel: the port's plain path (the wrapper on CPU tensors) and the
    cluster model against the JAX chain."""
    cfg = zs_cfg(fft, nono, mode, x_res=512)
    re, im = (decoded(p) for p in raw_planes(cfg, 1, seed=fft + 3))
    want = jax_chain(re, im, cfg)
    got = cuda_curscan.curscan_fused_sublane(torch.from_numpy(re),
                                             torch.from_numpy(im), cfg)
    assert_spectra_close(got.numpy(), want)
    assert_spectra_close(curscan_model(re, im, cfg, 2), want)
