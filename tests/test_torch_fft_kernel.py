"""A NumPy model of the FFT curscan kernel's index math
(``kspecanal_tpu_torch/csrc/curscan_fft.cu``), step by step, held against
``np.fft`` and against the JAX package on the CPU.

The model follows the kernel's decomposition.  Powers of two up to 131072
(``curscan_fft64_kernel``, the float64 form, up to 65536, one block up to
8192 points and clusters of 8192 above; ``curscan_fft_kernel``, the parent
form, at 131072 and in the build that times it): the pass order and radices
(a first pass of radix ``m / 16**q`` in {2, 4, 8, 16}, then radix-16
passes), the 16 registers of each of the ``m/16`` threads (the float64
form's first pass in place), the radix-4/radix-2 split of the radix-16 and
radix-8 butterflies, the twiddle-table indices into the one N-point roots
table, the shared-memory index functions (the float64 form's swizzled
double2 buffer, the parent's padded float2 one) and their banks, the
Stockham output order (thread t ends with bins ``t + k*m/16``), the
fftshift write, the window-group split with its fixed combine order, and
the c-block cluster split.  Every other size the JAX dispatcher sends
to a Pallas kernel (``curscan_mixed_kernel``: the other multiples of 128,
and the lane kernel's sizes off the 128 grid such as 2500, 3000, 10000 and
39800): the block split (c blocks of M = N/c points, a cluster up to 131072
where a power of two splits N, a radix-c step through a scratch buffer
elsewhere), the odd prime passes first as butterfly passes in the symmetric
DFT-p form (the first from device memory where the block input lies there;
primes up to 13 a whole butterfly a thread, ``small_pass``; larger primes as
8 x 8 float64 tile products of a warp, ``large_pass_mma``, or in groups of
output pairs held in registers where the pass writes the buffer it reads,
``large_pass_hold``; twiddles one lookup in the pass's float64 table, the
exchange between two buffers where they fit), their ragged thread loops,
the power-of-two passes after them, the ragged plan where 16 does not
divide M (ceil(M/16) threads, outputs t + e*nt < M, one last power-of-two
pass of radix 2, 4 or 8), and the fftshift modulo.  It rounds where the
kernel rounds.  The float64 form: the samples widened and windowed in
float64, float64 through every butterfly (float64 roots) and between
passes, |X|^2 rounded to float32 once and its square root taken there.
The float64 form's staging of the next frame through shared memory changes
no value and is not modelled.  The parent form and the mixed kernel: values
are float32 in registers and
shared memory, each power-of-two butterfly (with its pass twiddle from the
float32 table) runs in float64 and rounds to float32 after its inner DFT-4
stage and at its end; an odd pass rounds once per output.

Tolerances: the model is held to ``np.fft`` in float64 at 1e-6 of the peak
(a float32 radix FFT rounds like ``eps * log2 N``; the model's float64
butterflies stay near 1e-7 of the peak at N = 262144); its folds and the
port's plain path are held to the JAX chain with the HIGHEST-class bounds of
``torch_parity.assert_spectra_close`` that the kernel meets on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.config import CUMU_MAX, CUMU_MIN
from kspecanal_tpu.ops import spectrum as jspec
from kspecanal_tpu_torch.config import window_lut
from kspecanal_tpu_torch.ops import cuda_curscan
from torch_parity import MODES, assert_spectra_close, decoded, raw_planes, \
    zs_cfg

RADIX = 16
BLOCK_N = 16384
CLUSTER_MAX_N = 8 * BLOCK_N
F64_BLOCK_N = 8192                  # the float64 form's largest block
POW2 = [1 << e for e in range(8, 18)]          # 256 .. 131072
# Multiples of 128 that are not powers of two below 131072 (one block, then
# clusters of 2 and 8) and sizes above it (the scratch route: c = 12, 16).
MIXED = [384, 1280, 16256, 20480, 98304, 130944, 196608, 262144]
# The lane kernel's sizes off the 128 grid (the ragged plan): 2500 = 2^2 *
# 5^4, 3000 = 2^3 * 3 * 5^3, 10000 = 2^4 * 5^4 (16 divides it: the plan of
# 16 points a thread), 39800 = 2^3 * 5^2 * 199 (a cluster of 4 blocks of
# 9950 = 2 * 5^2 * 199), 33250 = 2 * 5^3 * 7 * 19 (2 * odd above 32768, no
# power of two splits it: the scratch route, c = 5) and 131100 = 2^2 * 3 *
# 5^2 * 19 * 23 (above 131072: the scratch route, c = 10).
LANE = [2500, 3000, 10000, 39800, 33250, 131100]
W16 = np.exp(-2j * np.pi * np.arange(16) / 16)      # float64 constants


def pad(a):
    """The parent form's shared-memory index: one float2 of padding per
    16."""
    return a + (a >> 4)


def swz(a):
    """The float64 form's shared-memory index: element a stays in its
    aligned group of 8 double2 (128 bytes), at a ^ ((a >> 3) ^ (a >> 4)) &
    7 in it; no padding."""
    return a ^ (((a >> 3) ^ (a >> 4)) & 7)


def pow2_split(n, parent=False):
    """(c, float64 form) of the power-of-two kernel for an n-point window:
    the float64 form, one block up to 8192 points, n/8192 blocks above;
    the parent form in its own build, one block up to 16384, clusters of
    16384 above."""
    if parent:
        return max(1, n // BLOCK_N), False
    return max(1, n // F64_BLOCK_N), True


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


def f64(x):
    """The float64 form rounds nothing between its butterflies' stages."""
    return np.asarray(x, np.complex128)


def dft(x, tw=None, rnd=f32):
    """Natural-order DFT of the list ``x`` (2, 4, 8 or 16 register columns),
    element r first multiplied by the twiddle ``tw[r]``, computed as the
    kernel computes it: in float64, rounded by ``rnd`` (to float32 in the
    parent form and the mixed kernel, not at all in the float64 form) at
    the end and, for 16 = 4 x 4 and 8 = 4 x 2, once between the inner DFT-4
    (over stride-``r/4`` values, then ``W16^(e)``) and the outer DFT."""
    r = len(x)
    d = [np.asarray(v, np.complex128) for v in x]
    if tw is not None:
        d = [v if i == 0 else v * np.asarray(tw[i], np.complex128)
             for i, v in enumerate(d)]
    if r == 2:
        return [rnd(d[0] + d[1]), rnd(d[0] - d[1])]
    if r == 4:
        return [rnd(v) for v in dft4(*d)]
    n2s = r // 4                                    # 4 for 16, 2 for 8
    y = {}
    for n2 in range(n2s):
        for k1, v in enumerate(dft4(*(d[n2 + n2s * i] for i in range(4)))):
            y[n2, k1] = rnd(v * W16[n2 * k1 * (16 // r)])
    out = [None] * r
    for k1 in range(4):
        col = [y[n2, k1] for n2 in range(n2s)]
        outer = dft4(*col) if n2s == 4 else [col[0] + col[1], col[0] - col[1]]
        for k2, v in enumerate(outer):
            out[k1 + 4 * k2] = rnd(v)
    return out


class Banks:
    """Records each warp-wide shared-memory access (one address per thread,
    in units of the access's ``width`` bytes) and its bank conflict degree:
    the 32 banks of 4 bytes serve 128 bytes a wavefront, so 8-byte accesses
    are served a half-warp at a time and a half-warp's 16 addresses must
    fall on 16 distinct 8-byte bank pairs (``addr % 16``), 16-byte accesses
    a quarter-warp at a time on 8 distinct groups of 4 banks (``addr %
    8``)."""

    def __init__(self, width=8):
        self.lanes = 128 // width
        self.worst = 0

    def access(self, addr):
        addr = np.asarray(addr).ravel()
        step = self.lanes
        for i in range(0, len(addr), step):      # the last may be partial
            _, counts = np.unique(np.unique(addr[i:i + step]) % step,
                                  return_counts=True)
            self.worst = max(self.worst, int(counts.max()))


def block_fft(v, m, n, roots, banks=None, stop=None):
    """One thread block's m-point FFT in the parent form.  ``v[..., t, e]``
    is element ``t + e*m/16`` in thread t's registers; returns ``[..., t,
    k]`` = bin ``t + k*m/16``.  Twiddles index the n-point float32 table
    ``roots``.  ``stop`` 'pass1' returns the registers after pass 1: slot
    ``i*r0 + k`` holds output k of butterfly ``t + i*m/16`` (position
    ``(t + i*m/16)*r0 + k``)."""
    nt = m // RADIX
    t = np.arange(nt)
    rad = radices(m)
    banks = banks or Banks()
    buf = np.zeros(v.shape[:-2] + (pad(m - 1) + 1,), np.complex128)
    r0, nb = rad[0], RADIX // rad[0]
    # Pass 1 (Ns = 1): butterfly j = t + i*nt on elements i + r*nb, which sit
    # at j + r*m/r0; output k goes to j*r0 + k.
    outs = [dft([v[..., i + r * nb] for r in range(r0)]) for i in range(nb)]
    if stop == "pass1":
        return np.stack([outs[s // r0][s % r0] for s in range(RADIX)],
                        axis=-1)
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


def block_fft64(v, m, n, roots, banks=None, stop=None):
    """One thread block's m-point FFT in the float64 form (m <= 8192):
    ``v[..., t, e]`` (complex128) is element ``t + e*m/16``; returns
    ``[..., t, k]`` = bin ``t + k*m/16``.  Pass 1 runs in place: slot ``i +
    k*nb`` (nb = 16/r0) takes output k of butterfly ``t + i*m/16`` (``stop``
    'pass1' returns these slots); every exchange is a float64 buffer of m
    double2 at ``swz``, 16-byte accesses counted by ``banks``; a pass's
    twiddles are one lookup W = roots[(t mod ns) * n / (16 ns)] in the
    n-point float64 table and its powers W^r by recurrence; nothing is
    rounded."""
    nt = m // RADIX
    t = np.arange(nt)
    rad = radices(m)
    banks = banks or Banks(16)
    buf = np.zeros(v.shape[:-2] + (m,), np.complex128)
    r0, nb = rad[0], RADIX // rad[0]
    slots = [None] * RADIX
    for i in range(nb):
        y = dft([v[..., i + r * nb] for r in range(r0)], rnd=f64)
        for k in range(r0):
            slots[i + k * nb] = y[k]
    if stop == "pass1":
        return np.stack(slots, axis=-1)
    for i in range(nb):
        for k in range(r0):
            addr = swz((t + i * nt) * r0 + k)
            banks.access(addr)
            buf[..., addr] = slots[i + k * nb]
    ns = r0
    for p in range(len(rad) - 1):
        x = []
        for r in range(RADIX):
            addr = swz(t + r * nt)
            banks.access(addr)
            x.append(buf[..., addr])
        stride = n // (ns * RADIX)
        y = dft(x, [None] + powers(roots[(t % ns) * stride], RADIX - 1),
                rnd=f64)
        if p == len(rad) - 2:
            return np.stack(y, axis=-1)
        for k in range(RADIX):
            addr = swz((t // ns) * ns * RADIX + t % ns + k * ns)
            banks.access(addr)
            buf[..., addr] = y[k]
        ns *= RADIX
    raise AssertionError("unreachable: every block FFT has >= 2 passes")


def block_split(n):
    """(c, through scratch) of one n-point window: the powers of two up to
    131072 :func:`pow2_split`'s; else one block up to 16384; up to 131072
    the smallest power of two with n/c <= 16384 (a cluster), where it
    divides n; else the smallest divisor with n/c <= 16384 (and a multiple
    of 16 where 16 divides n), through the scratch."""
    if runs_pow2(n):
        return pow2_split(n)[0], False
    if n <= BLOCK_N:
        return 1, False
    if n <= CLUSTER_MAX_N:
        c = 1 << (-(-n // BLOCK_N) - 1).bit_length()
        if n % c == 0:
            return c, False
    c = -(-n // BLOCK_N)
    while n % c or (n % RADIX == 0 and (n // c) % RADIX):
        c += 1
    return c, True


def cluster_size(n):
    return block_split(n)[0]


def odd_part(m):
    while m % 2 == 0:
        m //= 2
    return m


def odd_primes(m):
    """The odd passes' radices: the prime factors of the odd part m,
    ascending, found as the kernel finds them (trial division, the rest
    prime once ``p * p`` exceeds it)."""
    out, p = [], 3
    while m > 1:
        if p * p > m:
            p = m
        while m % p == 0:
            out.append(p)
            m //= p
        p += 2
    return out


def mixed_plan(m):
    """Pass radices of the mixed kernel's m-point block: the odd primes,
    then the power-of-two passes of ``radices``."""
    pow2 = m // odd_part(m)
    return odd_primes(odd_part(m)) + radices(pow2)


SMALL_PRIME_MAX = 13     # larger primes run large_pass
SMEM_LIMIT = 232448      # a Hopper block's shared memory


def pass_table(ns, p):
    """The pass's float64 table (``cuda_curscan._pass_roots``):
    W_{ns p}^u for u < ns p."""
    return np.exp(-2j * np.pi * np.arange(ns * p) / (ns * p))


def twiddled(x, j, a, r, length, table, ns):
    """Input r of butterflies j (a = j mod ns): element j + r*len, widened,
    times the pass twiddle ``table[r * a]`` (none in the first pass)."""
    v = x(j + r * length)
    return v * table[r * a] if ns > 1 else v


def sym_pair(x0, sm, df, coef, k, p):
    """Outputs k and p - k of the symmetric DFT-p (k an int or an array):
    A = x_0 + sum s_r Re W_p^(rk), B = sum d_r Im W_p^(rk) (``coef[e]`` =
    W_p^e), X_k = A + iB, X_{p-k} = A - iB, as the kernel writes them."""
    a, b = x0.copy(), np.zeros_like(x0)
    for r in range(1, len(sm) + 1):
        w = coef[(r * k) % p]
        a = a + sm[r - 1] * w.real
        b = b + df[r - 1] * w.imag
    return ((a.real - b.imag) + 1j * (a.imag + b.real),
            (a.real + b.imag) + 1j * (a.imag - b.real))


def small_pass(x, p, ns, m, banks):
    """``small_pass<P>`` (p <= 13): thread t of ceil(m/16) owns the
    butterflies j = t + i*nt < m/p (i < ceil(16/p)); butterfly j loads its
    p inputs once (``x``: the block input in device memory, or the padded
    buffer), twiddles input r by the pass table's entry r * (j mod ns),
    runs the symmetric DFT-p with W_p^k = table[ns k] in float64 and stores
    output k, rounded once, at (j - a)*p + a + k*ns.  Returns the
    destination buffer."""
    nt = -(-m // RADIX)
    length, h = m // p, (p - 1) // 2
    table = pass_table(ns, p)
    coef = table[ns * np.arange(p)]
    dst = x.dst(m)
    for i in range(-(-RADIX // p)):
        j = np.arange(nt) + i * nt
        j = j[j < length]
        if not len(j):
            continue
        a = j % ns
        xs = [twiddled(x, j, a, r, length, table, ns) for r in range(p)]
        sm = [xs[r] + xs[p - r] for r in range(1, h + 1)]
        df = [xs[r] - xs[p - r] for r in range(1, h + 1)]
        outs = {0: xs[0] + sum(sm)}
        for k in range(1, h + 1):
            outs[k], outs[p - k] = sym_pair(xs[0], sm, df, coef, k, p)
        o = (j - a) * p + a
        for k in range(p):
            banks.access(pad(o + k * ns))
            dst[..., pad(o + k * ns)] = f32(outs[k])
    return dst


def large_pass(x, p, ns, m, banks, g_pairs=4):
    """``large_pass_hold`` (p >= 17, in place): butterfly j's outputs in
    groups of G pairs (k, p - k), item it = g*len + j; thread t takes the
    items t + e*nt.  An item reads each of its butterfly's inputs once
    (twiddled as in :func:`small_pass`), sums s_r and d_r times the group's
    coefficients W_p^(rk) from the p-entry table, and stores X_k, X_{p-k}
    (and X_0 from the first group) rounded once, after every thread has
    read."""
    nt = -(-m // RADIX)
    length, h = m // p, (p - 1) // 2
    items = length * -(-h // g_pairs)
    assert -(-items // nt) <= 3                       # HOLD_ITEMS
    table = pass_table(ns, p)
    coef = table[ns * np.arange(p)]
    dst = x.dst(m)
    for e in range(-(-items // nt)):
        it = np.arange(nt) + e * nt
        it = it[it < items]
        g, j = it // length, it % length
        a = j % ns
        k0 = 1 + g * g_pairs
        x0 = x(j)
        xs = {r: twiddled(x, j, a, r, length, table, ns)
              for r in range(1, p)}
        sm = [xs[r] + xs[p - r] for r in range(1, h + 1)]
        df = [xs[r] - xs[p - r] for r in range(1, h + 1)]
        o = (j - a) * p + a
        for i in range(g_pairs):
            k = k0 + i
            ok = k <= h
            for kk, v in zip((k, p - k), sym_pair(x0, sm, df, coef, k, p)):
                addr = pad(o + kk * ns)[ok]
                banks.access(addr)
                dst[..., addr] = f32(v[..., ok])
        first = g == 0
        addr = pad(o)[first]
        banks.access(addr)
        dst[..., addr] = f32((x0 + sum(sm))[..., first])
    return dst


def large_pass_mma(x, p, ns, m, banks):
    """``large_pass_mma`` (p >= 17, out of place): the symmetric DFT-p as
    float64 tile products, rows k = 0..H (k = 0 gives X_0) by butterflies j
    in 8 x 8 tiles, one whole warp a tile (k fast), r four a step.  Lane
    (gid, tig) = (lane >> 2, lane & 3) loads s_r, d_r of r = 4*step + tig +
    1 and column j = 8*jt + gid (inputs j + r*len and j + (p-r)*len) and
    stores the outputs of row k = 8*kt + gid, columns 8*jt + 2*tig + i,
    rounded once.  The sums are the float64 ones of :func:`sym_pair`."""
    length, h = m // p, (p - 1) // 2
    table = pass_table(ns, p)
    coef = table[ns * np.arange(p)]
    jall = np.arange(length)
    aall = jall % ns
    xs = {r: twiddled(x.raw, jall, aall, r, length, table, ns)
          for r in range(p)}
    sm = [xs[r] + xs[p - r] for r in range(1, h + 1)]
    df = [xs[r] - xs[p - r] for r in range(1, h + 1)]
    out = {0: xs[0] + sum(sm)}
    for k in range(1, h + 1):
        out[k], out[p - k] = sym_pair(xs[0], sm, df, coef, k, p)
    dst = x.dst(m)
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    kt_n = h // 8 + 1
    for u in range(kt_n * -(-length // 8)):
        kt, jt = u % kt_n, u // kt_n
        jb = jt * 8 + gid
        for rs in range(-(-h // 4)):
            r = rs * 4 + tig + 1
            ok = (jb < length) & (r <= h)
            banks.access(x.addr(jb[ok] + r[ok] * length))
            banks.access(x.addr(jb[ok] + (p - r[ok]) * length))
        k = kt * 8 + gid
        for i in range(2):
            j = jt * 8 + 2 * tig + i
            ok = (k <= h) & (j < length)
            kk, jj = k[ok], j[ok]
            o = (jj - jj % ns) * p + jj % ns
            for sign in (1, -1):
                kout = np.where(sign > 0, kk, (p - kk) % p)
                sel = (sign > 0) | (kk > 0)
                addr = pad(o + kout * ns)[sel]
                banks.access(addr)
                vals = np.stack([out[int(a)][..., int(b)] for a, b in
                                 zip(kout[sel], jj[sel])], axis=-1) \
                    if sel.any() else None
                if vals is not None:
                    dst[..., addr] = f32(vals)
    return dst


class Source:
    """Where an odd pass reads element i: ``buf`` (the padded shared
    buffer, accesses recorded in ``banks``) or, with ``buf`` None, the block
    input ``x[..., i]`` in device memory.  ``raw`` reads without recording,
    ``addr`` gives the shared address of element i (None in device memory:
    no bank to count); ``dst(m)`` makes the buffer the pass writes."""

    def __init__(self, x, buf, banks):
        self.x, self.buf, self.banks = x, buf, banks

    def raw(self, i):
        if self.buf is None:
            return self.x[..., i].astype(np.complex128)
        return self.buf[..., pad(i)]

    def addr(self, i):
        return pad(i) if self.buf is not None else np.zeros(0, np.int64)

    def __call__(self, i):
        if self.buf is not None:
            self.banks.access(pad(i))
        return self.raw(i)

    def dst(self, m):
        lead = (self.x if self.buf is None else self.buf).shape[:-1]
        return np.zeros(lead + (pad(m - 1) + 1,), np.complex128)


def coef_entries(m):
    return sum(p for p in odd_primes(odd_part(m)) if p > SMALL_PRIME_MAX)


def ping(m, cluster):
    """Whether the odd passes ping-pong between two buffers: always up to
    512 threads (never a cluster), else where the tables, two padded
    buffers and the fold fit a block's shared memory."""
    nt = -(-m // RADIX)
    if nt <= 512 and not cluster:
        return True
    return coef_entries(m) * 16 + 2 * (m + m // 16) * 8 + m * 4 <= SMEM_LIMIT


def odd_pass(src, p, ns, m, banks, hold):
    """``odd_pass``: ``small_pass`` for p <= 13, else ``large_pass_hold``
    where the pass writes the buffer it reads or the block has no whole
    warp, ``large_pass_mma`` where not."""
    if p <= SMALL_PRIME_MAX:
        return small_pass(src, p, ns, m, banks)
    if hold or -(-m // RADIX) < 32:
        return large_pass(src, p, ns, m, banks)
    return large_pass_mma(src, p, ns, m, banks)


def pow2_pass_ragged(buf, r0, ns, m, n, roots, banks):
    """``pow2_pass_ragged<R0>`` (ns = m/r0, the odd part): butterfly j = t +
    i*nt (i < 16/r0, j < ns) reads and writes elements j + r*ns, twiddled
    by ``roots[r * j * n/m]``."""
    nt = -(-m // RADIX)
    for i in range(RADIX // r0):
        j = np.arange(nt) + i * nt
        j = j[j < ns]
        if not len(j):
            continue
        xs = []
        for r in range(r0):
            banks.access(pad(j + r * ns))
            xs.append(buf[..., pad(j + r * ns)])
        tws = j * (n // (ns * r0))
        y = dft(xs, [roots[r * tws] for r in range(r0)])
        for k in range(r0):
            banks.access(pad(j + k * ns))
            buf[..., pad(j + k * ns)] = y[k]


def mixed_block_fft(x, m, n, roots, banks=None, in_regs=True, stop=None):
    """One thread block of the mixed kernel: the m-point FFT of the block
    input ``x[..., m]`` (complex64; element i).  ``in_regs``: the input lies
    in device memory (planes or scratch), so the first odd pass reads it
    there; else (the cluster's z) it is staged in the buffer at pad(t +
    e*m/16) first.  The odd passes follow the kernel's exchange (``ping``:
    two buffers, else in place; the same addresses either way).  Returns
    ``[..., t, k]`` = bin t + k*m/16; twiddles index the n-point table.
    Where 16 does not divide m (the ragged plan) the entries of bins t +
    k*nt >= m are zero.  ``stop='odd'`` returns the ``[..., m]`` positions
    after the odd passes instead."""
    banks = banks or Banks()
    nt = -(-m // RADIX)
    ragged = m % RADIX != 0
    t = np.arange(nt)
    primes = odd_primes(odd_part(m))
    ns = 1
    if in_regs and primes:
        buf = odd_pass(Source(x, None, banks), primes[0], 1, m, banks,
                       hold=False)
        ns = primes.pop(0)
    else:
        buf = np.zeros(x.shape[:-1] + (pad(m - 1) + 1,), np.complex128)
        for e in range(RADIX):
            i = (t + e * nt)[t + e * nt < m]
            banks.access(pad(i))
            buf[..., pad(i)] = x[..., i]
    for p in primes:
        buf = odd_pass(Source(x, buf, banks), p, ns, m, banks,
                       hold=not ping(m, not in_regs))
        ns *= p
    if stop == "odd":
        return buf[..., pad(np.arange(m))]
    if ragged:
        if m // ns > 1:
            pow2_pass_ragged(buf, m // ns, ns, m, n, roots, banks)
        y = np.zeros(x.shape[:-1] + (nt, RADIX), np.complex128)
        for e in range(RADIX):
            i = t + e * nt
            ok = i < m
            banks.access(pad(i[ok]))
            y[..., ok, e] = buf[..., pad(i[ok])]
        return y
    rad = radices(m // odd_part(m))
    r0, q = rad[0], len(rad) - 1
    nb = RADIX // r0
    outs = []
    for i in range(nb):
        j = t + i * nt
        xs = []
        for r in range(r0):
            banks.access(pad(j + r * (m // r0)))
            xs.append(buf[..., pad(j + r * (m // r0))])
        tws = (j % ns) * (n // (ns * r0))
        outs.append(dft(xs, [roots[r * tws] for r in range(r0)]))
    if q == 0:
        return np.stack(outs[0], axis=-1)
    for i in range(nb):
        j = t + i * nt
        jm = j % ns
        for k in range(r0):
            addr = pad((j - jm) * r0 + jm + k * ns)
            banks.access(addr)
            buf[..., addr] = outs[i][k]
    ns *= r0
    for p in range(q):
        xs = []
        for r in range(RADIX):
            banks.access(pad(t + r * nt))
            xs.append(buf[..., pad(t + r * nt)])
        tw = t % ns
        y = dft(xs, [roots[r * tw * (n // (ns * RADIX))]
                     for r in range(RADIX)])
        if p == q - 1:
            return np.stack(y, axis=-1)
        for k in range(RADIX):
            addr = pad((t - tw) * RADIX + tw + k * ns)
            banks.access(addr)
            buf[..., addr] = y[k]
        ns *= RADIX
    raise AssertionError("unreachable: the last pass returns")


def radix_c_step(a, roots, c):
    """The radix-c step shared by the cluster and ``dif_split``: ``z[...,
    q, i] = W_N^(i q) * sum_j a[i + M j] W_c^(j q)`` (float64, rounded
    once) for every q < c, M = n/c."""
    n = a.shape[-1]
    m = n // c
    pos = np.arange(m)
    z = np.empty(a.shape[:-1] + (c, m), np.complex128)
    for q in range(c):
        acc = a[..., pos].astype(np.complex128)
        for j in range(1, c):
            acc = acc + a[..., j * m + pos] * np.complex128(
                roots[((j * q) % c) * m])
        if q:
            acc = acc * roots[pos * q].astype(np.complex128)
        z[..., q, :] = f32(acc)
    return z


def mixed_fft(a, roots, banks=None, scratch=None):
    """The mixed kernel's n-point FFT of frames ``a[..., n]`` (complex64),
    natural order: blocks q < c each take z_q (the radix-c step; with
    ``scratch`` given, read from that (..., c, M) buffer as the scratch
    route's block kernel does) and write bins c*k + q."""
    n = a.shape[-1]
    c, via_scratch = block_split(n)
    m = n // c
    nt = -(-m // RADIX)
    z = (a[..., None, :].astype(np.complex128) if c == 1
         else radix_c_step(a, roots, c) if scratch is None else scratch)
    y = mixed_block_fft(z, m, n, roots, banks,
                        in_regs=c == 1 or via_scratch)   # [..., q, t, k]
    bins = np.arange(nt)[:, None] + np.arange(RADIX)[None, :] * nt
    ok = bins < m
    out = np.empty(a.shape, np.complex64)
    for q in range(c):
        out[..., c * bins[ok] + q] = y[..., q, :, :][..., ok]
    return out


def runs_pow2(n):
    """The power-of-two kernel serves n (else the mixed kernel)."""
    return n & (n - 1) == 0 and n <= CLUSTER_MAX_N


def roots64(n):
    """The float64 form's n-point roots table."""
    return np.exp(-2j * np.pi * np.arange(n) / n)


def powers(w1, count):
    """w1, w1^2, ..., w1^count by the float64 form's recurrence (each the
    one before times w1)."""
    out = [np.asarray(w1, np.complex128)]
    for _ in range(count - 1):
        out.append(out[-1] * w1)
    return out


def block_input(a, roots, c, q, rnd):
    """Block q's input z_q of a window ``a[..., n]`` split over c blocks of
    M = n/c points, as ``[..., t, e]`` (element t + e*M/16): the frame for c
    = 1, else ``z_q[m] = W_N^(m q) * sum_j a[m + M j] W_c^(j q)``.  The
    parent form (``rnd`` f32) reads the chunks of its cluster and the
    twiddle roots[m q] and narrows z to float32; the float64 form (``rnd``
    f64) reads the c chunks from device memory and takes W_N^(m q) =
    W_N^(t q) W_N^(M/16 q)^e by recurrence, rounding nothing."""
    n = a.shape[-1]
    m = n // c
    nt = m // RADIX
    pos = np.arange(nt)[:, None] + np.arange(RADIX)[None, :] * nt
    z = a[..., pos].astype(np.complex128)
    for j in range(1, c):
        z = z + a[..., j * m + pos] * np.complex128(roots[((j * q) % c) * m])
    if q and rnd is f64:
        t = np.arange(nt)
        wm = [roots[t * q]]
        for _ in range(RADIX - 1):
            wm.append(wm[-1] * roots[nt * q])
        z = z * np.stack(wm, axis=-1)
    elif q:
        z = z * roots[pos * q].astype(np.complex128)
    return rnd(z), pos


def kernel_fft(a, roots, banks=None, parent=False):
    """The kernel's n-point FFT of frames ``a[..., n]``, natural order;
    sizes other than the powers of two up to 131072 take :func:`mixed_fft`
    (complex64 frames, the float32 table ``roots``).  The powers of two take
    :func:`pow2_split`'s c blocks of M = n/c points (``parent``: the parent
    form's build): block q's input is :func:`block_input` and its M-point
    FFT gives the bins ``c*k + q``; the float64 form (complex128 frames,
    windowed in float64, its own float64 table, :func:`block_fft64`), the
    parent form (complex64 frames, the float32 table, :func:`block_fft`)."""
    n = a.shape[-1]
    if not runs_pow2(n):
        return mixed_fft(a, roots, banks)
    c, float64 = pow2_split(n, parent)
    m = n // c
    out = np.empty(a.shape, np.complex128 if float64 else np.complex64)
    for q in range(c):
        if float64:
            z, pos = block_input(a, roots64(n), c, q, f64)
            out[..., c * pos + q] = block_fft64(z, m, n, roots64(n), banks)
        else:
            z, pos = block_input(a, roots, c, q, f32)
            out[..., c * pos + q] = block_fft(z, m, n, roots, banks)
    return out


def tables(cfg):
    starts, weights, window, roots = cuda_curscan._tables(
        cfg.fft_size, cfg.window, cfg.window_starts, cfg.cur_scan_cumu_mode,
        torch.device("cpu"))
    return (starts.numpy(), weights.numpy(), window.numpy(),
            (roots[:, 0] + 1j * roots[:, 1]).numpy().astype(np.complex64))


def curscan_model(re, im, cfg, groups, chunk=None, parent=False):
    """The kernel on float32 planes ``(T, full_size)``: frame and window,
    FFT, ``weights[w] * |X|``, fold each group's windows in order, combine
    the groups' partials in the order g = 0..G-1, fftshift write (bin + N/2)
    mod N.  The float64 form of the power-of-two kernel windows with the
    float64 window and takes |X| as the float32 square root of |X|^2
    rounded to float32; the other forms window and take |X| in float32.
    Above fft 131072 the radix-c step fills a ``(chunk, W, c, M)`` scratch
    ``chunk`` IQ blocks at a time (``cuda_curscan.scratch_chunk`` by
    default) and the block kernel reads it."""
    n = cfg.fft_size
    starts, weights, window, roots = tables(cfg)
    idx = starts[:, None] + np.arange(n)[None, :]
    a = (re[:, idx] * window + 1j * (im[:, idx] * window)).astype(np.complex64)
    float64 = runs_pow2(n) and pow2_split(n, parent)[1]
    if float64:
        w64 = window_lut(cfg.window, n)
        a = (re[:, idx].astype(np.float64) * w64
             + 1j * (im[:, idx].astype(np.float64) * w64))
    c, via_scratch = block_split(n)
    if via_scratch:
        chunk = chunk or cuda_curscan.scratch_chunk(len(re), n, len(starts))
        x = np.empty(a.shape, np.complex64)
        for b0 in range(0, len(re), chunk):
            scratch = radix_c_step(a[b0:b0 + chunk], roots, c)
            assert scratch.shape[1:] == (len(starts), c, n // c)
            x[b0:b0 + chunk] = mixed_fft(a[b0:b0 + chunk], roots,
                                         scratch=scratch)
    else:
        x = kernel_fft(a, roots, parent=parent)
    if float64:
        mag = weights[None, :, None] * np.sqrt(
            (x.real * x.real + x.imag * x.imag).astype(np.float32))
    else:
        mag = weights[None, :, None] * np.sqrt(x.real * x.real
                                               + x.imag * x.imag)
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
    out[:, (np.arange(n) + n // 2) % n] = acc
    return out


@pytest.mark.parametrize("n", POW2 + MIXED + LANE)
def test_model_fft_matches_numpy(n):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n)))
    roots = np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)
    got = kernel_fft(a.astype(np.complex64), roots)
    want = np.fft.fft(a.astype(np.complex64).astype(np.complex128))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-6


@pytest.mark.parametrize("m", [3, 5, 7, 9, 15, 17, 127, 1023])
def test_mixed_model_matches_numpy_for_each_odd_part(m):
    """fft 128*m, one window: the odd passes (3, 5, 7 in registers; 9 = 3*3
    and 15 = 3*5 a register pass then a staged one; 17 and 127 staged; 1023
    = 3*11*31 in a cluster of 8, all staged), then the power-of-two
    passes."""
    n = 128 * m
    assert odd_primes(m) == {3: [3], 5: [5], 7: [7], 9: [3, 3], 15: [3, 5],
                             17: [17], 127: [127], 1023: [3, 11, 31]}[m]
    rng = np.random.default_rng(m)
    a = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n)))
    roots = np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)
    got = mixed_fft(a.astype(np.complex64), roots)
    want = np.fft.fft(a.astype(np.complex64).astype(np.complex128))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-6


@pytest.mark.parametrize("m,in_regs,p", [
    (1408, True, 11), (3 * 11 * 16, True, 11), (1664, True, 13),
    (5 * 13 * 16, False, 13), (2050, True, 41), (11110, True, 101),
    (13110, False, 23), (16 * 509, False, 509), (2 * 509, True, 509),
    (2 * 1013, False, 1013), (16 * 1013, True, 1013)])
def test_butterfly_passes_match_numpy_for_each_prime(m, in_regs, p):
    """Blocks whose plan has the prime p: 11 and 13 in registers
    (``small_pass``, first from device memory or after a 3 or 5 pass); 41,
    101, 23, 509 and 1013 as float64 tile products (``large_pass_mma``:
    first from device memory, from the staged buffer, or after other odd
    passes with their twiddles) or, where a pass writes the buffer it reads
    because two buffers do not fit (13110 = 2*3*5*19*23 in a cluster, 11110's
    11 and 101), in groups of pairs held in registers (``large_pass_hold``).
    The model's block FFT equals ``np.fft`` at 1e-6 of the peak."""
    assert p in odd_primes(odd_part(m))
    assert ping(m, not in_regs) == (m not in (11110, 13110, 16208))
    rng = np.random.default_rng(m + p)
    a = (rng.standard_normal((1, m)) + 1j * rng.standard_normal((1, m)))
    roots = np.exp(-2j * np.pi * np.arange(m) / m).astype(np.complex64)
    y = mixed_block_fft(a.astype(np.complex64), m, m, roots,
                        in_regs=in_regs)
    nt = -(-m // RADIX)
    bins = np.arange(nt)[:, None] + np.arange(RADIX)[None, :] * nt
    got = np.zeros(m, np.complex128)
    got[bins[bins < m]] = y[0][bins < m]
    want = np.fft.fft(a[0].astype(np.complex64).astype(np.complex128))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-6


@pytest.mark.parametrize("fft", [3000, 16256])
def test_mixed_min_fold_at_90_percent_within_half_the_bound(fft):
    """The mixed kernel's MIN fold at 90% overlap (71 windows), where bins
    sit near 1% of the peak: the model, held to the plain version run in
    float64 on the same planes, stays within half of the per-bin bound
    (5e-5 of the bin plus 1e-6 of the peak) at every bin, as the
    power-of-two kernel's does: each butterfly output rounds to float32
    once, the radix-127 pass of fft 16256 included."""
    cfg = zs_cfg(fft, 0.1, "MIN")
    rng = np.random.default_rng(fft)
    re, im = (rng.standard_normal((2, cfg.full_size)).astype(np.float32)
              for _ in range(2))
    exact = cuda_curscan.curscan_fused_sublane_plain(
        torch.from_numpy(re).double(), torch.from_numpy(im).double(),
        cfg).numpy()
    model = curscan_model(re, im, cfg, 1)
    bound = 5e-5 * np.abs(exact) + 1e-6 * np.max(np.abs(exact))
    assert np.max(np.abs(model - exact) / bound) <= 0.5


@pytest.mark.parametrize("fft", [3000, 10000, 39800, 33250])
def test_mixed_stage_plain_follows_the_model(fft):
    """``cuda_curscan.curscan_mixed_stage_plain`` defines what the kernel
    cut off after each stage folds: its 'odd' positions are the model's
    buffer after the odd passes (one block, a cluster of 4, the scratch
    route), its 'input' the block input and its 'pow2' the block's DFT, at
    1e-6 of the peak."""
    cfg = zs_cfg(fft, 0.5, "AVG", x_res=500)
    re, im = (decoded(p) for p in raw_planes(cfg, 1, seed=fft + 9))
    n = fft
    c, via_scratch = block_split(n)
    m = n // c
    starts, weights, window, roots = tables(cfg)
    idx = starts[:, None] + np.arange(n)[None, :]
    a = (re[:, idx] * window + 1j * (im[:, idx] * window)).astype(
        np.complex64)
    z = (a[..., None, :].astype(np.complex128) if c == 1
         else radix_c_step(a, roots, c))                  # (1, W, c, m)
    stages = {
        "input": z,
        "odd": mixed_block_fft(z, m, n, roots, in_regs=c == 1 or via_scratch,
                               stop="odd"),
        "pow2": np.fft.fft(z, axis=-1)}
    bins = (c * np.arange(m)[None, :] + np.arange(c)[:, None]).ravel()
    for stage, val in stages.items():
        acc = np.einsum("w,twqi->tqi", weights, val.real + val.imag)
        want = np.empty((1, n))
        want[:, (bins + n // 2) % n] = acc.reshape(1, -1)
        got = cuda_curscan.curscan_mixed_stage(
            torch.from_numpy(re), torch.from_numpy(im), cfg, stage).numpy()
        assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want)), \
            stage


@pytest.mark.parametrize("parent", [False, True], ids=["float64", "parent"])
@pytest.mark.parametrize("fft", [256, 2048, 16384, 65536, 131072])
def test_fft_stage_plain_follows_the_model(fft, parent):
    """``cuda_curscan.curscan_fft_stage_plain`` defines what the
    power-of-two kernel cut off after each stage folds, in both forms (one
    block; clusters of 2 and 8 blocks of 8192 in the float64 form, of 8
    blocks of 16384 at 131072): its 'input' positions hold the model's
    block input, its 'pass1' positions the model's registers after pass 1
    (slot to position as each form holds them), its 'radix16' the block's
    DFT; the fold of weights[w] * (re + im) agrees at 1e-6 of the peak."""
    cfg = zs_cfg(fft, 0.5, "AVG", x_res=512)
    re, im = (decoded(p) for p in raw_planes(cfg, 1, seed=fft + 11))
    n = fft
    c, float64 = pow2_split(n, parent)
    m = n // c
    nt = m // RADIX
    r0 = radices(m)[0]
    nb = RADIX // r0
    starts, weights, window, roots = tables(cfg)
    idx = starts[:, None] + np.arange(n)[None, :]
    if float64:
        w64 = window_lut(cfg.window, n)
        a = (re[:, idx].astype(np.float64) * w64
             + 1j * (im[:, idx].astype(np.float64) * w64))
        rts, rnd, bfft = roots64(n), f64, block_fft64
    else:
        a = (re[:, idx] * window + 1j * (im[:, idx] * window)).astype(
            np.complex64)
        rts, rnd, bfft = roots, f32, block_fft
    t = np.arange(nt)[:, None]
    k = np.arange(RADIX)[None, :]
    pass1_pos = ((t + (k % nb) * nt) * r0 + k // nb if float64
                 else (t + (k // r0) * nt) * r0 + k % r0)
    for stage in ("input", "pass1", "radix16"):
        want = np.zeros((1, n))
        for q in range(c):
            z, pos = block_input(a, rts, c, q, rnd)        # (1, W, nt, 16)
            if stage == "pass1":
                z, pos = bfft(z, m, n, rts, stop="pass1"), pass1_pos
            elif stage == "radix16":
                z = bfft(z, m, n, rts)
            acc = np.einsum("w,twij->tij", weights, z.real + z.imag)
            want[:, (c * pos + q + n // 2) % n] = acc
        got = cuda_curscan.curscan_fft_stage(
            torch.from_numpy(re), torch.from_numpy(im), cfg, stage,
            parent).numpy()
        assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want)), \
            stage


@pytest.mark.parametrize("parent", [False, True], ids=["float64", "parent"])
@pytest.mark.parametrize("fft", [2048, 16384, 32768])
def test_float64_butterflies_beat_a_float32_fft(fft, parent):
    """Why the butterflies run in float64: a MIN fold at 90% overlap keeps
    bins near 1% of its peak, where two float32 FFTs differ by up to ~2e-6
    of the peak against the 1e-6 the bound allows.  Held to the plain
    version run in float64 on the same planes, the model's fold stays within
    half of the per-bin bound of ``torch_parity.assert_spectra_close`` (5e-5
    of the bin plus 1e-6 of the peak) at every bin; the kernel measured at
    most 0.40 of it on the card.  The bound is fixed: it does not depend on
    the machine's float32 FFT library."""
    cfg = zs_cfg(fft, 0.1, "MIN")
    rng = np.random.default_rng(fft)
    re, im = (rng.standard_normal((2, cfg.full_size)).astype(np.float32)
              for _ in range(2))
    exact = cuda_curscan.curscan_fused_sublane_plain(
        torch.from_numpy(re).double(), torch.from_numpy(im).double(),
        cfg).numpy()
    model = curscan_model(re, im, cfg, 1, parent=parent)
    bound = 5e-5 * np.abs(exact) + 1e-6 * np.max(np.abs(exact))
    assert np.max(np.abs(model - exact) / bound) <= 0.5


@pytest.mark.parametrize("m,form", [(m, "parent") for m in POW2[:7]]
                         + [(m, "float64") for m in POW2[:6]])
def test_plan_and_shared_memory_banks(m, form):
    """Every block size runs 16 elements a thread on m/16 threads, the last
    pass is radix 16, and no shared-memory access of any pass has a bank
    conflict: the parent form's padded buffer of m + m/16 float2 (8-byte
    accesses, a half-warp a wavefront), the float64 form's swizzled buffer
    of m double2 (16-byte accesses, a quarter-warp a wavefront; ``swz``
    permutes each aligned group of 8, so the buffer is m double2 with no
    padding)."""
    rad = radices(m)
    assert int(np.prod(rad)) == m and rad[0] in (2, 4, 8, 16)
    assert rad[1:] == [RADIX] * (len(rad) - 1) and len(rad) >= 2
    if form == "parent":
        assert pad(m - 1) + 1 <= m + m // 16
        banks = Banks()
        v = np.zeros((m // RADIX, RADIX), np.complex64)
        block_fft(v, m, m, np.ones(m, np.complex64), banks)
    else:
        a = np.arange(m)
        assert np.array_equal(np.sort(swz(a)), a)
        assert np.array_equal(swz(a) >> 3, a >> 3)
        banks = Banks(16)
        v = np.zeros((m // RADIX, RADIX), np.complex128)
        block_fft64(v, m, m, np.ones(m, np.complex128), banks)
    assert banks.worst == 1


def test_the_parent_padding_conflicts_with_16_byte_accesses():
    """Why the float64 form swizzles: the parent's padding (one in 16) with
    double2 elements puts 2 of a quarter-warp's 8 stores of pass 1 on one
    bank group at every block size but 256 and 4096 (pass 1 of radix 16)."""
    worst = {}
    for m in POW2[:6]:
        nt, r0 = m // RADIX, radices(m)[0]
        banks = Banks(16)
        t = np.arange(nt)
        banks.access(pad(t * r0))
        worst[m] = banks.worst
    assert worst == {256: 1, 512: 2, 1024: 2, 2048: 2, 4096: 1, 8192: 2}


@pytest.mark.parametrize("m,in_regs,worst", [
    (384, True, 4), (1280, True, 5), (1408, True, 2), (2176, True, 2),
    (10240, False, 5), (12288, False, 3), (16256, True, 2),
    (16368, False, 4), (16384, True, 1)])
def test_mixed_plan_and_shared_memory_banks(m, in_regs, worst):
    """The mixed kernel's block of m points (a multiple of 16): the odd
    primes, then a power-of-two pass of radix 2..16, then radix-16 passes,
    the last one radix 16; m/16 threads (not always whole warps).  Bank
    conflicts, which cost time and not correctness: a butterfly pass stores
    its outputs at stride p (up to p-way at p = 5, staged or not), a large
    prime's tiles up to 4-way (16368's radix-31 pass, in place), the
    power-of-two passes after an odd part 2-way; none without one."""
    plan = mixed_plan(m)
    assert int(np.prod(plan)) == m and plan[-1] == RADIX
    assert all(p % 2 for p in plan[:len(odd_primes(odd_part(m)))])
    banks = Banks()
    mixed_block_fft(np.zeros((1, m), np.complex64), m, m,
                    np.ones(m, np.complex64), banks, in_regs=in_regs)
    assert banks.worst == worst


def test_cluster_split_covers_every_bin_once():
    """The c thread blocks of a window write the bins c*k + q, k < n/c:
    every bin once, with n/c <= 16384, a multiple of 16 where n is a
    multiple of 128; up to 131072 c is a power of two: n/8192 <= 16 blocks
    that read device memory at the powers of two, else <= 8 (a cluster: c
    <= 8, the portable cluster size) where one divides n, else any divisor
    (the scratch route).  The kernel's output index is the fftshift (bin +
    n/2) mod n, which is ``& (n - 1)`` only for powers of two."""
    for n in POW2 + MIXED + LANE + [128 * 2039, 1 << 20]:
        c, via_scratch = block_split(n)
        m = n // c
        assert c * m == n and m <= BLOCK_N
        assert m % RADIX == 0 or n % 128
        if not via_scratch:
            assert n <= CLUSTER_MAX_N and c & (c - 1) == 0
            assert c <= (16 if runs_pow2(n) else 8)
        bins = np.concatenate([c * np.arange(m) + q for q in range(c)])
        assert np.array_equal(np.sort(bins), np.arange(n))
        shifted = (bins + n // 2) % n
        assert np.array_equal(np.sort(shifted), np.arange(n))
        if n & (n - 1) == 0:
            assert np.array_equal(shifted, (bins + n // 2) & (n - 1))


def test_pow2_split_rule_matches_the_wrapper():
    """``cuda_curscan.fft_plan`` is the model's rule at every power of two
    256-131072, in both builds: the float64 form (one block up to 8192,
    2, 4, 8 and 16 blocks above), the parent form in its own build (one
    block up to 16384, clusters of 2, 4 and 8 above), never through the
    scratch; the parent's build plans every other size as production
    does.  The first pass's radix is the model's."""
    for n in POW2:
        for parent in (False, True):
            c, float64 = pow2_split(n, parent)
            assert cuda_curscan.fft_plan(n, parent) == (c, False)
            assert c <= (8 if parent else 16)
            assert n // c <= (F64_BLOCK_N if float64 else BLOCK_N)
            assert cuda_curscan.pass1_radix(n // c) == radices(n // c)[0]
    assert [pow2_split(n)[0] for n in POW2] == [1] * 6 + [2, 4, 8, 16]
    assert [pow2_split(n, True)[0] for n in POW2] == [1] * 7 + [2, 4, 8]
    for n in (3000, 98304, 262144):
        assert cuda_curscan.fft_plan(n, True) == cuda_curscan.fft_plan(n) \
            == block_split(n)


def test_block_split_rule_matches_the_wrapper():
    """``cuda_curscan.fft_plan`` is the model's rule at every multiple of
    128 up to 262144, at every third fft from 2048 to 40000 and at 2^20;
    the c of the scratch route is the smallest that works (fft 196608: 12, 262144: 16,
    2^20: 64, 128*2039: 2039, 33250 = 2 * odd: 5, 131100: 10), and 39800
    is a cluster of 4."""
    for n in (list(range(128, 262144 + 1, 128))
              + list(range(2048, 40001, 3)) + LANE + [1 << 20]):
        assert cuda_curscan.fft_plan(n) == block_split(n), n
    assert [cluster_size(n) for n in (196608, 262144, 1 << 20, 128 * 2039)] \
        == [12, 16, 64, 2039]
    assert [block_split(n) for n in (33250, 131100, 39800)] == [
        (5, True), (10, True), (4, False)]


@pytest.mark.parametrize("m,in_regs,worst", [
    (2500, True, 6), (3000, True, 6), (9950, False, 6), (6650, True, 5),
    (13110, True, 6), (2 * 509, False, 2), (2 * 3 * 509, True, 4),
    (8 * 3 * 127, True, 4)])
def test_ragged_plan_and_shared_memory_banks(m, in_regs, worst):
    """The ragged plan (16 does not divide m): ceil(m/16) threads, the
    power-of-two part below 16 in one last pass, any odd prime up to 509
    (the largest below fft 262144 the lane predicate takes).  The model's
    block FFT equals ``np.fft`` (the odd primes, then the power-of-two
    pass); bank conflicts cost time and not correctness: up to 6-way."""
    rng = np.random.default_rng(m)
    a = (rng.standard_normal((1, m)) + 1j * rng.standard_normal((1, m)))
    roots = np.exp(-2j * np.pi * np.arange(m) / m).astype(np.complex64)
    banks = Banks()
    y = mixed_block_fft(a.astype(np.complex64), m, m, roots, banks,
                        in_regs=in_regs)
    nt = -(-m // RADIX)
    bins = np.arange(nt)[:, None] + np.arange(RADIX)[None, :] * nt
    got = np.zeros(m, np.complex128)
    got[bins[bins < m]] = y[0][bins < m]
    want = np.fft.fft(a[0].astype(np.complex64).astype(np.complex128))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-6
    assert m % RADIX and banks.worst == worst


def test_pass_tables_of_the_wrapper():
    """``cuda_curscan._pass_roots``: for each odd pass (Ns, p) of the block,
    in the kernel's order, W_{Ns p}^u (u < Ns p) in float64, one after the
    other."""
    for m in (3000, 9950, 16256, 16384, 3 * 5 * 1013):
        tab = cuda_curscan._pass_roots(m, torch.device("cpu")).numpy()
        w = tab[:, 0] + 1j * tab[:, 1]
        assert tab.dtype == np.float64
        primes = odd_primes(odd_part(m))
        assert cuda_curscan.odd_primes(m) == primes
        want, ns = [], 1
        for p in primes:
            want.append(np.exp(-2j * np.pi * np.arange(ns * p) / (ns * p)))
            ns *= p
        want = np.concatenate(want) if want else np.ones(1)
        np.testing.assert_array_equal(w, want)
    # A pass reads W_p^k as its table's entry Ns*k: within 4e-15 of the
    # exact roots up to p = 1013 (the largest prime below 2^20 the lane
    # predicate sends), where the float32 table is 6e-8 off.
    tab = cuda_curscan._pass_roots(3 * 5 * 1013, torch.device("cpu")).numpy()
    w = (tab[:, 0] + 1j * tab[:, 1])[3 + 15:]      # (Ns, p) = (15, 1013)
    k = np.arange(1013)
    assert np.max(np.abs(w[15 * k] - np.exp(-2j * np.pi * k / 1013))) < 4e-15


def test_scratch_chunks_cover_every_iq_block_once():
    """The scratch route fills ``scratch_chunk`` IQ blocks a launch, at
    least one, at most what ``SCRATCH_BYTES`` holds."""
    sc = cuda_curscan.scratch_chunk
    assert sc(64, 262144, 15) == 34
    assert sc(8, 262144, 15) == 8
    assert sc(4, 1 << 20, 11) == 4
    assert sc(100, 1 << 22, 400) == 1
    for t, n, w in ((64, 262144, 15), (7, 196608, 71), (100, 1 << 22, 400)):
        ch = sc(t, n, w)
        assert 1 <= ch <= t
        assert ch == 1 or ch * w * n * 8 <= cuda_curscan.SCRATCH_BYTES
        rows = [r for b0 in range(0, t, ch) for r in range(b0,
                                                           min(t, b0 + ch))]
        assert rows == list(range(t))


def test_window_groups_rule_and_split():
    """G = min(W, ceil(8 * SMs / (T * c))), at least 1; group g takes the
    windows [g*W//G, (g+1)*W//G): contiguous, in order, none empty."""
    wg = cuda_curscan.window_groups
    assert cuda_curscan.groups_for(288, 2, 71, 132) == 2  # fmScan, c = 2
    assert cuda_curscan.groups_for(64, 8, 15, 132) == 3   # fft 65536
    assert wg(4096, 2048, 15, 132) == 1          # zero-span main
    assert wg(288, 16384, 71, 132) == 2          # fmScan, 16 sweeps
    assert wg(288, 16384, 15, 132) == 2          # K3's cell
    assert wg(18, 16384, 71, 132) == 30          # fmScan, one sweep
    assert wg(64, 131072, 15, 132) == 2          # fft 131072, c = 16
    assert wg(288, 20480, 15, 132) == 2          # the mixed kernel, c = 2
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


@pytest.mark.parametrize("fft,nono", [(3000, 0.1), (2500, 0.5),
                                      (39800, 0.5), (33250, 0.5)])
def test_lane_sizes_plain_and_model_match_jax_chain(fft, nono):
    """Sizes the JAX package sends to its lane kernel off the 128 grid (one
    block, a cluster of 4, the scratch route at 2 * odd), MIN folds: the
    port's plain path and the model of the ragged plan against the JAX
    chain."""
    cfg = zs_cfg(fft, nono, "MIN", x_res=500)
    assert cuda_curscan.kernel_route(cfg) == "fft"
    re, im = (decoded(p) for p in raw_planes(cfg, 1, seed=fft + 5))
    want = jax_chain(re, im, cfg)
    got = cuda_curscan.curscan_fused_sublane(torch.from_numpy(re),
                                             torch.from_numpy(im), cfg)
    assert_spectra_close(got.numpy(), want)
    groups = cuda_curscan.window_groups(1, fft, cfg.num_windows, 132)
    assert_spectra_close(curscan_model(re, im, cfg, groups), want)


@pytest.mark.parametrize("nono", [0.5, 0.1])
@pytest.mark.parametrize("mode", ["AVG", "MIN"])
@pytest.mark.parametrize("fft", [1280, 20480, 32768, 65536])
def test_large_fft_plain_and_model_match_jax_chain(fft, mode, nono):
    """fft 1280 (the mixed kernel in one block), 20480 (the mixed kernel in
    a cluster of 2), 32768 and 65536 (the power-of-two kernel's clusters),
    all of which the JAX package sends to its sublane kernel: the port's
    plain path (the wrapper on CPU tensors) and the model against the JAX
    chain."""
    cfg = zs_cfg(fft, nono, mode, x_res=512)
    re, im = (decoded(p) for p in raw_planes(cfg, 1, seed=fft + 3))
    want = jax_chain(re, im, cfg)
    got = cuda_curscan.curscan_fused_sublane(torch.from_numpy(re),
                                             torch.from_numpy(im), cfg)
    assert_spectra_close(got.numpy(), want)
    assert_spectra_close(curscan_model(re, im, cfg, 2), want)
