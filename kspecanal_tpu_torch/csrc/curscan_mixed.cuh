// Fused curscan kernel, mixed-radix FFT form, for NVIDIA Hopper (sm_90a).
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel (:116, the lane
// kernel: fft >= 2048, not prime, window starts multiples of n2 =
// _factorize(fft)[1]; fft 3000, 10000, 39800 = 200 * 199, ...) at every
// size, and ::_kernel_sublane (:423) at its sizes that are not powers of two
// up to 131072 and at every size above 131072.  Same contract, precision
// and fold as curscan_fft.cu, whose entry point kspec_curscan_fft calls
// kspec_fft::launch_mixed_route for these sizes.  The device code and launch
// templates are here; two translation units instantiate them, so that nvcc
// builds them in parallel: curscan_mixed.cu (the route, the clusters and the
// scratch route) and curscan_mixed_planes.cu (one block per window).
//
// Blocks.  N = c * M, M = m * 2^K (m odd) points a thread block, M <= 16384,
// ceil(M/16) threads of 16 points (thread t the points t + e*nt < M; the
// last warp may be partial).
//  * fft <= 16384: c = 1, the block frames the planes (FROM_PLANES).
//  * 16384 < fft <= 131072 where a power of two c <= 8 divides N with
//    N/c <= 16384 (the smallest such): a cluster, the radix-c step through
//    distributed shared memory as in curscan_fft_kernel (FROM_CLUSTER).
//  * every other fft above 16384: c = the smallest divisor of N with N/c <=
//    16384 (a multiple of 16 where 16 divides N).  dif_split writes each
//    window's c twiddled sub-sequences z_q (the cluster's sums, in the same
//    order) to a scratch buffer in device memory; the block kernel reads
//    them and writes bins c*k + q (FROM_SCRATCH).  The wrapper bounds the
//    scratch by splitting the IQ blocks into chunks.
//
// Passes.  Stockham, in this order, each with curscan_fft.cu's formula
// (butterfly j of radix R reads elements j + r*M/R, twiddles element r by
// W_{Ns R}^(r (j mod Ns)), writes output k to (j div Ns)*R*Ns + (j mod Ns) +
// k*Ns):
//  1. One butterfly pass for each odd prime factor p of m, ascending (the
//     plan of cuda_curscan.odd_primes).  The first reads the block input
//     straight from device memory where it lies there (planes or scratch);
//     the cluster's z_q is staged in shared memory first.  A butterfly's
//     twiddles are single lookups in the pass's float64 table (pass_roots,
//     W_{Ns p}^u for u < Ns p, built by the wrapper), and W_p^k is its entry
//     Ns*k; j mod Ns is the one modulo of a butterfly, and no power is
//     formed.  Each DFT-p runs in float64 in the symmetric form: s_r = x_r +
//     x_{p-r}, d_r = x_r - x_{p-r}, X_0 = x_0 + sum s_r, X_k, X_{p-k} = A -/+
//     iB with A = x_0 + sum s_r cos(2 pi rk/p), B = sum d_r sin(2 pi rk/p):
//     (p-1)/2 complex multiply-adds an output in place of p.
//     - p in {3, 5, 7, 11, 13} (small_pass, p at compile time): a thread
//       owns whole butterflies j = t + i*nt, loads the p inputs once into
//       registers and writes the p outputs.
//     - p >= 17 (any prime: 127 at fft 16256, 199 at 39800, up to 1013 below
//       2^20 under the lane predicate, M itself where M is prime): the
//       symmetric DFT-p of all the pass's butterflies as float64 tensor-core
//       products (large_pass_mma, mma.sync m8n8k4: 8 x 8 tiles of outputs k
//       by butterflies j a warp, four r a step, coefficients W_p^(rk) from a
//       p-entry float64 table in shared memory).  Where the pass must write
//       the buffer it reads (no second buffer, below) it holds its outputs
//       in registers instead (large_pass_hold: a thread a group of 4 pairs
//       (k, p-k) of one butterfly, each input read once per group).
//     Each output rounds to float32 once.
//  2. Where 16 divides M (K >= 4): the first power-of-two pass, radix R0 =
//     2^K / 16^Q in {2, 4, 8, 16} (Q = (K-1)/4), Ns = m: 16/R0 butterflies
//     a thread, dft<R0>; then Q radix-16 passes, as in curscan_fft_kernel.
//     The last pass leaves bins t + k*M/16 in thread t's registers, so the
//     fold is curscan_fft_kernel's.
//  3. Where it does not (K < 4; fft 3000 = 2^3 * 375, 2500 = 2^2 * 625, the
//     lane kernel's sizes off the 128 grid), the RAGGED plan: the last
//     thread's points stop at M, one power-of-two pass of radix 2^K in {2,
//     4, 8} (none for an odd M) writes back to the buffer, and the fold
//     reads bins t + e*nt < M from there.
//
// Exchanges.  Each odd pass goes through shared memory.  Where two padded
// buffers fit (PING: every block of up to 512 threads, and blocks of 1024
// threads up to about 11000 points, e.g. fft 10000 and 39800's 9950), the
// odd passes ping-pong between them: a pass stores each output as soon as
// it is computed, and one barrier ends it.  Otherwise (the 11110-, 12288-,
// 13110- and 16368-point blocks of fft 11110, 98304, 131100 and 130944) a
// pass holds its outputs in registers until every thread has read its
// inputs, then stores them in place.  The fftshift is (bin + N/2) mod N.
// Not every access is free of bank conflicts (tests/test_torch_fft_kernel.py
// counts them).
//
// What bounds it on the H100.  chip_smoke.py's bound counts the planes read
// once and 5 N log2 N + 4 N flops a window at the float32 rate: at fft
// 10000, T=4096, 50% it is the bytes, 0.831 ms.  The kernel's time is set by
// float64 issue (64 FMAs a clock an SM, half the float32 rate) and by the
// float <-> double conversions of each pass (16 a clock an SM), not by the
// bytes.  The symmetric butterflies halve a radix-p pass's float64
// multiply-adds; a small p's inputs are read and widened once per butterfly,
// not once per output, with the coefficients in registers.  A large p's
// p^2/2 multiply-adds a butterfly go to the float64 tensor cores (67 TFLOP/s
// against 34 for the float64 units, chip_smoke.py's stage table showed the
// large-prime pass at over 85% of fft 16256's and 39800's time as a vector
// pass), and each input is widened once per 8 outputs.  In blocks of 1024
// threads (64 registers) the passes still spill; ptxas reports it.
// Precision as before: a value rounds to float32 once a pass (twice in the
// radix-8 and radix-16 passes).

#pragma once

#include "curscan_fft.cuh"

namespace {

enum Input { FROM_PLANES = 0, FROM_CLUSTER = 1, FROM_SCRATCH = 2 };
// Profiling cut-offs (cuda_curscan.MIXED_STAGES): 0 runs in full; else the
// kernel stops after the block input, the odd passes or the power-of-two
// passes and folds weights[w] * (re + im) of each point in place of |X|.
enum Stop { STOP_NONE = 0, STOP_INPUT = 1, STOP_ODD = 2, STOP_POW2 = 3 };

constexpr int MAX_ODD_PASSES = 9;     // 3^9 > 16384
constexpr int SMALL_PRIME_MAX = 13;   // larger primes run large_pass
constexpr int HOLD_PAIRS = 4;         // large_pass_hold: pairs an item
constexpr int HOLD_ITEMS = 3;         // and items a thread
constexpr size_t SMEM_LIMIT = 232448; // a Hopper block's shared memory

// Element i of a window's block input: the windowed frame sample s + i
// (FROM_PLANES), or the scratch row's z_q[i] (FROM_SCRATCH).
template <typename T, int INPUT>
__device__ __forceinline__ float2 block_input(const T* xr, const T* xi,
                                              const float* window,
                                              const float2* src, int s,
                                              int i) {
  if constexpr (INPUT == FROM_SCRATCH) {
    return __ldg(src + i);
  } else {
    const float gw = __ldg(window + i);
    return make_float2(sample(xr, s + i) * gw, sample(xi, s + i) * gw);
  }
}

// Where an odd pass reads element i: the block input in device memory (the
// first pass), or the padded shared buffer; widened to float64.
template <typename T, int INPUT>
struct DeviceInput {
  const T* xr;
  const T* xi;
  const float* window;
  const float2* src;
  int s;
  __device__ __forceinline__ double2 operator()(int i) const {
    return widen(block_input<T, INPUT>(xr, xi, window, src, s, i));
  }
};

struct SharedInput {
  const float2* buf;
  __device__ __forceinline__ double2 operator()(int i) const {
    return widen(buf[pad(i)]);
  }
};

// One radix-P pass (P in 3..13, Ns = ns) over the M points: thread t of nt
// owns the butterflies j = t + i*nt < M/P (at most ceil(16/P)).
// Butterfly j loads its P inputs, twiddles input r by tab[r * (j mod Ns)]
// (tab: the pass's table, W_{Ns P}^u), runs the symmetric DFT-P with W_P^k
// = tab[Ns k] and stores output k to dst[(j - j mod Ns)*P + j mod Ns +
// k*Ns].  HOLD (dst is the buffer it reads): the outputs wait in registers
// for a barrier after every thread has read.  Ends behind a barrier.
template <int P, bool HOLD, class Src>
__device__ __forceinline__ void small_pass_body(
    float2* dst, const Src& x, const double2* __restrict__ tab, int t,
    int nt, int m_pts, int ns) {
  constexpr int H = (P - 1) / 2;
  constexpr int NB = (RADIX + P - 1) / P;
  const int len = m_pts / P;
  double2 w[H];        // W_P^k = (cos, -sin)(2 pi k/P), k = 1..H
#pragma unroll
  for (int k = 1; k <= H; ++k) w[k - 1] = __ldg(tab + ns * k);
  float2 y[HOLD ? NB * P : 1];
  int base[HOLD ? NB : 1];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int j = t + i * nt;
    if (j >= len) continue;
    const int a = j % ns;
    const int o = (j - a) * P + a;
    double2 xv[P];
#pragma unroll
    for (int r = 0; r < P; ++r) xv[r] = x(j + r * len);
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < P; ++r) xv[r] = cmul(xv[r], __ldg(tab + r * a));
    }
    double2 sm[H], df[H];
    double2 x0 = xv[0];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      sm[r - 1] = cadd(xv[r], xv[P - r]);
      df[r - 1] = csub(xv[r], xv[P - r]);
      x0 = cadd(x0, sm[r - 1]);
    }
    float2 out[P];
    out[0] = narrow(x0);
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      double2 A = xv[0];
      double2 B = make_double2(0.0, 0.0);   // sum d_r * (-sin)
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const int e = (r * k) % P;
        const double cs = e <= H ? w[e - 1].x : w[P - e - 1].x;
        const double sn = e <= H ? w[e - 1].y : -w[P - e - 1].y;
        A.x = fma(sm[r - 1].x, cs, A.x);
        A.y = fma(sm[r - 1].y, cs, A.y);
        B.x = fma(df[r - 1].x, sn, B.x);
        B.y = fma(df[r - 1].y, sn, B.y);
      }
      out[k] = narrow(make_double2(A.x - B.y, A.y + B.x));
      out[P - k] = narrow(make_double2(A.x + B.y, A.y - B.x));
    }
    if constexpr (HOLD) {
      base[i] = o;
#pragma unroll
      for (int k = 0; k < P; ++k) y[i * P + k] = out[k];
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k) dst[pad(o + k * ns)] = out[k];
    }
  }
  if constexpr (HOLD) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (t + i * nt >= len) continue;
#pragma unroll
      for (int k = 0; k < P; ++k) dst[pad(base[i] + k * ns)] = y[i * P + k];
    }
  }
  __syncthreads();
}

// The in-place form, not inlined: its held outputs add no registers, and no
// spills, to the rest of the kernel.
template <int P, class Src>
__device__ __noinline__ void small_pass_hold(float2* buf, Src x,
                                            const double2* __restrict__ tab,
                                            int t, int nt, int m_pts,
                                            int ns) {
  small_pass_body<P, true>(buf, x, tab, t, nt, m_pts, ns);
}

template <int P, bool HOLD, class Src>
__device__ __forceinline__ void small_pass(float2* dst, const Src& x,
                                           const double2* __restrict__ tab,
                                           int t, int nt, int m_pts,
                                           int ns) {
  if constexpr (HOLD)
    small_pass_hold<P>(dst, x, tab, t, nt, m_pts, ns);
  else
    small_pass_body<P, false>(dst, x, tab, t, nt, m_pts, ns);
}

// D += A * B for one m8n8k4 float64 tile held by a whole warp (mma.sync:
// A row lane/4, column lane%4; B row lane%4, column lane/4; C and D row
// lane/4, columns 2*(lane%4) and 2*(lane%4) + 1).
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// One radix-p pass, p >= 17 (runtime), Ns = ns, as float64 tensor-core
// products, where dst is not the buffer it reads.  The symmetric DFT-p of
// the len = M/p butterflies is four real products of (H+1) x H coefficient
// matrices, cos and -sin of 2 pi kr/p (k = 0..H, r = 1..H), with H x len
// matrices, re and im of s_r = x_r + x_{p-r} and of d_r = x_r - x_{p-r}: A_k
// = x_0 + sum s_r cos, B_k = sum d_r (-sin), X_k = A_k - i B_k... as in
// small_pass; row k = 0 gives X_0.  A whole warp (mma.sync needs all 32
// lanes; a partial last warp idles) takes an 8 x 8 tile of (k, butterfly)
// at a time, k the fast index so that the warps of one butterfly tile run
// together, and steps over r four at a time: each lane forms s_r, d_r of
// one (r, j) (two loads, its twiddles, four widenings: once per 8 outputs
// k) and its coefficient W_p^(kr) from the p-entry table, then four
// mma.sync m8n8k4 f64.  Outputs go to dst as in small_pass, rounded once.
// Ends behind a barrier.
template <class Src>
__device__ __noinline__ void large_pass_mma(float2* dst, Src x,
                                           const double2* __restrict__ tab,
                                           const double2* coef, int cstride,
                                           int t, int nt, int m_pts, int p,
                                           int ns) {
  const int h = (p - 1) / 2;
  const int len = m_pts / p;
  const int kt_n = h / 8 + 1;              // rows k = 0..h
  const int tiles = kt_n * ((len + 7) / 8);
  const int steps = (h + 3) / 4;           // r = 1..h, four a step
  const int gid = (t & 31) >> 2, tig = t & 3;
  const int warps = nt >> 5;
  for (int u = t >> 5; (t >> 5) < warps && u < tiles; u += warps) {
    const int kt = u % kt_n, jt = u / kt_n;
    const int jb = jt * 8 + gid;           // this lane's column of B
    const bool jok = jb < len;
    const int ab = jok ? jb % ns : 0;
    const int k = kt * 8 + gid;            // this lane's row of A, C, D
    double are[2], aim[2], bre[2] = {0.0, 0.0}, bim[2] = {0.0, 0.0};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = jt * 8 + 2 * tig + i;
      const double2 x0 = j < len ? x(j) : make_double2(0.0, 0.0);
      are[i] = x0.x;
      aim[i] = x0.y;
    }
    int idx = (k * (tig + 1)) % p;         // k r mod p
    const int step = (4 * k) % p;
    for (int rs = 0; rs < steps; ++rs) {
      const int r = rs * 4 + tig + 1;
      double2 s = make_double2(0.0, 0.0), d = s;
      if (jok && r <= h) {
        double2 u0 = x(jb + r * len), u1 = x(jb + (p - r) * len);
        if (ns > 1) {
          u0 = cmul(u0, __ldg(tab + r * ab));
          u1 = cmul(u1, __ldg(tab + (p - r) * ab));
        }
        s = cadd(u0, u1);
        d = csub(u0, u1);
      }
      const double2 w = coef[idx * cstride];
      idx += step;
      if (idx >= p) idx -= p;
      mma_f64(are[0], are[1], w.x, s.x);
      mma_f64(aim[0], aim[1], w.x, s.y);
      mma_f64(bre[0], bre[1], w.y, d.x);
      mma_f64(bim[0], bim[1], w.y, d.y);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = jt * 8 + 2 * tig + i;
      if (k > h || j >= len) continue;
      const int a = j % ns;
      const int o = (j - a) * p + a;
      if (k == 0) {
        dst[pad(o)] = narrow(make_double2(are[i], aim[i]));
      } else {
        dst[pad(o + k * ns)] =
            narrow(make_double2(are[i] - bim[i], aim[i] + bre[i]));
        dst[pad(o + (p - k) * ns)] =
            narrow(make_double2(are[i] + bim[i], aim[i] - bre[i]));
      }
    }
  }
  __syncthreads();
}

// One (group, butterfly) item of a radix-p pass, p >= 17, for large_pass:
// butterfly j (a = j mod Ns), the G pairs k = k0 + i, p - k, and X_0.
// coef[e * cstride] = W_p^e.  out[2i] = X_k, out[2i+1] = X_{p-k}, out[2G] =
// X_0, each rounded once (pairs past H = (p-1)/2 are computed and not
// stored).
template <int G, class Src>
__device__ __forceinline__ void large_item(float2 (&out)[2 * G + 1],
                                           const Src& x,
                                           const double2* __restrict__ tab,
                                           const double2* coef, int cstride,
                                           int j, int a, int k0, int len,
                                           int p, int ns) {
  const int h = (p - 1) / 2;
  const double2 xj = x(j);
  double2 A[G], B[G];
  int idx[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    A[i] = xj;
    B[i] = make_double2(0.0, 0.0);
    idx[i] = 0;
  }
  double2 x0 = xj;
  int ra = 0;
  const int pa = p * a;
  for (int r = 1; r <= h; ++r) {
    double2 u = x(j + r * len), v = x(j + (p - r) * len);
    if (ns > 1) {
      ra += a;
      u = cmul(u, __ldg(tab + ra));
      v = cmul(v, __ldg(tab + pa - ra));
    }
    const double2 s = cadd(u, v), d = csub(u, v);
    x0 = cadd(x0, s);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      idx[i] += k0 + i;                   // r * k mod p
      if (idx[i] >= p) idx[i] -= p;
      const double2 w = coef[idx[i] * cstride];
      A[i].x = fma(s.x, w.x, A[i].x);
      A[i].y = fma(s.y, w.x, A[i].y);
      B[i].x = fma(d.x, w.y, B[i].x);
      B[i].y = fma(d.y, w.y, B[i].y);
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    out[2 * i] = narrow(make_double2(A[i].x - B[i].y, A[i].y + B[i].x));
    out[2 * i + 1] = narrow(make_double2(A[i].x + B[i].y, A[i].y - B[i].x));
  }
  out[2 * G] = narrow(x0);
}

// One radix-p pass, p >= 17, that may write the buffer it reads (the
// exchange without a second buffer): len = M/p butterflies of ceil(H/G)
// groups of G = HOLD_PAIRS pairs, item it = g*len + j, thread t of nt the
// items t + e*nt (at most HOLD_ITEMS = 3 at any p >= 17 and M).  The outputs
// wait in registers until every thread has read, then go to buf as in
// small_pass.  Not inlined.  Ends behind a barrier.
template <class Src>
__device__ __noinline__ void large_pass_hold(float2* buf, Src x,
                                            const double2* __restrict__ tab,
                                            const double2* coef, int cstride,
                                            int t, int nt, int m_pts, int p,
                                            int ns) {
  constexpr int G = HOLD_PAIRS;
  constexpr int E = HOLD_ITEMS;
  const int h = (p - 1) / 2;
  const int len = m_pts / p;
  const int items = len * ((h + G - 1) / G);
  float2 y[E][2 * G + 1];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int it = t + e * nt;
    if (it >= items) continue;
    const int g = it / len;
    const int j = it - g * len;
    large_item<G>(y[e], x, tab, coef, cstride, j, j % ns, 1 + g * G, len, p,
                  ns);
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int it = t + e * nt;
    if (it >= items) continue;
    const int g = it / len;
    const int j = it - g * len;
    const int a = j % ns;
    const int o = (j - a) * p + a;
    const int k0 = 1 + g * G;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int k = k0 + i;
      if (k <= h) {
        buf[pad(o + k * ns)] = y[e][2 * i];
        buf[pad(o + (p - k) * ns)] = y[e][2 * i + 1];
      }
    }
    if (k0 == 1) buf[pad(o)] = y[e][2 * G];
  }
  __syncthreads();
}

// One odd pass of radix p from x into dst (small_pass; large_pass_mma, or
// large_pass_hold where dst is the buffer it reads or the block has no
// whole warp).  LARGE: the plan has a prime above 13; without one the
// kernel holds no call of the large passes (whose calls cost the rest of
// the kernel registers and stack).
template <bool HOLD, bool LARGE, class Src>
__device__ __forceinline__ void odd_pass(float2* dst, const Src& x,
                                         const double2* __restrict__ tab,
                                         const double2* coef, int cstride,
                                         int t, int nt, int m_pts, int p,
                                         int ns) {
  switch (p) {
    case 3: small_pass<3, HOLD>(dst, x, tab, t, nt, m_pts, ns); break;
    case 5: small_pass<5, HOLD>(dst, x, tab, t, nt, m_pts, ns); break;
    case 7: small_pass<7, HOLD>(dst, x, tab, t, nt, m_pts, ns); break;
    case 11: small_pass<11, HOLD>(dst, x, tab, t, nt, m_pts, ns); break;
    case 13: small_pass<13, HOLD>(dst, x, tab, t, nt, m_pts, ns); break;
    default:   // a block of fewer than 32 threads has no whole warp
      if constexpr (LARGE) {
        if (HOLD || nt < 32)
          large_pass_hold(dst, x, tab, coef, cstride, t, nt, m_pts, p, ns);
        else
          large_pass_mma(dst, x, tab, coef, cstride, t, nt, m_pts, p, ns);
      }
  }
}

// The RAGGED plan's power-of-two pass, radix R0 = M/ns (ns = m, the odd
// part), the last pass: butterfly j = t + i*nt (i < 16/R0, j < m) reads and
// writes the elements j + r*m, which no other butterfly touches, so it
// needs no barrier between its loads and its stores.
template <int R0>
__device__ __forceinline__ void pow2_pass_ragged(
    float2* buf, const float2* __restrict__ roots, int t, int nt, int n,
    int ns) {
#pragma unroll
  for (int i = 0; i < RADIX / R0; ++i) {
    const int j = t + i * nt;
    if (j < ns) {
      float2 x[R0];
#pragma unroll
      for (int r = 0; r < R0; ++r) x[r] = buf[pad(j + r * ns)];
      dft<R0>(x, roots, j * (n / (ns * R0)));
#pragma unroll
      for (int k = 0; k < R0; ++k) buf[pad(j + k * ns)] = x[k];
    }
  }
}

// The first power-of-two pass, radix R0, Ns = ns (the odd part m):
// butterfly j = t + i*nt (i < 16/R0) on elements j + r*M/R0.  When it is the
// last pass (R0 = 16, one butterfly) its outputs, bins t + k*nt, stay in v;
// else they go to buf.
template <int R0>
__device__ __forceinline__ void pow2_first_pass(
    float2 (&v)[RADIX], float2* buf, const float2* __restrict__ roots, int t,
    int nt, int m_pts, int n, int ns, bool last) {
  constexpr int NB = RADIX / R0;
  float2 y[RADIX];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int j = t + i * nt;
    float2 x[R0];
#pragma unroll
    for (int r = 0; r < R0; ++r) x[r] = buf[pad(j + r * (m_pts / R0))];
    dft<R0>(x, roots, (j % ns) * (n / (ns * R0)));
#pragma unroll
    for (int k = 0; k < R0; ++k) y[i * R0 + k] = x[k];
  }
  if (last) {
#pragma unroll
    for (int k = 0; k < RADIX; ++k) v[k] = y[k];
    return;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int j = t + i * nt;
    const int jm = j % ns;
#pragma unroll
    for (int k = 0; k < R0; ++k)
      buf[pad((j - jm) * R0 + jm + k * ns)] = y[i * R0 + k];
  }
}

// The odd prime factors of m, ascending with multiplicity (the plan of
// cuda_curscan.odd_primes), into primes; returns their count.  On the host,
// large_coef_entries sums the large ones.
__host__ __device__ inline int odd_plan(int m, int* primes) {
  int np = 0;
  for (int p = 3; m > 1; p += 2) {
    if (p * p > m) p = m;
    while (m % p == 0) {
      primes[np++] = p;
      m /= p;
    }
  }
  return np;
}

inline int large_coef_entries(int m_pts) {
  while (!(m_pts & 1)) m_pts >>= 1;
  int primes[MAX_ODD_PASSES];
  const int np = odd_plan(m_pts, primes);
  int entries = 0;
  for (int i = 0; i < np; ++i)
    if (primes[i] > SMALL_PRIME_MAX) entries += primes[i];
  return entries;
}

// Shared memory of a block of M points: the large passes' coefficient
// tables (coef_n double2, first for alignment), the padded buffer (twice
// with PING), and the fold of 1024 threads.
inline size_t mixed_smem(int m_pts, int coef_n, bool ping,
                         bool fold_in_smem) {
  return static_cast<size_t>(coef_n) * sizeof(double2) +
         static_cast<size_t>(ping ? 2 : 1) * (m_pts + m_pts / 16) *
             sizeof(float2) +
         (fold_in_smem ? static_cast<size_t>(m_pts) * sizeof(float) : 0);
}

// The large passes' coefficient table of the pass at hand: its p entries in
// shared memory where the kernel staged them (coef_n > 0), else its own
// table in device memory at stride Ns.
struct CoefTables {
  const double2* smem;
  int staged;    // coef_n
  int off;       // entries of the large passes before this one
  __device__ __forceinline__ const double2* take(const double2* tab, int p,
                                                 int ns, int& cstride) {
    const double2* cp = tab;
    cstride = ns;
    if (p > SMALL_PRIME_MAX) {
      if (staged) {
        cp = smem + off;
        cstride = 1;
      }
      off += p;
    }
    return cp;
  }
};

template <typename T, int NTMAX, int INPUT, bool RAGGED, bool PING,
          bool LARGE>
__global__ void __launch_bounds__(NTMAX)
curscan_mixed_kernel(const T* __restrict__ re, const T* __restrict__ im,
                     const float2* __restrict__ scratch,
                     float* __restrict__ out, const int* __restrict__ starts,
                     const float* __restrict__ weights,
                     const float* __restrict__ window,
                     const float2* __restrict__ roots,
                     const double2* __restrict__ pass_roots, int full_size,
                     int n_windows, int groups, int fold, int n, int c,
                     int coef_n, int stop) {
  const int M = n / c;                     // points of this block's FFT
  const int nt = (M + RADIX - 1) / RADIX;  // threads
  int m = M;                               // its odd part
  while (!(m & 1)) m >>= 1;
  const int log2p = __ffs(M / m) - 1;      // K: >= 4 unless RAGGED
  const int Q = RAGGED ? 0 : (log2p - 1) / 4;   // radix-16 passes
  const int R0 = (M / m) >> (4 * Q);       // radix of the first pow2 pass
  int primes[MAX_ODD_PASSES];
  const int np = odd_plan(m, primes);
  // At more than 512 threads (64 registers each) the fold lives in shared
  // memory, after the exchange buffers: fold[k * nt + t].
  constexpr bool FOLD_IN_SMEM = NTMAX == 1024;
  // [coef_n double2] pad(M) float2 [pad(M) float2: PING] [M float: fold]
  extern __shared__ double2 smem[];
  float2* buf = reinterpret_cast<float2*>(smem + coef_n);
  float2* buf2 = PING ? buf + M + M / 16 : buf;
  float* fold_s = reinterpret_cast<float*>(buf2 + M + M / 16);
  const int t = threadIdx.x;
  if (coef_n) {   // W_p^e = entry Ns*e of each large pass's table
    const double2* tab = pass_roots;
    for (int i = 0, off = 0, ns = 1; i < np; ++i) {
      const int p = primes[i];
      if (p > SMALL_PRIME_MAX) {
        for (int e = t; e < p; e += nt) smem[off + e] = __ldg(tab + ns * e);
        off += p;
      }
      tab += ns * p;
      ns *= p;
    }             // read after the window loop's first barrier
  }

  int q = 0;                               // this block's sub-sequence
  if constexpr (INPUT == FROM_CLUSTER)
    q = static_cast<int>(cg::this_cluster().block_rank());
  if constexpr (INPUT == FROM_SCRATCH) q = blockIdx.x % c;
  const int cb = blockIdx.x / c;           // (IQ block, window group)
  const int b = cb / groups;
  const int g = cb - b * groups;
  const int w_lo = (g * n_windows) / groups;
  const int w_hi = ((g + 1) * n_windows) / groups;
  const T* xr = nullptr;
  const T* xi = nullptr;
  if constexpr (INPUT != FROM_SCRATCH) {
    xr = re + static_cast<size_t>(b) * full_size;
    xi = im + static_cast<size_t>(b) * full_size;
  }

  float acc[RADIX];   // unused when FOLD_IN_SMEM
  const float init = fold == FOLD_MAX ? -CUDART_INF_F
                   : fold == FOLD_MIN ? CUDART_INF_F : 0.0f;
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    if (RAGGED && t + k * nt >= M) continue;   // no bin of this thread
    if constexpr (FOLD_IN_SMEM)
      fold_s[k * nt + t] = init;
    else
      acc[k] = init;
  }

  for (int w = w_lo; w < w_hi; ++w) {
    const int s = starts[w];
    const float wt = weights[w];
    __syncthreads();     // the previous window's last pass has read buf
    const float2* src = nullptr;
    if constexpr (INPUT == FROM_SCRATCH)
      src = scratch + (static_cast<size_t>(b) * n_windows + w) * n +
            static_cast<size_t>(q) * M;
    const DeviceInput<T, INPUT> dev{xr, xi, window, src, s};
    CoefTables coef{smem, coef_n, 0};
    const double2* tab = pass_roots;   // the odd passes' tables, in order
    float2* cur = buf;   // the buffer that holds the last pass's outputs
    int ns = 1;          // points combined before the next pass
    int i0 = 0;          // odd passes done
    if constexpr (INPUT == FROM_CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
      for (int e = 0; e < RADIX; ++e) {
        const int mm = t + e * nt;
        if (RAGGED && mm >= M) continue;
        const int i = q * M + mm;
        const float gw = __ldg(window + i);
        buf[pad(mm)] = make_float2(sample(xr, s + i) * gw,
                                   sample(xi, s + i) * gw);
      }
      cluster.sync();    // every chunk is in its block's shared memory
      float2 z[RADIX];
#pragma unroll
      for (int e = 0; e < RADIX; ++e) {
        const int mm = t + e * nt;
        if (RAGGED && mm >= M) continue;
        double2 d = widen(cluster.map_shared_rank(buf, 0)[pad(mm)]);
        for (int j = 1; j < c; ++j)   // W_c^(jq); c is a power of two
          d = cadd(d, cmul(widen(cluster.map_shared_rank(buf, j)[pad(mm)]),
                           widen(__ldg(roots + ((j * q) & (c - 1)) * M))));
        z[e] = narrow(q ? cmul(d, widen(__ldg(roots + mm * q))) : d);
      }
      cluster.sync();    // no block reads a chunk any more
#pragma unroll
      for (int e = 0; e < RADIX; ++e)
        if (!RAGGED || t + e * nt < M) buf[pad(t + e * nt)] = z[e];
      __syncthreads();
    } else if (np > 0 && stop != STOP_INPUT) {
      // The first odd pass reads the block input in device memory.
      int cs;
      const double2* cp = coef.take(tab, primes[0], 1, cs);
      odd_pass<false, LARGE>(buf, dev, tab, cp, cs, t, nt, M, primes[0], 1);
      tab += primes[0];
      ns = primes[0];
      i0 = 1;
    } else {
#pragma unroll
      for (int e = 0; e < RADIX; ++e)
        if (!RAGGED || t + e * nt < M)
          buf[pad(t + e * nt)] = narrow(dev(t + e * nt));
      __syncthreads();
    }

    for (int i = i0; stop != STOP_INPUT && i < np; ++i) {
      const int p = primes[i];
      int cs;
      const double2* cp = coef.take(tab, p, ns, cs);
      float2* nxt = PING ? (cur == buf ? buf2 : buf) : cur;
      odd_pass<!PING, LARGE>(nxt, SharedInput{cur}, tab, cp, cs, t, nt, M, p,
                             ns);
      cur = nxt;
      tab += ns * p;
      ns *= p;
    }

    // v[k] = bin t + k*nt of this block's M-point FFT (cut off: the value
    // at that position after the stage).
    float2 v[RADIX];
    if (stop == STOP_INPUT || stop == STOP_ODD) {
#pragma unroll
      for (int e = 0; e < RADIX; ++e)
        if (!RAGGED || t + e * nt < M) v[e] = cur[pad(t + e * nt)];
    } else if constexpr (RAGGED) {
      switch (R0) {
        case 2: pow2_pass_ragged<2>(cur, roots, t, nt, n, ns); break;
        case 4: pow2_pass_ragged<4>(cur, roots, t, nt, n, ns); break;
        case 8: pow2_pass_ragged<8>(cur, roots, t, nt, n, ns); break;
        default: break;                        // odd M: no pow2 pass
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < RADIX; ++e)
        if (t + e * nt < M) v[e] = cur[pad(t + e * nt)];
    } else {
      const bool last = Q == 0;
      switch (R0) {
        case 2:
          pow2_first_pass<2>(v, cur, roots, t, nt, M, n, ns, last);
          break;
        case 4:
          pow2_first_pass<4>(v, cur, roots, t, nt, M, n, ns, last);
          break;
        case 8:
          pow2_first_pass<8>(v, cur, roots, t, nt, M, n, ns, last);
          break;
        default:
          pow2_first_pass<16>(v, cur, roots, t, nt, M, n, ns, last);
      }
      ns *= R0;
#pragma unroll 1
      for (int p = 0; p < Q; ++p) {
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RADIX; ++r) v[r] = cur[pad(t + r * nt)];
        const int tw = t % ns;                 // j mod Ns
        dft<RADIX>(v, roots, tw * (n / (ns * RADIX)));
        if (p < Q - 1) {
          __syncthreads();
#pragma unroll
          for (int k = 0; k < RADIX; ++k)
            cur[pad((t - tw) * RADIX + tw + k * ns)] = v[k];
        }
        ns *= RADIX;
      }
    }

#pragma unroll
    for (int k = 0; k < RADIX; ++k) {
      if (RAGGED && t + k * nt >= M) continue;
      const float mag = stop ? wt * (v[k].x + v[k].y)
                             : wt * sqrtf(v[k].x * v[k].x + v[k].y * v[k].y);
      if constexpr (FOLD_IN_SMEM)
        fold_s[k * nt + t] = fold_in(fold_s[k * nt + t], mag, fold);
      else
        acc[k] = fold_in(acc[k], mag, fold);
    }
  }

  // Bin c*(t + k*nt) + q of the N-point FFT, fftshifted: (bin + N/2) mod N.
  float* o = out + static_cast<size_t>(cb) * n;
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    if (RAGGED && t + k * nt >= M) continue;
    int i = c * (t + k * nt) + q + n / 2;
    if (i >= n) i -= n;
    if constexpr (FOLD_IN_SMEM)
      o[i] = fold_s[k * nt + t];
    else
      o[i] = acc[k];
  }
}

// The radix-c step of the FROM_SCRATCH route for `rows` IQ blocks:
// scratch[b][w][q][i] = W_N^(i q) * sum_j a_w[i + M j] W_c^(j q) (a_w the
// windowed frame of window w), float64 sums rounded once, as the cluster
// forms z_q.  One thread an output, consecutive threads consecutive i.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
dif_split(const T* __restrict__ re, const T* __restrict__ im,
          float2* __restrict__ scratch, const int* __restrict__ starts,
          const float* __restrict__ window, const float2* __restrict__ roots,
          int full_size, int n_windows, int n, int c, size_t total) {
  const int M = n / c;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * COMBINE_THREADS +
                    threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * COMBINE_THREADS) {
    const int i = static_cast<int>(idx % M);
    size_t rest = idx / M;
    const int q = static_cast<int>(rest % c);
    rest /= c;
    const int w = static_cast<int>(rest % n_windows);
    const size_t b = rest / n_windows;
    const T* xr = re + b * full_size;
    const T* xi = im + b * full_size;
    const int s = starts[w];
    double2 z = make_double2(0.0, 0.0);
    for (int j = 0; j < c; ++j) {
      const int e = i + j * M;
      const float gw = __ldg(window + e);
      const double2 a = widen(make_float2(sample(xr, s + e) * gw,
                                          sample(xi, s + e) * gw));
      z = j ? cadd(z, cmul(a, widen(__ldg(
                  roots + static_cast<size_t>(
                      (static_cast<long long>(j) * q) % c) * M))))
            : a;
    }
    scratch[idx] = narrow(
        q ? cmul(z, widen(__ldg(roots + static_cast<size_t>(i) * q))) : z);
  }
}

template <typename T, int NTMAX, int INPUT, bool RAGGED, bool PING>
int launch_mixed_nt(const void* re, const void* im, const void* scratch,
                    float* dst, const void* starts, const void* weights,
                    const void* window, const void* roots,
                    const void* pass_roots, int rows, int full_size, int n,
                    int c, int n_windows, int groups, int fold, int stop,
                    cudaStream_t stream) {
  const int m_pts = n / c;
  int coef_n = large_coef_entries(m_pts);
  if (mixed_smem(m_pts, coef_n, PING, NTMAX == 1024) > SMEM_LIMIT)
    coef_n = 0;                        // the tables stay in device memory
  const size_t smem = mixed_smem(m_pts, coef_n, PING, NTMAX == 1024);
  auto kernel = large_coef_entries(m_pts)
                    ? curscan_mixed_kernel<T, NTMAX, INPUT, RAGGED, PING, true>
                    : curscan_mixed_kernel<T, NTMAX, INPUT, RAGGED, PING,
                                           false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows) * groups * c);
  config.blockDim = dim3((m_pts + RADIX - 1) / RADIX);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (INPUT == FROM_CLUSTER) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(re), static_cast<const T*>(im),
      static_cast<const float2*>(scratch), dst,
      static_cast<const int*>(starts), static_cast<const float*>(weights),
      static_cast<const float*>(window), static_cast<const float2*>(roots),
      static_cast<const double2*>(pass_roots), full_size, n_windows, groups,
      fold, n, c, coef_n, stop);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation per thread-count class and plan: up to 512 threads
// (held to 128 registers, so at least 512 threads of a small block size
// share an SM; two exchange buffers always fit), up to 1024 (64, fold in
// shared memory; PING where two buffers fit beside it, else the odd passes
// hold their outputs); RAGGED where 16 does not divide the block's M
// points.  A cluster's blocks always hold more than 8192 points (c is the
// smallest power of two with N/c <= 16384), so FROM_CLUSTER needs only the
// second class.
template <typename T, int INPUT>
int launch_mixed(const void* re, const void* im, const void* scratch,
                 float* dst, const void* starts, const void* weights,
                 const void* window, const void* roots,
                 const void* pass_roots, int rows, int full_size, int n,
                 int c, int n_windows, int groups, int fold, int stop,
                 cudaStream_t stream) {
#define KSPEC_MIXED_CASE(NTMAX, RAGGED, PING)                               \
  return launch_mixed_nt<T, NTMAX, INPUT, RAGGED, PING>(                    \
      re, im, scratch, dst, starts, weights, window, roots, pass_roots,     \
      rows, full_size, n, c, n_windows, groups, fold, stop, stream)
  const int m_pts = n / c;
  const int nt = (m_pts + RADIX - 1) / RADIX;
  const bool ragged = m_pts % RADIX != 0;
  if constexpr (INPUT != FROM_CLUSTER) {
    if (nt <= 512) {
      if (ragged) KSPEC_MIXED_CASE(512, true, true);
      KSPEC_MIXED_CASE(512, false, true);
    }
  } else {
    if (nt <= 512) return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool ping =
      mixed_smem(m_pts, large_coef_entries(m_pts), true, true) <= SMEM_LIMIT;
  if (ragged) {
    if (ping) KSPEC_MIXED_CASE(1024, true, true);
    KSPEC_MIXED_CASE(1024, true, false);
  }
  if (ping) KSPEC_MIXED_CASE(1024, false, true);
  KSPEC_MIXED_CASE(1024, false, false);
#undef KSPEC_MIXED_CASE
}

// The FROM_SCRATCH route, `chunk` IQ blocks at a time: dif_split into the
// scratch (chunk, n_windows, n) float2, then the block kernel.
template <typename T>
int launch_hbm(const void* re, const void* im, void* scratch, float* dst,
               const void* starts, const void* weights, const void* window,
               const void* roots, const void* pass_roots, int t,
               int full_size, int n, int c, int chunk, int n_windows,
               int groups, int fold, int stop, cudaStream_t stream) {
  for (int b0 = 0; b0 < t; b0 += chunk) {
    const int rows = t - b0 < chunk ? t - b0 : chunk;
    const size_t off = static_cast<size_t>(b0) * full_size;
    const size_t total = static_cast<size_t>(rows) * n_windows * n;
    const size_t blocks = (total + COMBINE_THREADS - 1) / COMBINE_THREADS;
    dif_split<T><<<static_cast<unsigned>(blocks < 65536 ? blocks : 65536),
                   COMBINE_THREADS, 0, stream>>>(
        static_cast<const T*>(re) + off, static_cast<const T*>(im) + off,
        static_cast<float2*>(scratch), static_cast<const int*>(starts),
        static_cast<const float*>(window), static_cast<const float2*>(roots),
        full_size, n_windows, n, c, total);
    int err = static_cast<int>(cudaGetLastError());
    if (!err)
      err = launch_mixed<float, FROM_SCRATCH>(
          nullptr, nullptr, scratch,
          dst + static_cast<size_t>(b0) * groups * n, starts, weights, window,
          roots, pass_roots, rows, full_size, n, c, n_windows, groups, fold,
          stop, stream);
    if (err) return err;
  }
  return 0;
}

}  // namespace

namespace kspec_fft {

// The FROM_PLANES launches (c = 1: fft <= 16384, not a power of two), in
// curscan_mixed_planes.cu.
int launch_mixed_planes(const void* re, const void* im, int is_u8, float* dst,
                        const void* starts, const void* weights,
                        const void* window, const void* roots,
                        const void* pass_roots, int t, int full_size, int n,
                        int n_windows, int groups, int fold, int stop,
                        cudaStream_t stream);

}  // namespace kspec_fft
