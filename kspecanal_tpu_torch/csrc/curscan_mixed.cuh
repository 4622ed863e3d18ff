// Fused curscan kernel, mixed-radix FFT form, for NVIDIA Hopper (sm_90a):
// the fft sizes of the JAX package's sublane kernel
// (kspecanal_tpu/ops/pallas_curscan.py::_kernel_sublane, :423) that are
// not powers of two up to 131072, every size above 131072, and every size
// of its lane kernel (::_kernel, :116: fft >= 2048, not prime, window
// starts multiples of n2 = _factorize(fft)[1]; fft 3000, 10000, 39800 =
// 200 * 199, ...).  Same contract, precision and fold as curscan_fft.cu,
// whose entry point kspec_curscan_fft calls kspec_fft::launch_mixed_route
// for these sizes.  The device code and launch templates are here; two
// translation units instantiate them, so that nvcc builds them in parallel:
// curscan_mixed.cu (the route, the clusters and the scratch route) and
// curscan_mixed_planes.cu (one block per window, FROM_PLANES).
//
// N = c * M, M = m * 2^K (m odd) points a thread block, M <= 16384,
// ceil(M/16) threads of 16 points (thread t the points t + e*nt < M; not
// always a multiple of 32 threads: the last warp may be partial).
//  * fft <= 16384: c = 1, the block frames the planes (FROM_PLANES).
//  * 16384 < fft <= 131072 where a power of two c <= 8 divides N with
//    N/c <= 16384 (the smallest such): a cluster, the radix-c step through
//    distributed shared memory as in curscan_fft_kernel (FROM_CLUSTER).
//  * every other fft above 16384 (above 131072, or N = 2 * odd above
//    32768): c = the smallest divisor of N with N/c <= 16384 (a multiple
//    of 16 where 16 divides N).  dif_split writes each window's c twiddled
//    sub-sequences z_q (the cluster's sums, in the same order) to a scratch
//    buffer in device memory; the block kernel reads them and writes bins
//    c*k + q (FROM_SCRATCH).  The wrapper bounds the scratch by splitting
//    the IQ blocks into chunks.
// The Stockham passes run in this order, each with curscan_fft.cu's formula
// (butterfly j of radix R reads elements j + r*M/R, twiddles element r by
// W_{Ns R}^(r (j mod Ns)), writes output k to (j div Ns)*R*Ns + (j mod Ns) +
// k*Ns):
//  1. One pass for each odd prime factor p of m, ascending.
//     - The first, where p <= 7 and the block input lies in device memory
//       (planes or scratch), is odd_first_pass: 16/p butterflies a thread
//       (ragged), each loading its p elements straight into registers, a
//       float64 DFT-p with the table's W_p^j, p stores to the padded shared
//       buffer.
//     - Otherwise the block input is staged in the buffer first (the
//       cluster's z_q, or a larger first prime).  In the plan of 16 points
//       a thread that first pass is odd_first_pass_staged: thread t
//       computes output k = t mod p of 16 butterflies, each a p-term
//       float64 sum of the inputs times W_p^(rk), the p roots copied to
//       shared memory once.
//     - Every other odd pass is odd_pass: thread t computes outputs t +
//       e*nt (every thread holds 16, whatever p is), output k of butterfly
//       j the p-term float64 sum of its inputs times the powers of w =
//       W_{Ns p}^((j mod Ns) + k Ns), the pass twiddle and W_p^(rk) in one
//       power, from the pass's float64 table (pass_roots, built by the
//       wrapper): with Ns = 1 each power is a table entry a warp reads at
//       once, else w is read once an output and its powers are float64
//       products (per point p shared-memory loads and 2p complex float64
//       multiplies, and no gather from the N-point table).
//     All round to float32 once per output.
//  2. Where 16 divides M (K >= 4): the first power-of-two pass, radix R0 =
//     2^K / 16^Q in {2, 4, 8, 16} (Q = (K-1)/4), Ns = m: 16/R0 butterflies
//     a thread, dft<R0>; then Q radix-16 passes, as in curscan_fft_kernel.
//     The last pass leaves bins t + k*M/16 in thread t's registers (with Q
//     = 0, pass 2 is the last: R0 = 16, Ns = M/16), so the fold is
//     curscan_fft_kernel's.
//  3. Where it does not (K < 4; fft 3000 = 2^3 * 375, 2500 = 2^2 * 625, the
//     lane kernel's sizes off the 128 grid), the RAGGED plan: the last
//     thread's points stop at M, one power-of-two pass of radix 2^K in {2,
//     4, 8} (none for an odd M) writes back to the buffer, and the fold
//     reads bins t + e*nt < M from there.
// Any odd prime works; a radix-p pass costs p complex multiply-adds a
// point, 2p with the powers (fft 39800 = 200 * 199: 398).  Indices divide
// by the runtime Ns and p (no power-of-two masks), and the fftshift is (bin
// + N/2) mod N.  Not every access is free of bank conflicts
// (tests/test_torch_fft_kernel.py counts them): odd_first_pass stores at
// stride p (5-way at p = 5), the odd and power-of-two passes after an odd
// part up to 6-way.

#pragma once

#include "curscan_fft.cuh"

namespace {

enum Input { FROM_PLANES = 0, FROM_CLUSTER = 1, FROM_SCRATCH = 2 };

// acc + a*b in four fused multiply-adds.
__device__ __forceinline__ double2 cfma(double2 a, double2 b, double2 acc) {
  acc.x = fma(a.x, b.x, acc.x);
  acc.x = fma(-a.y, b.y, acc.x);
  acc.y = fma(a.x, b.y, acc.y);
  acc.y = fma(a.y, b.x, acc.y);
  return acc;
}

// The first odd pass (Ns = 1) of the plan of 16 points a thread where the
// block input is staged (the cluster's z_q, or a first prime above 7):
// thread t computes output k = t mod p of the 16 butterflies j = t div p +
// e*len/16 (len = M/p, a multiple of 16, so the M/16 threads cover every
// output once), each a p-term float64 sum of elements j + r*len times
// W_p^(rk) = tw_s[r k mod p], the roots table's entries copied to shared
// memory once; the sums of G = 4 outputs share each root.  Once every
// thread has read, output k of butterfly j goes to j*p + k; ends behind a
// barrier.
__device__ __forceinline__ void odd_first_pass_staged(float2* buf,
                                                      const float2* tw_s,
                                                      int t, int m_pts,
                                                      int p) {
  constexpr int G = 4;
  const int len = m_pts / p;
  const int l16 = len / RADIX;
  const int k = t % p, jg = t / p;
  float2 y[RADIX];
#pragma unroll
  for (int e0 = 0; e0 < RADIX; e0 += G) {
    double2 acc[G];
#pragma unroll
    for (int i = 0; i < G; ++i) acc[i] = widen(buf[pad(jg + (e0 + i) * l16)]);
    int idx = 0;
    for (int r = 1; r < p; ++r) {
      idx += k;                                // r*k mod p
      if (idx >= p) idx -= p;
      const double2 w = widen(tw_s[idx]);
#pragma unroll
      for (int i = 0; i < G; ++i)
        acc[i] = cfma(widen(buf[pad(jg + (e0 + i) * l16 + r * len)]), w,
                      acc[i]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) y[e0 + i] = narrow(acc[i]);
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < RADIX; ++e) buf[pad((jg + e * l16) * p + k)] = y[e];
  __syncthreads();
}

// One odd pass of radix p over the M staged points, Ns = ns points combined
// before it, in either plan (but for the pass above): thread t computes the
// outputs o = t + e*nt < M (e < 16), output k = o div len of butterfly j =
// o mod len (len = M/p), so a warp reads consecutive j and, but where o
// crosses a multiple of len, one k.  Output k of butterfly j is the p-term
// float64 sum of elements j + r*len times w^r, w = W_{Ns p}^u, u = (j mod
// Ns) + k Ns (the pass twiddle W_{Ns p}^(r (j mod Ns)) and W_p^(rk) in one
// power), from the pass's float64 table tw (Ns p entries).  With Ns = 1 a
// warp's outputs share u = k, so w^r = tw[r k mod p] is one broadcast
// load; with Ns > 1 they spread over the table (at r*u), so w = tw[u] is
// read once an output (consecutive u at consecutive addresses) and its
// powers follow by multiplication in float64.  The sum rounds to float32
// once.  G outputs run side by side (independent chains; 2 where 1024
// threads leave 64 registers each).  Not inlined: its registers are its
// own, so it adds no spills to the rest of the kernel (the power-of-two
// passes of a cluster's 1024 threads).  A group of G outputs past M is
// skipped, a partial one recomputes output M-1 in its tail and stores
// nothing there.  Once every thread has read, output k of butterfly j goes
// to (j div Ns)*p*Ns + (j mod Ns) + k*Ns; ends behind a barrier.
template <int G>
__device__ __noinline__ void odd_pass(float2* buf,
                                         const double2* __restrict__ tw,
                                         int t, int nt, int m_pts, int p,
                                         int ns) {
  const int len = m_pts / p;
  float2 y[RADIX];
#pragma unroll
  for (int e0 = 0; e0 < RADIX; e0 += G) {
    if (t + e0 * nt >= m_pts) continue;
    int j[G], u[G];
    double2 acc[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      int o = t + (e0 + i) * nt;
      if (o >= m_pts) o = m_pts - 1;
      const int k = o / len;
      j[i] = o - k * len;
      u[i] = j[i] % ns + k * ns;
      acc[i] = widen(buf[pad(j[i])]);
    }
    if (ns == 1) {
      // The first pass: w^r = tw[r*k mod p], one entry a warp reads at
      // once (its outputs share k but where o crosses a multiple of len).
      int idx[G];
#pragma unroll
      for (int i = 0; i < G; ++i) idx[i] = 0;
      for (int r = 1; r < p; ++r) {
#pragma unroll
        for (int i = 0; i < G; ++i) {
          idx[i] += u[i];
          if (idx[i] >= p) idx[i] -= p;
          acc[i] = cfma(widen(buf[pad(j[i] + r * len)]), __ldg(tw + idx[i]),
                        acc[i]);
        }
      }
    } else {
      double2 w[G], c[G];
#pragma unroll
      for (int i = 0; i < G; ++i) c[i] = w[i] = __ldg(tw + u[i]);
      for (int r = 1; r < p; ++r) {
#pragma unroll
        for (int i = 0; i < G; ++i) {
          acc[i] = cfma(widen(buf[pad(j[i] + r * len)]), c[i], acc[i]);
          c[i] = cmul(c[i], w[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) y[e0 + i] = narrow(acc[i]);
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < RADIX; ++e) {
    const int o = t + e * nt;
    if (o < m_pts) {
      const int k = o / len;
      const int j = o - k * len;
      const int a = j % ns;
      buf[pad((j - a) * p + a + k * ns)] = y[e];
    }
  }
  __syncthreads();
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

// The first odd pass (Ns = 1) when its prime P is at most 7 and the block
// input lies in device memory: butterfly j = t + i*nt (while j < M/P) reads
// its elements j + r*M/P from there into registers, and writes output k to
// buf[j*P + k]; nothing it reads is in buf, so it needs no staging and no
// barrier between its loads and its stores.  The DFT in float64, rounded
// once, in the symmetric form: with s_r = x_r + x_{P-r}, d_r = x_r -
// x_{P-r} and roots[j N/P] = (C_j, -S_j), X_0 = x_0 + sum s_r and X_k,
// X_{P-k} = A -/+ iB, A = x_0 + sum s_r C_{rk}, B = sum d_r S_{rk}.
template <int P, typename T, int INPUT>
__device__ __forceinline__ void odd_first_pass(
    float2* buf, const T* xr, const T* xi, const float* window,
    const float2* src, int s, const float2* __restrict__ roots, int t,
    int nt, int m_pts, int n) {
  constexpr int H = (P - 1) / 2;
  const int len = m_pts / P;
  const int stride = n / P;
  for (int j = t; j < len; j += nt) {
    double2 x[P];
#pragma unroll
    for (int r = 0; r < P; ++r)
      x[r] = widen(block_input<T, INPUT>(xr, xi, window, src, s,
                                         j + r * len));
    double2 sm[H], df[H];
    double2 y0 = x[0];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      sm[r - 1] = cadd(x[r], x[P - r]);
      df[r - 1] = csub(x[r], x[P - r]);
      y0 = cadd(y0, sm[r - 1]);
    }
    buf[pad(j * P)] = narrow(y0);
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      double2 a = x[0];
      double2 b = make_double2(0.0, 0.0);
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const float2 w = __ldg(roots + ((r * k) % P) * stride);
        a.x += sm[r - 1].x * w.x;
        a.y += sm[r - 1].y * w.x;
        b.x -= df[r - 1].x * w.y;
        b.y -= df[r - 1].y * w.y;
      }
      buf[pad(j * P + k)] = narrow(make_double2(a.x + b.y, a.y - b.x));
      buf[pad(j * P + P - k)] = narrow(make_double2(a.x - b.y, a.y + b.x));
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

template <typename T, int NTMAX, int INPUT, bool RAGGED>
__global__ void __launch_bounds__(NTMAX)
curscan_mixed_kernel(const T* __restrict__ re, const T* __restrict__ im,
                     const float2* __restrict__ scratch,
                     float* __restrict__ out, const int* __restrict__ starts,
                     const float* __restrict__ weights,
                     const float* __restrict__ window,
                     const float2* __restrict__ roots,
                     const double2* __restrict__ pass_roots, int full_size,
                     int n_windows, int groups, int fold, int n, int c) {
  const int M = n / c;                     // points of this block's FFT
  const int nt = (M + RADIX - 1) / RADIX;  // threads
  int m = M;                               // its odd part
  while (!(m & 1)) m >>= 1;
  const int log2p = __ffs(M / m) - 1;      // K: >= 4 unless RAGGED
  const int Q = RAGGED ? 0 : (log2p - 1) / 4;   // radix-16 passes
  const int R0 = (M / m) >> (4 * Q);       // radix of the first pow2 pass
  int p1 = m;                              // the smallest prime factor of m
  for (int p = 3; p * p <= m; p += 2)
    if (m % p == 0) {
      p1 = p;
      break;
    }
  // The first odd pass reads device memory straight into registers where
  // it can (odd_first_pass); else the block input is staged in buf first,
  // and the first pass of the plan of 16 points a thread reads W_p1^j from
  // tw_s.
  const bool first_in_regs = INPUT != FROM_CLUSTER && m > 1 && p1 <= 7;
  // At more than 512 threads (64 registers each) the fold lives in shared
  // memory, after the exchange buffer: fold[k * nt + t].
  constexpr bool FOLD_IN_SMEM = NTMAX == 1024;
  // pad(M) float2, [M float: the fold,] [p1 float2: W_p1^j, not RAGGED]
  extern __shared__ float2 buf[];
  float* fold_s = reinterpret_cast<float*>(buf + M + M / 16);
  float2* tw_s = reinterpret_cast<float2*>(fold_s + (FOLD_IN_SMEM ? M : 0));
  if (!RAGGED && !first_in_regs)
    for (int j = threadIdx.x; j < (m > 1 ? p1 : 0); j += nt)
      tw_s[j] = __ldg(roots + j * (n / p1));  // read after the loop's barrier

  const int t = threadIdx.x;
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
    int ns = 1;          // points combined before the next pass
    int rem = m;         // odd factors still to pass
    // The odd passes' tables, one after the other (pass_roots).
    const double2* tab = pass_roots;
    if (first_in_regs) {
      const float2* src = nullptr;
      if constexpr (INPUT == FROM_SCRATCH)
        src = scratch + (static_cast<size_t>(b) * n_windows + w) * n +
              static_cast<size_t>(q) * M;
      if constexpr (INPUT != FROM_CLUSTER) {
        if (p1 == 3)
          odd_first_pass<3, T, INPUT>(buf, xr, xi, window, src, s, roots, t,
                                      nt, M, n);
        else if (p1 == 5)
          odd_first_pass<5, T, INPUT>(buf, xr, xi, window, src, s, roots, t,
                                      nt, M, n);
        else
          odd_first_pass<7, T, INPUT>(buf, xr, xi, window, src, s, roots, t,
                                      nt, M, n);
      }
      ns = p1;
      rem = m / p1;
      tab += p1;
    } else if constexpr (INPUT == FROM_CLUSTER) {
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
        for (int j = 1; j < c; ++j)
          d = cadd(d, cmul(widen(cluster.map_shared_rank(buf, j)[pad(mm)]),
                           widen(__ldg(roots + ((j * q) % c) * M))));
        z[e] = narrow(q ? cmul(d, widen(__ldg(roots + mm * q))) : d);
      }
      cluster.sync();    // no block reads a chunk any more
#pragma unroll
      for (int e = 0; e < RADIX; ++e)
        if (!RAGGED || t + e * nt < M) buf[pad(t + e * nt)] = z[e];
    } else {
      const float2* src = nullptr;
      if constexpr (INPUT == FROM_SCRATCH)
        src = scratch + (static_cast<size_t>(b) * n_windows + w) * n +
              static_cast<size_t>(q) * M;
#pragma unroll
      for (int e = 0; e < RADIX; ++e) {
        const int i = t + e * nt;
        if (!RAGGED || i < M)
          buf[pad(i)] = block_input<T, INPUT>(xr, xi, window, src, s, i);
      }
    }
    __syncthreads();

    for (int p = 3; rem > 1; p += 2) {
      if (p * p > rem) p = rem;              // what remains is prime
      while (rem % p == 0) {
        if (!RAGGED && ns == 1)
          odd_first_pass_staged(buf, tw_s, t, M, p);
        else
          odd_pass<NTMAX == 1024 ? 2 : 4>(buf, tab, t, nt, M, p, ns);
        tab += ns * p;
        ns *= p;
        rem /= p;
      }
    }

    float2 v[RADIX];
    if constexpr (RAGGED) {
      switch (R0) {
        case 2: pow2_pass_ragged<2>(buf, roots, t, nt, n, ns); break;
        case 4: pow2_pass_ragged<4>(buf, roots, t, nt, n, ns); break;
        case 8: pow2_pass_ragged<8>(buf, roots, t, nt, n, ns); break;
        default: break;                        // odd M: no pow2 pass
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < RADIX; ++e)
        if (t + e * nt < M) v[e] = buf[pad(t + e * nt)];
    } else {
      const bool last = Q == 0;
      switch (R0) {
        case 2:
          pow2_first_pass<2>(v, buf, roots, t, nt, M, n, ns, last);
          break;
        case 4:
          pow2_first_pass<4>(v, buf, roots, t, nt, M, n, ns, last);
          break;
        case 8:
          pow2_first_pass<8>(v, buf, roots, t, nt, M, n, ns, last);
          break;
        default:
          pow2_first_pass<16>(v, buf, roots, t, nt, M, n, ns, last);
      }
      ns *= R0;
#pragma unroll 1
      for (int p = 0; p < Q; ++p) {
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RADIX; ++r) v[r] = buf[pad(t + r * nt)];
        const int tw = t % ns;                 // j mod Ns
        dft<RADIX>(v, roots, tw * (n / (ns * RADIX)));
        if (p < Q - 1) {
          __syncthreads();
#pragma unroll
          for (int k = 0; k < RADIX; ++k)
            buf[pad((t - tw) * RADIX + tw + k * ns)] = v[k];
        }
        ns *= RADIX;
      }
    }

    // v[k] = bin t + k*nt of this block's M-point FFT.
#pragma unroll
    for (int k = 0; k < RADIX; ++k) {
      if (RAGGED && t + k * nt >= M) continue;
      const float mag = wt * sqrtf(v[k].x * v[k].x + v[k].y * v[k].y);
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

template <typename T, int NTMAX, int INPUT, bool RAGGED>
int launch_mixed_nt(const void* re, const void* im, const void* scratch,
                    float* dst, const void* starts, const void* weights,
                    const void* window, const void* roots,
                    const void* pass_roots, int rows, int full_size, int n,
                    int c, int n_windows, int groups, int fold,
                    cudaStream_t stream) {
  const int m_pts = n / c;
  int m = m_pts;                      // the kernel's tw_s: p1 roots where
  while (!(m & 1)) m >>= 1;           // the first odd pass is staged
  int p1 = m;
  for (int p = 3; p * p <= m; p += 2)
    if (m % p == 0) {
      p1 = p;
      break;
    }
  const bool staged = m > 1 && (INPUT == FROM_CLUSTER || p1 > 7);
  const size_t smem = static_cast<size_t>(m_pts + m_pts / 16) *
                          sizeof(float2) +
                      (NTMAX == 1024 ? m_pts * sizeof(float) : 0) +
                      (staged && !RAGGED ? p1 * sizeof(float2) : 0);
  auto kernel = curscan_mixed_kernel<T, NTMAX, INPUT, RAGGED>;
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
      fold, n, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation per thread-count class and plan: up to 512 threads
// (held to 128 registers, so at least 512 threads of a small block size
// share an SM), up to 1024 (64, fold in shared memory); RAGGED where 16
// does not divide the block's M points.  A cluster's blocks always hold
// more than 8192 points (c is the smallest power of two with N/c <=
// 16384), so FROM_CLUSTER needs only the second class.
template <typename T, int INPUT>
int launch_mixed(const void* re, const void* im, const void* scratch,
                 float* dst, const void* starts, const void* weights,
                 const void* window, const void* roots,
                 const void* pass_roots, int rows, int full_size, int n,
                 int c, int n_windows, int groups, int fold,
                 cudaStream_t stream) {
#define KSPEC_MIXED_CASE(NTMAX, RAGGED)                                     \
  return launch_mixed_nt<T, NTMAX, INPUT, RAGGED>(                          \
      re, im, scratch, dst, starts, weights, window, roots, pass_roots,     \
      rows, full_size, n, c, n_windows, groups, fold, stream)
  const int m_pts = n / c;
  const int nt = (m_pts + RADIX - 1) / RADIX;
  const bool ragged = m_pts % RADIX != 0;
  if constexpr (INPUT != FROM_CLUSTER) {
    if (nt <= 512) {
      if (ragged) KSPEC_MIXED_CASE(512, true);
      KSPEC_MIXED_CASE(512, false);
    }
  } else {
    if (nt <= 512) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ragged) KSPEC_MIXED_CASE(1024, true);
  KSPEC_MIXED_CASE(1024, false);
#undef KSPEC_MIXED_CASE
}

// The FROM_SCRATCH route, `chunk` IQ blocks at a time: dif_split into the
// scratch (chunk, n_windows, n) float2, then the block kernel.
template <typename T>
int launch_hbm(const void* re, const void* im, void* scratch, float* dst,
               const void* starts, const void* weights, const void* window,
               const void* roots, const void* pass_roots, int t,
               int full_size, int n, int c, int chunk, int n_windows,
               int groups, int fold, cudaStream_t stream) {
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
          stream);
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
                        int n_windows, int groups, int fold,
                        cudaStream_t stream);

}  // namespace kspec_fft
