// Fused curscan kernel, FFT form, for NVIDIA Hopper (sm_90a).
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel_sublane (:423, the
// Pallas sublane-layout curscan kernel of the JAX package, entry
// curscan_fused_sublane) at every fft its predicate takes (every multiple of
// 128 from 256 up), and ::_kernel (:116, the lane layout, entry
// curscan_fused) at every config the JAX dispatcher sends it (fft >= 2048,
// not prime, window starts multiples of n2 = _factorize(fft)[1]: fft 3000,
// 10000, 39800, ... off the 128 grid, and fft >= 16384 on it).  The Pallas
// kernels compute the DFT as two matrix products for the TPU's matrix unit;
// on Hopper the same function is a radix FFT: curscan_fft64_kernel below
// for the powers of two up to 131072 (curscan_fft_kernel, the parent form,
// in a forensic build), curscan_mixed_kernel (curscan_mixed.cuh) for every
// other size.
//
// What it computes, per IQ block b (the contract of curscan_sublane.cu):
//   for every window start s = starts[w] (any static offset, aligned or not):
//     a[m] = window[m] * x[s + m]                      (u8 planes: x - 127)
//     X    = DFT_N(a)
//     acc  = fold(acc, weights[w] * |X|)   AVG/RAW: weighted sum, MAX/MIN:
//            extrema; weights[] carries winAdj*2/N (and the closed-form
//            decay weights for AVG/RAW)
//   out[b][(k + N/2) % N] = acc[k]        natural order, fftshifted
//
// The FFT (one thread block of M points, M/16 threads): a Stockham
// decimation-in-time FFT, 16 complex values in each thread's registers.
// Pass 1 has radix R0 = M / 16^Q in {2, 4, 8, 16} (16/R0 butterflies a
// thread) and needs no twiddle; the Q passes after it have radix 16 (a 4 x 4
// split in registers with constant W16 twiddles).  Pass p with Ns points
// already combined: butterfly j reads elements j + r*M/16, multiplies
// element r by W^r, W = roots[(j mod Ns) * N / (16 Ns)] (the one table of
// N roots that the wrapper builds in float64; no __sincosf), and writes
// output k to (j div Ns)*16 Ns + (j mod Ns) + k Ns.  After the last pass
// thread t holds bins t + k*M/16 in its registers, the same bins in every
// window, so the fold stays in registers: no atomics, windows in order, a
// deterministic result.  tests/test_torch_fft_kernel.py models this index
// math in NumPy and holds it to np.fft.
//
// Above one block: c blocks of M = N/c points a window, decimation in
// frequency: block q forms z_q[m] = W_N^(m q) * sum_j a[m + M j] W_c^(j q)
// in the registers of its pass 1, and its M-point FFT gives the bins
// X[c*k + q].
//
// Two forms (cuda_curscan.fft_plan picks the blocks):
//  * curscan_fft64_kernel, every power of two 256-131072: one block up to
//    8192 points, c = N/8192 blocks of 8192 above (up to 16).  Everything
//    between the loads and the magnitude is float64: the samples are
//    converted once as they are loaded (u8 straight from the integer) and
//    windowed by a float64 window; each butterfly runs in float64 with
//    float64 twiddles, and the values stay float64 in registers between a
//    butterfly's inner and outer stage and in shared memory between passes
//    (M double2, swizzled, see swz).  A pass looks its twiddle W up once a
//    thread and forms W^r by recurrence (14 complex multiplies, errors near
//    1e-15); |X|^2 is narrowed once and its square root taken in float32.
//    The c blocks of a window each read the c chunks they need from device
//    memory (L2), with no cluster.
//  * curscan_fft_kernel (the first design, the parent form), only in the
//    forensic build -DKSPEC_FFT_PARENT=1 that times it beside the float64
//    form: float32 planes, table, registers between butterflies and shared
//    memory, each butterfly in float64 rounded to float32 after its inner
//    DFT-4 and at its end, its 15 twiddles gathered from the float32
//    table; one block up to 16384 points, a cluster of c = N/16384 above,
//    whose chunks are read through distributed shared memory
//    (map_shared_rank).
//
// Precision: HIGHEST, and HIGH/DEFAULT where the tensor-core kernels
// (curscan_tc.cu, curscan_tc_split.cu) do not serve.  The bound is per bin,
// 5e-5 of the bin plus 1e-6 of the peak, and a MIN fold at 90% overlap
// keeps bins near 1% of its peak.  There a float32 radix FFT (cuFFT's, in
// the plain torch.fft chain, and this kernel with float32 butterflies)
// misses the bound against float64 by up to 1.5 times at fft 32768; the
// parent form's float64 butterflies reach 0.36 of it on the card, the
// float64 form 0.004.  Tensor cores are not used: TF32 keeps about three
// digits, and the float64 tensor-core products (DMMA) would need the DFT
// as matrices, N^(3/2) work.
//
// What bounded the parent form, and what bounds this one, on the H100
// (scripts/fft_stages.py, PERF.md):
//  * Not the 64-bit conversions: the card converts 16 values a clock an
//    SM to or from a 64-bit type, and the parent form converts about 28 a
//    point at fft 2048 (10 a radix-16 pass).  Cutting them to three a point
//    alone left the radix-16 stage as slow as before (0.83 against 0.76
//    ms at fft 2048, T=4096).
//  * The twiddle gathers: roots[r * tw * stride] for r = 1..15 touches up
//    to 4r cache lines a warp with double2 entries (2r with the parent's
//    float2).  One lookup a pass and the recurrence took the radix-16
//    stage to 0.34 ms and ended every spill.
//  * Distributed shared memory: a thread's read of another block's chunk
//    runs at about one a clock an SM; the parent's cluster step at fft
//    65536 (4 reads a point) takes 0.97 ms.  The float64 form reads its
//    chunks from L2 instead (4.0 TB/s at fmScan's two blocks a window);
//    at fft 131072 its 16 blocks of 8192 a window, each reading all 16
//    chunks, run 1.46 times the parent's cluster of 8 (4.12 against 6.02
//    ms at T=64).
//  * Now: float64 arithmetic (64 a clock an SM: a radix-16 butterfly with
//    its twiddles is about 290 operations), shared-memory traffic (32 bytes
//    a point a pass, every quarter-warp's 16-byte access free of bank
//    conflicts by the swizzle, checked by the model) and the loads.
//  * Occupancy: the float64 form runs 128 registers at most (launch bounds
//    of 16 warps an SM): 4 blocks of 128 threads at fft 2048, one block of
//    512 (128 KB of shared memory) at 8192 and in the split sizes.
//  * Waves: the windows of an IQ block are split into G groups in G thread
//    blocks (G = min(W, ceil(8 * SMs / (T * c))), chosen by the wrapper),
//    each writing a partial fold to a (T, G, N) scratch that a second small
//    kernel combines in the order g = 0..G-1 (AVG stays deterministic;
//    MAX/MIN combine exactly).
//
// Loads: at one block a window, where a frame (both planes) is at most 8
// KB (stages_frame: fft <= 1024 on float32 planes, <= 4096 on u8), the
// float64 form copies the next window's frame into shared memory (stage,
// after the exchange buffer: 2M samples) by 16-byte cp.async while this
// window's passes run, one copy group a window, waited for and made
// visible by a barrier before it is read; where a frame's start is not
// 16-byte aligned (90% overlap at most sizes) it loads the frame straight
// into registers.  Staged, u8 ran 2-9% faster at fft 256-4096 and float32
// 1-6% at 256-1024; larger frames ran no faster or slower (float32 fft 8192
// 2-5% slower: the copy adds 16 bytes of shared-memory traffic a point to
// the exchanges' 64), and a staging block spills a few dozen bytes
// (scripts/fft_stages.py --staging, PERF.md).  Elsewhere, and in the
// parent form, thread t reads samples t + e*M/16 (consecutive threads,
// consecutive addresses) straight into registers, scalar loads coalesced
// at any start.  u8 decodes to exactly the values the decoded float32
// planes hold, so u8 is bit-identical to them.
//
// Forensic builds of this file alone (cuda_curscan.fft_stage_library): with
// -DKSPEC_FFT_STOP=1..3 both forms stop after the block input (loads,
// window, u8 decode and the cluster's radix-c step), after pass 1, or after
// the radix-16 passes, and fold weights[w] * (re + im) of each point in
// place of its magnitude; 4 is the production kernel built alone, and
// -DKSPEC_FFT_PARENT=1 serves every power of two with the parent form.

#include <type_traits>

#include "curscan_fft.cuh"

// A forensic build (-DKSPEC_FFT_STOP or -DKSPEC_FFT_PARENT) holds this file
// alone: the power-of-two kernel, no mixed route.
#if defined(KSPEC_FFT_STOP) || defined(KSPEC_FFT_PARENT)
#define KSPEC_FFT_FORENSIC 1
#else
#define KSPEC_FFT_FORENSIC 0
#endif
#ifndef KSPEC_FFT_STOP
#define KSPEC_FFT_STOP 4
#endif
#ifndef KSPEC_FFT_PARENT
#define KSPEC_FFT_PARENT 0
#endif
// The largest frame (bytes of both planes) that the float64 form stages
// ahead; the forensic builds -DKSPEC_FFT_STAGE_BYTES=0 and =131072 stage
// no frame and every frame (scripts/fft_stages.py --staging).
#ifndef KSPEC_FFT_STAGE_BYTES
#define KSPEC_FFT_STAGE_BYTES 8192
#endif

namespace {

enum Stop { STOP_INPUT = 1, STOP_PASS1 = 2, STOP_RADIX16 = 3, STOP_FULL = 4 };
constexpr int STOP = KSPEC_FFT_STOP;
static_assert(STOP >= STOP_INPUT && STOP <= STOP_FULL, "KSPEC_FFT_STOP");

// The float64 form's largest block; above it, N/8192 such blocks a window.
constexpr int LOG2_BLOCK64_N = 13;

// Whether a float64 block of m points, c blocks a window, on planes of
// `bytes`-byte samples stages its next frame in shared memory: at one block
// a window, where the frame is at most KSPEC_FFT_STAGE_BYTES (fft 1024 on
// float32, 4096 on u8 planes).
__host__ __device__ constexpr bool stages_frame(int m, int c, int bytes) {
  return c == 1 && 2 * m * bytes <= KSPEC_FFT_STAGE_BYTES;
}

// Shared-memory index of the float64 buffer: element a stays in its aligned
// group of 8 double2 (128 bytes, all 32 banks), at position a ^ ((a >> 3)
// ^ (a >> 4)) & 7 in it.  A quarter-warp's 16-byte accesses are
// conflict-free when its 8 addresses fall in 8 distinct positions: the
// stride-R0 stores of pass 1 (R0 = 2..16), the radix-16 loads (stride 1)
// and stores (runs of Ns), at every block size.
__device__ __forceinline__ int swz(int a) {
  return a ^ (((a >> 3) ^ (a >> 4)) & 7);
}

__device__ __forceinline__ double sample64(const float* p, size_t i) {
  return static_cast<double>(__ldg(p + i));
}

__device__ __forceinline__ double sample64(const uint8_t* p, size_t i) {
  return static_cast<double>(__ldg(p + i)) - 127.0;
}

// The same from the shared-memory stage (no __ldg: it loads global memory
// only).
__device__ __forceinline__ double staged64(const float* p, int i) {
  return static_cast<double>(p[i]);
}

__device__ __forceinline__ double staged64(const uint8_t* p, int i) {
  return static_cast<double>(p[i]) - 127.0;
}

// 16-byte asynchronous copy from device to shared memory, bypassing L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Whether both planes' frames at this start can be copied in 16-byte
// pieces (every block and window alike, so the test is uniform).
template <typename T>
__device__ __forceinline__ bool stageable(const T* xr, const T* xi, int s) {
  return ((reinterpret_cast<uintptr_t>(xr + s) |
           reinterpret_cast<uintptr_t>(xi + s)) & 15) == 0;
}

// Thread t's part of copying the M-sample frame at start s of both planes
// into stage[0, M) (re) and stage[M, 2M) (im), 16 bytes a copy, as one
// cp.async group.
template <typename T, int M, int NT>
__device__ __forceinline__ void stage_frame(T* stage, const T* xr,
                                            const T* xi, int s, int t) {
  constexpr int PER = 16 / static_cast<int>(sizeof(T));  // samples a copy
  constexpr int CH = M / PER;                           // copies a plane
  static_assert((2 * CH) % NT == 0, "whole copies a thread");
#pragma unroll
  for (int e = 0; e < 2 * CH / NT; ++e) {
    const int k = t + e * NT;
    cp_async16(stage + k * PER,
               (k < CH ? xr : xi) + s + (k < CH ? k : k - CH) * PER);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Natural-order DFT of the R float64 values x in place: 16 = 4 x 4 and
// 8 = 4 x 2 (inner DFT-4 over stride-R/4 values, twiddle W16^(n2 k1 16/R),
// outer DFT, transpose by renaming), nothing rounded in between.
template <int R>
__device__ __forceinline__ void dft64(double2 (&x)[R]) {
  if constexpr (R == 2) {
    dft2(x[0], x[1]);
  } else if constexpr (R == 4) {
    dft4(x[0], x[1], x[2], x[3]);
  } else {
    constexpr int N2S = R / 4;
#pragma unroll
    for (int n2 = 0; n2 < N2S; ++n2) {
      dft4(x[n2], x[n2 + N2S], x[n2 + 2 * N2S], x[n2 + 3 * N2S]);
#pragma unroll
      for (int k1 = 1; k1 < 4; ++k1)
        x[n2 + N2S * k1] = twiddle16(x[n2 + N2S * k1], n2 * k1 * (16 / R));
    }
    double2 y[R];
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      double2* d = x + N2S * k1;
      if constexpr (N2S == 4) {
        dft4(d[0], d[1], d[2], d[3]);
      } else {
        dft2(d[0], d[1]);
      }
#pragma unroll
      for (int k2 = 0; k2 < N2S; ++k2) y[k1 + 4 * k2] = d[k2];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = y[k];
  }
}

// The fold of value `val` into slot k of thread t: registers, or
// (FOLD_IN_SMEM, 1024 threads) fold_s[k * NT + t].
template <bool FOLD_IN_SMEM, int NT>
__device__ __forceinline__ void fold_slot(float (&acc)[RADIX], float* fold_s,
                                          int k, int t, float val,
                                          int fold) {
  if constexpr (FOLD_IN_SMEM)
    fold_s[k * NT + t] = fold_in(fold_s[k * NT + t], val, fold);
  else
    acc[k] = fold_in(acc[k], val, fold);
}

// Block position of slot k of thread t where the fold is written: bin (or
// point) t + k*NT, and at the pass-1 cut-off output k % R0 of butterfly
// t + (k / R0)*NT (the parent form's slots) or output k / NB of butterfly
// t + (k % NB)*NT (the float64 form's, written in place).
template <int NT, int R0, bool PARENT>
__device__ __forceinline__ int slot_position(int t, int k) {
  constexpr int NB = RADIX / R0;
  if constexpr (STOP != STOP_PASS1)
    return t + k * NT;
  else if constexpr (PARENT)
    return (t + (k / R0) * NT) * R0 + k % R0;
  else
    return (t + (k % NB) * NT) * R0 + k / NB;
}

// The parent form (see the header): float32 planes, table, registers and
// shared memory, float64 butterflies rounded twice.
template <typename T, int LOG2M, bool CLUSTER>
__global__ void __launch_bounds__((1 << LOG2M) / RADIX)
curscan_fft_kernel(const T* __restrict__ re, const T* __restrict__ im,
                   float* __restrict__ out, const int* __restrict__ starts,
                   const float* __restrict__ weights,
                   const float* __restrict__ window,
                   const float2* __restrict__ roots, int full_size,
                   int n_windows, int groups, int fold) {
  constexpr int M = 1 << LOG2M;            // points of this block's FFT
  constexpr int NT = M / RADIX;            // threads
  constexpr int Q = (LOG2M - 1) / 4;       // radix-16 passes after pass 1
  constexpr int R0 = 1 << (LOG2M - 4 * Q); // radix of pass 1
  constexpr int NB = RADIX / R0;           // pass-1 butterflies per thread
  // At 1024 threads (64 registers each) the fold lives in shared memory,
  // after the exchange buffer: fold[k * NT + t].
  constexpr bool FOLD_IN_SMEM = NT == 1024;
  extern __shared__ float2 buf[];          // pad(M) float2 [+ M float]
  float* fold_s = reinterpret_cast<float*>(buf + M + M / 16);

  const int t = threadIdx.x;
  int c = 1, q = 0;   // cluster size, this block's rank
  if constexpr (CLUSTER) {
    c = static_cast<int>(cg::this_cluster().num_blocks());
    q = static_cast<int>(cg::this_cluster().block_rank());
  }
  const int n = M * c;
  const int cb = blockIdx.x / c;           // (IQ block, window group)
  const int b = cb / groups;
  const int g = cb - b * groups;
  const int w_lo = (g * n_windows) / groups;
  const int w_hi = ((g + 1) * n_windows) / groups;
  const T* xr = re + static_cast<size_t>(b) * full_size;
  const T* xi = im + static_cast<size_t>(b) * full_size;

  float acc[RADIX];   // unused when FOLD_IN_SMEM
  const float init = fold == FOLD_MAX ? -CUDART_INF_F
                   : fold == FOLD_MIN ? CUDART_INF_F : 0.0f;
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    if constexpr (FOLD_IN_SMEM)
      fold_s[k * NT + t] = init;
    else
      acc[k] = init;
  }

  for (int w = w_lo; w < w_hi; ++w) {
    const int s = starts[w];
    const float wt = weights[w];
    float2 v[RADIX];   // v[e] = element t + e*NT of this block's sequence
    if constexpr (CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      __syncthreads();   // this block's last pass has read buf
#pragma unroll
      for (int e = 0; e < RADIX; ++e) {
        const int m = t + e * NT;
        const int i = q * M + m;
        const float gw = __ldg(window + i);
        buf[pad(m)] = make_float2(sample(xr, s + i) * gw,
                                  sample(xi, s + i) * gw);
      }
      cluster.sync();    // every chunk is in its block's shared memory
#pragma unroll
      for (int e = 0; e < RADIX; ++e) {
        const int m = t + e * NT;
        double2 z = widen(cluster.map_shared_rank(buf, 0)[pad(m)]);
        for (int j = 1; j < c; ++j)
          z = cadd(z, cmul(widen(cluster.map_shared_rank(buf, j)[pad(m)]),
                           widen(__ldg(roots + ((j * q) & (c - 1)) * M))));
        v[e] = narrow(q ? cmul(z, widen(__ldg(roots + m * q))) : z);
      }
      cluster.sync();    // no block reads a chunk any more
    } else {
#pragma unroll
      for (int e = 0; e < RADIX; ++e) {
        const int i = t + e * NT;
        const float gw = __ldg(window + i);
        v[e] = make_float2(sample(xr, s + i) * gw, sample(xi, s + i) * gw);
      }
    }
    if constexpr (STOP == STOP_INPUT) {
#pragma unroll
      for (int k = 0; k < RADIX; ++k)
        fold_slot<FOLD_IN_SMEM, NT>(acc, fold_s, k, t,
                                    wt * (v[k].x + v[k].y), fold);
      continue;
    }

    // Pass 1 (Ns = 1): butterfly j = t + i*NT on elements i + r*NB (at
    // j + r*M/R0); output k to j*R0 + k.
    float2 y[RADIX];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      float2 x[R0];
#pragma unroll
      for (int r = 0; r < R0; ++r) x[r] = v[i + r * NB];
      dft<R0>(x, roots, 0);
#pragma unroll
      for (int k = 0; k < R0; ++k) y[i * R0 + k] = x[k];
    }
    if constexpr (STOP == STOP_PASS1) {
#pragma unroll
      for (int k = 0; k < RADIX; ++k)
        fold_slot<FOLD_IN_SMEM, NT>(acc, fold_s, k, t,
                                    wt * (y[k].x + y[k].y), fold);
      continue;
    }
    if constexpr (!CLUSTER) __syncthreads();   // last pass has read buf
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int k = 0; k < R0; ++k)
        buf[pad((t + i * NT) * R0 + k)] = y[i * R0 + k];

    // Radix-16 passes; Ns = R0 * 16^p points combined before pass p.
#pragma unroll
    for (int p = 0; p < Q; ++p) {
      int ns = R0;
#pragma unroll
      for (int i = 0; i < p; ++i) ns *= RADIX;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RADIX; ++r) v[r] = buf[pad(t + r * NT)];
      const int tw = t & (ns - 1);             // j mod Ns
      // element r times roots[r * (j mod Ns) * N / (16 Ns)]
      dft<RADIX>(v, roots, tw * (n / (ns * RADIX)));
      if (p < Q - 1) {
        __syncthreads();
#pragma unroll
        for (int k = 0; k < RADIX; ++k)
          buf[pad((t - tw) * RADIX + tw + k * ns)] = v[k];
      }
    }

    // v[k] = bin t + k*NT of this block's M-point FFT.
#pragma unroll
    for (int k = 0; k < RADIX; ++k) {
      const float mag = STOP == STOP_RADIX16
          ? wt * (v[k].x + v[k].y)
          : wt * sqrtf(v[k].x * v[k].x + v[k].y * v[k].y);
      fold_slot<FOLD_IN_SMEM, NT>(acc, fold_s, k, t, mag, fold);
    }
  }

  // Bin c*(t + k*NT) + q of the N-point FFT, fftshifted.  out is (T, N), or
  // the (T, G, N) partials when groups > 1: row cb either way.
  float* o = out + static_cast<size_t>(cb) * n;
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    float* dst =
        o + ((c * slot_position<NT, R0, true>(t, k) + q + n / 2) & (n - 1));
    if constexpr (FOLD_IN_SMEM)
      *dst = fold_s[k * NT + t];
    else
      *dst = acc[k];
  }
}

// The float64 form (see the header): converted once at the load, float64
// through every pass and in shared memory, narrowed once at |X|^2.  STAGE
// (stages_frame): the next window's frame is copied into shared memory
// (stage, after the exchange buffer) by cp.async while this window's passes
// run, where its start is 16-byte aligned; else it is loaded straight into
// registers.
// C > 1: block q of the C blocks of a window (q = blockIdx.x % C) reads the
// C chunks it needs from device memory.  Launch bounds of 16 warps an SM (a
// block of 16 threads holds a warp's registers): 128 registers a thread.
template <typename T, int LOG2M, int C>
__global__ void __launch_bounds__((1 << LOG2M) / RADIX,
                                  512 / ((1 << LOG2M) / RADIX < 32
                                             ? 32 : (1 << LOG2M) / RADIX))
curscan_fft64_kernel(const T* __restrict__ re, const T* __restrict__ im,
                     float* __restrict__ out,
                     const int* __restrict__ starts,
                     const float* __restrict__ weights,
                     const double* __restrict__ window,
                     const double2* __restrict__ roots, int full_size,
                     int n_windows, int groups, int fold) {
  constexpr int M = 1 << LOG2M;            // points of this block's FFT
  constexpr int NT = M / RADIX;            // threads
  constexpr int Q = (LOG2M - 1) / 4;       // radix-16 passes after pass 1
  constexpr int R0 = 1 << (LOG2M - 4 * Q); // radix of pass 1
  constexpr int NB = RADIX / R0;           // pass-1 butterflies per thread
  constexpr int N = M * C;                 // points of the window's FFT
  constexpr bool STAGE = stages_frame(M, C, sizeof(T));
  static_assert(NT <= 512, "the float64 form holds its fold in registers");
  extern __shared__ double2 buf64[];       // M double2, at swz(a)
  T* stage = reinterpret_cast<T*>(buf64 + M);   // STAGE: 2M samples

  const int t = threadIdx.x;
  const int q = C > 1 ? static_cast<int>(blockIdx.x % C) : 0;
  const int cb = blockIdx.x / C;           // (IQ block, window group)
  const int b = cb / groups;
  const int g = cb - b * groups;
  const int w_lo = (g * n_windows) / groups;
  const int w_hi = ((g + 1) * n_windows) / groups;
  const T* xr = re + static_cast<size_t>(b) * full_size;
  const T* xi = im + static_cast<size_t>(b) * full_size;

  float acc[RADIX];
  const float init = fold == FOLD_MAX ? -CUDART_INF_F
                   : fold == FOLD_MIN ? CUDART_INF_F : 0.0f;
#pragma unroll
  for (int k = 0; k < RADIX; ++k) acc[k] = init;
  // Copies the frame of window w + 1 where it is stageable; called after
  // a barrier that follows every read of the stage.
  auto prefetch = [&](int w) {
    if constexpr (STAGE) {
      if (w + 1 < w_hi && stageable(xr, xi, starts[w + 1]))
        stage_frame<T, M, NT>(stage, xr, xi, starts[w + 1], t);
    }
  };
  if (w_lo < w_hi) prefetch(w_lo - 1);

  for (int w = w_lo; w < w_hi; ++w) {
    const int s = starts[w];
    const float wt = weights[w];
    double2 v[RADIX];   // v[e] = element t + e*NT of this block's sequence
    if (STAGE && stageable(xr, xi, s)) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();   // every thread's copies have landed
#pragma unroll
      for (int e = 0; e < RADIX; ++e) {
        const int i = t + e * NT;
        const double gw = __ldg(window + i);
        v[e] = make_double2(staged64(stage, i) * gw,
                            staged64(stage + M, i) * gw);
      }
    } else if constexpr (C > 1) {
      // z_q[m] = W_N^(m q) * sum_j a[m + M j] W_C^(j q), m = t + e*NT: the
      // C chunks from device memory, W_N^(m q) = W_N^(t q) W_N^(NT q)^e.
      double2 wm = __ldg(roots + t * q);
      const double2 step = __ldg(roots + NT * q);
#pragma unroll
      for (int e = 0; e < RADIX; ++e) {
        double2 z = make_double2(0.0, 0.0);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int i = j * M + t + e * NT;
          const double gw = __ldg(window + i);
          const double2 x = make_double2(sample64(xr, s + i) * gw,
                                         sample64(xi, s + i) * gw);
          z = cadd(z, j ? cmul(x, __ldg(roots + ((j * q) & (C - 1)) * M))
                        : x);
        }
        v[e] = cmul(z, wm);
        wm = cmul(wm, step);
      }
    } else {
#pragma unroll
      for (int e = 0; e < RADIX; ++e) {
        const int i = t + e * NT;
        const double gw = __ldg(window + i);
        v[e] = make_double2(sample64(xr, s + i) * gw,
                            sample64(xi, s + i) * gw);
      }
    }
    if constexpr (STOP == STOP_INPUT) {
#pragma unroll
      for (int k = 0; k < RADIX; ++k)
        acc[k] = fold_in(acc[k],
                         wt * static_cast<float>(v[k].x + v[k].y), fold);
      __syncthreads();
      prefetch(w);
      continue;
    }

    // Pass 1 (Ns = 1): butterfly j = t + i*NT on elements i + r*NB (at
    // j + r*M/R0), in place: output k to slot i + k*NB, for position
    // j*R0 + k.
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      double2 x[R0];
#pragma unroll
      for (int r = 0; r < R0; ++r) x[r] = v[i + r * NB];
      dft64<R0>(x);
#pragma unroll
      for (int k = 0; k < R0; ++k) v[i + k * NB] = x[k];
    }
    if constexpr (STOP == STOP_PASS1) {
#pragma unroll
      for (int k = 0; k < RADIX; ++k)
        acc[k] = fold_in(acc[k],
                         wt * static_cast<float>(v[k].x + v[k].y), fold);
      __syncthreads();
      prefetch(w);
      continue;
    }
    __syncthreads();   // the window before has read buf64, this one stage
    prefetch(w);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int k = 0; k < R0; ++k)
        buf64[swz((t + i * NT) * R0 + k)] = v[i + k * NB];

    // Radix-16 passes; Ns = R0 * 16^p points combined before pass p.
#pragma unroll
    for (int p = 0; p < Q; ++p) {
      int ns = R0;
#pragma unroll
      for (int i = 0; i < p; ++i) ns *= RADIX;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RADIX; ++r) v[r] = buf64[swz(t + r * NT)];
      const int tw = t & (ns - 1);             // j mod Ns
      // element r times W^r, W = roots[(j mod Ns) * N / (16 Ns)]: one
      // lookup a pass, its powers by recurrence (a gather of the 15
      // twiddles would touch up to 4r cache lines a warp for element r)
      const double2 w1 = __ldg(roots + tw * (N / (ns * RADIX)));
      double2 wr = w1;
#pragma unroll
      for (int r = 1; r < RADIX; ++r) {
        v[r] = cmul(v[r], wr);
        if (r < RADIX - 1) wr = cmul(wr, w1);
      }
      dft64<RADIX>(v);
      if (p < Q - 1) {
        __syncthreads();
#pragma unroll
        for (int k = 0; k < RADIX; ++k)
          buf64[swz((t - tw) * RADIX + tw + k * ns)] = v[k];
      }
    }

    // v[k] = bin t + k*NT of this block's M-point FFT.
#pragma unroll
    for (int k = 0; k < RADIX; ++k) {
      const float mag = STOP == STOP_RADIX16
          ? wt * static_cast<float>(v[k].x + v[k].y)
          : wt * sqrtf(static_cast<float>(v[k].x * v[k].x +
                                          v[k].y * v[k].y));
      acc[k] = fold_in(acc[k], mag, fold);
    }
  }

  // Bin C*(t + k*NT) + q of the N-point FFT, fftshifted.  out is (T, N), or
  // the (T, G, N) partials when groups > 1: row cb either way.
  float* o = out + static_cast<size_t>(cb) * N;
#pragma unroll
  for (int k = 0; k < RADIX; ++k)
    o[(C * slot_position<NT, R0, false>(t, k) + q + N / 2) & (N - 1)] =
        acc[k];
}

// out[b][i] = fold of part[b][g][i] over g = 0..groups-1, in that order.
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_groups(const float* __restrict__ part, float* __restrict__ out,
               int n, int groups, int fold, size_t total) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * COMBINE_THREADS +
                     threadIdx.x;
  if (idx >= total) return;
  const size_t b = idx / n;
  const float* p = part + b * groups * n + (idx - b * n);
  float a = p[0];
  for (int g = 1; g < groups; ++g) {
    const float x = p[static_cast<size_t>(g) * n];
    a = fold == FOLD_SUM ? a + x : fold == FOLD_MAX ? fmaxf(a, x)
                                                     : fminf(a, x);
  }
  out[idx] = a;
}

// One instantiation of a power-of-two form: blocks of 2^LOG2M points, C of
// them a window (the parent form: a cluster when C > 1, whatever C; the
// float64 form: C blocks reading their chunks from device memory), the
// parent form (PARENT) or the float64 one.
template <typename T, int LOG2M, int C, bool PARENT>
struct Pow2 {
  static constexpr int M = 1 << LOG2M;
  static constexpr int NT = M / RADIX;
  static constexpr bool CLUSTER = PARENT && C > 1;
  using Window = std::conditional_t<PARENT, float, double>;
  using Root = std::conditional_t<PARENT, float2, double2>;
  static size_t smem() {
    if constexpr (PARENT)
      return static_cast<size_t>(M + M / 16) * sizeof(float2) +
             (NT == 1024 ? M * sizeof(float) : 0);
    else
      return static_cast<size_t>(M) * sizeof(double2) +
             (stages_frame(M, C, sizeof(T)) ? 2 * M * sizeof(T) : 0);
  }
  static auto kernel() {
    if constexpr (PARENT)
      return curscan_fft_kernel<T, LOG2M, CLUSTER>;
    else
      return curscan_fft64_kernel<T, LOG2M, C>;
  }
  // The kernel's maximum dynamic shared memory set to smem().
  static cudaError_t prepare() {
    return cudaFuncSetAttribute(kernel(),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem()));
  }
};

// Calls f(Pow2<...>{}) with the instantiation that serves an n-point
// window (PARENT: the parent form, else the float64 form); an n it does
// not take returns cudaErrorInvalidValue.
template <typename T, bool PARENT, typename F>
int by_size(int n, F&& f) {
  constexpr int B64 = LOG2_BLOCK64_N;
  switch (n) {
    case 1 << 8: return f(Pow2<T, 8, 1, PARENT>{});
    case 1 << 9: return f(Pow2<T, 9, 1, PARENT>{});
    case 1 << 10: return f(Pow2<T, 10, 1, PARENT>{});
    case 1 << 11: return f(Pow2<T, 11, 1, PARENT>{});
    case 1 << 12: return f(Pow2<T, 12, 1, PARENT>{});
    case 1 << 13: return f(Pow2<T, 13, 1, PARENT>{});
    case 1 << 14:
      if constexpr (PARENT) return f(Pow2<T, 14, 1, true>{});
      else return f(Pow2<T, B64, 2, false>{});
    case 1 << 15:
      if constexpr (PARENT) return f(Pow2<T, LOG2_BLOCK_N, 2, true>{});
      else return f(Pow2<T, B64, 4, false>{});
    case 1 << 16:
      if constexpr (PARENT) return f(Pow2<T, LOG2_BLOCK_N, 2, true>{});
      else return f(Pow2<T, B64, 8, false>{});
    case 1 << 17:
      if constexpr (PARENT) return f(Pow2<T, LOG2_BLOCK_N, 2, true>{});
      else return f(Pow2<T, B64, 16, false>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Points a block of the form that serves a power of two n.
int pow2_block(int n) {
  const int big = KSPEC_FFT_PARENT ? 1 << LOG2_BLOCK_N : 1 << LOG2_BLOCK64_N;
  return n < big ? n : big;
}

template <typename T>
int launch_pow2(const void* re, const void* im, float* dst,
                const void* starts, const void* weights, const void* window,
                const void* roots, int t, int full_size, int n,
                int n_windows, int groups, int fold, cudaStream_t stream) {
  return by_size<T, KSPEC_FFT_PARENT != 0>(n, [&](auto form) {
    using K = decltype(form);
    cudaError_t err = K::prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int c = n / K::M;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(t) * groups * c);
    config.blockDim = dim3(K::NT);
    config.dynamicSmemBytes = K::smem();
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    if (K::CLUSTER) {
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = c;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      config.attrs = attr;
      config.numAttrs = 1;
    }
    err = cudaLaunchKernelEx(
        &config, K::kernel(), static_cast<const T*>(re),
        static_cast<const T*>(im), dst, static_cast<const int*>(starts),
        static_cast<const float*>(weights),
        static_cast<const typename K::Window*>(window),
        static_cast<const typename K::Root*>(roots), full_size, n_windows,
        groups, fold);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Plain C entry point (bound with ctypes).  Planes are (t, full_size)
// row-major, float32 or uint8 (is_u8); out is (t, n) float32; n any multiple
// of c, and c thread blocks a window of n/c <= 16384 points each (the
// wrapper's fft_plan):
//  * n a power of two up to 131072, scratch null: the power-of-two kernel,
//    the float64 form (c = max(1, n/8192)), whose window and roots are
//    float64 tables (double, double2); in the build -DKSPEC_FFT_PARENT=1
//    the parent form (c = max(1, n/16384)), whose tables are float32
//    (float, float2);
//  * another n, scratch null: curscan_mixed_kernel (curscan_mixed.cuh), c a
//    power of two <= MAX_CLUSTER (a cluster when c > 1), float32 tables;
//  * scratch not null (every n above 131072, and the n up to 131072 that
//    no such power of two splits): its dif_split and curscan_mixed_kernel,
//    `chunk` IQ blocks at a time through `scratch`, a (chunk, n_windows, n)
//    float2 buffer.
// The forensic builds of this file alone take the powers of two only.
// pass_roots: the mixed kernel's float64 tables, one for each odd pass of
// an (n/c)-point block in order (odd primes ascending, Ns = 1 first), pass
// (Ns, p) holding W_{Ns p}^u for u < Ns p (cuda_curscan._pass_roots);
// unused by the powers of two up to 131072.
// stop: 0 in production; 1-3 cut the mixed kernel off after a stage for its
// stage table (cuda_curscan.curscan_mixed_stage); the powers of two up to
// 131072 take 0 only (their cut-offs are the builds -DKSPEC_FFT_STOP).
// With groups > 1, part is a (t, groups, n) float32 buffer for the groups'
// partial folds, combined into out by a second kernel; with groups == 1
// part is unused.  Returns the CUDA error code of the launches (0 on
// success); the kernels run asynchronously on `stream`.
extern "C" int kspec_curscan_fft(const void* re, const void* im, int is_u8,
                                 void* out, void* part, void* scratch,
                                 const void* starts, const void* weights,
                                 const void* window, const void* roots,
                                 const void* pass_roots, int t,
                                 int full_size, int n, int c, int chunk,
                                 int n_windows, int groups, int fold,
                                 int stop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_pts = c >= 1 && n % c == 0 ? n / c : 0;
  const bool pow2 = n > 0 && (n & (n - 1)) == 0;
  const bool hbm = scratch != nullptr;
  if (groups < 1 || groups > n_windows || (groups > 1 && part == nullptr) ||
      stop < 0 || stop > 3 || (stop && pow2 && !hbm) ||
      m_pts < 1 || m_pts > (1 << LOG2_BLOCK_N) ||
      (hbm ? chunk < 1
           : pow2 ? m_pts != pow2_block(n)
                  : (c & (c - 1)) || c > MAX_CLUSTER) ||
      (KSPEC_FFT_FORENSIC && (hbm || !pow2)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = static_cast<float*>(groups > 1 ? part : out);
  int err;
  if (pow2 && !hbm) {
    err = is_u8 ? launch_pow2<uint8_t>(re, im, dst, starts, weights, window,
                                       roots, t, full_size, n, n_windows,
                                       groups, fold, s)
                : launch_pow2<float>(re, im, dst, starts, weights, window,
                                     roots, t, full_size, n, n_windows,
                                     groups, fold, s);
  } else {
#if KSPEC_FFT_FORENSIC
    err = static_cast<int>(cudaErrorInvalidValue);
#else
    err = kspec_fft::launch_mixed_route(re, im, is_u8, scratch, dst, starts,
                                        weights, window, roots, pass_roots, t,
                                        full_size, n, c, chunk, n_windows,
                                        groups, fold, stop, s);
#endif
  }
  if (err || groups == 1) return err;
  const size_t total = static_cast<size_t>(t) * n;
  combine_groups<<<static_cast<unsigned>((total + COMBINE_THREADS - 1) /
                                         COMBINE_THREADS),
                   COMBINE_THREADS, 0, s>>>(static_cast<const float*>(part),
                                            static_cast<float*>(out), n,
                                            groups, fold, total);
  return static_cast<int>(cudaGetLastError());
}

// The power-of-two kernel that serves an n-point window in this build, on
// uint8 (is_u8) or float32 planes: attrs[0..3] = its registers a thread,
// local memory a thread (spills and stack), shared memory a block (dynamic
// and static) and resident blocks an SM.  Returns the CUDA error code.
extern "C" int kspec_curscan_fft_attrs(int n, int is_u8, int* attrs) {
  auto query = [&](auto form) {
    using K = decltype(form);
    cudaError_t err = K::prepare();
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, K::kernel());
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, K::kernel(), K::NT, K::smem());
    if (err != cudaSuccess) return static_cast<int>(err);
    attrs[0] = fa.numRegs;
    attrs[1] = static_cast<int>(fa.localSizeBytes);
    attrs[2] = static_cast<int>(fa.sharedSizeBytes + K::smem());
    attrs[3] = blocks;
    return 0;
  };
  return is_u8 ? by_size<uint8_t, KSPEC_FFT_PARENT != 0>(n, query)
               : by_size<float, KSPEC_FFT_PARENT != 0>(n, query);
}
