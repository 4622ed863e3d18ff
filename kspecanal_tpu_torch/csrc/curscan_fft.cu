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
// on Hopper the same function is a radix FFT: curscan_fft_kernel below for
// the powers of two up to 131072, curscan_mixed_kernel (curscan_mixed.cuh)
// for every other size.
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
// The FFT (one thread block, M <= 16384 points, M/16 threads): a Stockham
// decimation-in-time FFT, 16 complex values in each thread's registers.
// Pass 1 has radix R0 = M / 16^Q in {2, 4, 8, 16} (16/R0 butterflies a
// thread) and needs no twiddle; the Q passes after it have radix 16 (a 4 x 4
// split in registers with constant W16 twiddles).  Pass p with Ns points
// already combined: butterfly j reads elements j + r*M/16, multiplies
// element r by roots[r * (j mod Ns) * N / (16 Ns)] (the one float32 table of
// N roots that the wrapper builds in float64 and rounds once; no __sincosf),
// and writes output k to (j div Ns)*16 Ns + (j mod Ns) + k Ns.  After the
// last pass thread t holds bins t + k*M/16 in its registers, the same bins
// in every window, so the fold stays in registers: no atomics, windows in
// order, a deterministic result.  tests/test_torch_fft_kernel.py models this
// index math in NumPy and holds it to np.fft.
//
// fft 32768..131072 (a thread-block cluster): c = N/16384 blocks (c <= 8,
// the portable cluster size), decimation in frequency across the cluster.
// Block j holds the contiguous chunk a[j*M .. (j+1)*M) (M = N/c) in its
// shared memory; after cluster.sync() block q reads every chunk at its own
// positions m through distributed shared memory (map_shared_rank) and
// forms z_q[m] = W_N^(m q) * sum_j a[m + M j] W_c^(j q) in the registers of
// its pass 1; a second cluster.sync() frees the chunks, and block q's
// M-point FFT gives the bins X[c*k + q].
//
// Precision: HIGHEST, and HIGH/DEFAULT where the tensor-core kernel
// (curscan_tc.cu) does not serve, with float32 planes, table,
// registers between butterflies and shared memory.  Each butterfly (its
// pass twiddles included) runs in float64 and rounds to float32 twice: after
// its inner DFT-4 stage and at its end.  Why: the bound is per bin, 5e-5 of
// the bin plus 1e-6 of the peak, and a MIN fold at 90% overlap keeps bins
// near 1% of its peak.  There a float32 radix FFT (cuFFT's, in the plain
// torch.fft chain, and this kernel with float32 butterflies) misses the
// bound against float64 by up to 1.5 times at fft 32768; with float64
// butterflies the kernel stays near a third of it.  Two roundings per pass
// instead of one per operation is what buys that; the frame and the table
// stay float32.  The HIGHEST class's bound is tighter than HIGH's and
// DEFAULT's, so this serves all three.  Tensor cores are not used: TF32
// keeps about three digits, and 3xTF32 would triple the work of passes
// that shared memory already bounds.
//
// What bounds it on the H100:
//  * HBM bytes per sample: every sample is read from device memory about
//    once (8 bytes of float32 planes, 2 of u8); overlapping windows re-read
//    their shared samples from L2 (90% overlap reads each sample ~10 times
//    there).  537 MB of float32 planes at the zero-span cell take 0.16 ms at
//    3.35 TB/s.
//  * Shared-memory traffic per pass: each pass but the last stores and
//    loads the whole block (16 bytes per point), Q stores and loads per
//    window.  The buffer is padded one float2 in 16 (index a + a/16), which
//    makes every store and load of every pass free of bank conflicts (the
//    model checks each half-warp's addresses).
//  * Waves: at M = 16384 a block takes 204,800 bytes of shared memory (the
//    padded buffer and the fold of its 1024 threads), so one block per SM.
//    The windows of an IQ block are split into G groups in G thread blocks
//    (G = min(W, ceil(8 * SMs / (T * c))), chosen by the wrapper), each
//    writing a partial fold to a (T, G, N) scratch that a second small
//    kernel combines in the order g = 0..G-1 (AVG stays deterministic;
//    MAX/MIN combine exactly).
//
// Loads: the frame goes from device memory straight into the registers of
// pass 1 (thread t reads samples t + e*M/16: consecutive threads,
// consecutive addresses), so the frame is never staged in shared memory.
// They are scalar loads (4-byte floats, 1-byte u8 decoded in registers),
// which are coalesced at any start, so misaligned starts (90% overlap,
// fmScan) need no aligned superset or shift; u8 decodes to exactly the
// float32 values the decoded planes hold, so u8 is bit-identical to them.
// Without a barrier between a window's fold and the next window's loads,
// warps that finish early load the next frame while the rest still compute.
// A cp.async / TMA staging buffer was left out: at fft 16384 the float32
// frame (128 KB) and the exchange buffer (136 KB) do not both fit in a
// block's 227 KB.

#include "curscan_fft.cuh"

namespace {

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
      const float mag = wt * sqrtf(v[k].x * v[k].x + v[k].y * v[k].y);
      if constexpr (FOLD_IN_SMEM)
        fold_s[k * NT + t] = fold_in(fold_s[k * NT + t], mag, fold);
      else
        acc[k] = fold_in(acc[k], mag, fold);
    }
  }

  // Bin c*(t + k*NT) + q of the N-point FFT, fftshifted.  out is (T, N), or
  // the (T, G, N) partials when groups > 1: row cb either way.
  float* o = out + static_cast<size_t>(cb) * n;
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    float* dst = o + ((c * (t + k * NT) + q + n / 2) & (n - 1));
    if constexpr (FOLD_IN_SMEM)
      *dst = fold_s[k * NT + t];
    else
      *dst = acc[k];
  }
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

template <typename T, int LOG2M, bool CLUSTER>
int launch_fft(const void* re, const void* im, float* dst, const void* starts,
               const void* weights, const void* window, const void* roots,
               int t, int full_size, int n, int n_windows, int groups,
               int fold, cudaStream_t stream) {
  constexpr int M = 1 << LOG2M;
  const int c = n / M;
  const size_t smem = static_cast<size_t>(M + M / 16) * sizeof(float2) +
                      (M / RADIX == 1024 ? M * sizeof(float) : 0);
  auto kernel = curscan_fft_kernel<T, LOG2M, CLUSTER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(t) * groups * c);
  config.blockDim = dim3(M / RADIX);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (CLUSTER) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(re), static_cast<const T*>(im),
      dst, static_cast<const int*>(starts),
      static_cast<const float*>(weights), static_cast<const float*>(window),
      static_cast<const float2*>(roots), full_size, n_windows, groups, fold);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_by_size(const void* re, const void* im, float* dst,
                   const void* starts, const void* weights,
                   const void* window, const void* roots, int t,
                   int full_size, int n, int n_windows, int groups, int fold,
                   cudaStream_t stream) {
#define KSPEC_FFT_CASE(L, CL)                                                \
  return launch_fft<T, L, CL>(re, im, dst, starts, weights, window, roots,  \
                              t, full_size, n, n_windows, groups, fold,      \
                              stream)
  switch (n) {
    case 1 << 8: KSPEC_FFT_CASE(8, false);
    case 1 << 9: KSPEC_FFT_CASE(9, false);
    case 1 << 10: KSPEC_FFT_CASE(10, false);
    case 1 << 11: KSPEC_FFT_CASE(11, false);
    case 1 << 12: KSPEC_FFT_CASE(12, false);
    case 1 << 13: KSPEC_FFT_CASE(13, false);
    case 1 << 14: KSPEC_FFT_CASE(14, false);
    case 1 << 15:
    case 1 << 16:
    case 1 << 17: KSPEC_FFT_CASE(LOG2_BLOCK_N, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KSPEC_FFT_CASE
}

}  // namespace

// Plain C entry point (bound with ctypes).  Planes are (t, full_size)
// row-major, float32 or uint8 (is_u8); out is (t, n) float32; n any multiple
// of c, and c thread blocks a window of n/c <= 16384 points each (the
// wrapper's fft_plan):
//  * n a power of two up to 131072, scratch null: curscan_fft_kernel, c =
//    max(1, n/16384);
//  * another n, scratch null: curscan_mixed_kernel (curscan_mixed.cuh), c a
//    power of two <= MAX_CLUSTER (a cluster when c > 1);
//  * scratch not null (every n above 131072, and the n up to 131072 that
//    no such power of two splits): its dif_split and curscan_mixed_kernel,
//    `chunk` IQ blocks at a time through `scratch`, a (chunk, n_windows, n)
//    float2 buffer.
// pass_roots: the mixed kernel's float64 tables, one for each odd pass of
// an (n/c)-point block in order (odd primes ascending, Ns = 1 first), pass
// (Ns, p) holding W_{Ns p}^u for u < Ns p (cuda_curscan._pass_roots);
// unused by the powers of two up to 131072.
// stop: 0 in production; 1-3 cut the mixed kernel off after a stage for its
// stage table (cuda_curscan.curscan_mixed_stage); the powers of two up to
// 131072 take 0 only.
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
           : (c & (c - 1)) || c > MAX_CLUSTER ||
             (pow2 && m_pts != (n < (1 << LOG2_BLOCK_N)
                                    ? n : (1 << LOG2_BLOCK_N)))))
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = static_cast<float*>(groups > 1 ? part : out);
  int err;
  if (pow2 && !hbm) {
    err = is_u8 ? launch_by_size<uint8_t>(re, im, dst, starts, weights,
                                          window, roots, t, full_size, n,
                                          n_windows, groups, fold, s)
                : launch_by_size<float>(re, im, dst, starts, weights, window,
                                        roots, t, full_size, n, n_windows,
                                        groups, fold, s);
  } else {
    err = kspec_fft::launch_mixed_route(re, im, is_u8, scratch, dst, starts,
                                        weights, window, roots, pass_roots, t,
                                        full_size, n, c, chunk, n_windows,
                                        groups, fold, stop, s);
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
