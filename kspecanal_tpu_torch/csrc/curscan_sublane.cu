// Fused curscan kernel, direct two-stage DFT form, for NVIDIA Hopper
// (sm_90a).
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel_sublane (the Pallas
// sublane-layout curscan kernel of the JAX package, entry
// curscan_fused_sublane) at the ffts that are multiples of 128 but not
// powers of two, up to 16384; the powers of two run the FFT kernel
// curscan_fft.cu.  It computes the TPU kernels' own two-stage DFT.  No
// session runs it: it is the FFT kernel's yardstick
// (ops/cuda_curscan.curscan_sublane_direct).  K4 and K1's ablate keys at
// HIGHEST run the six-pass forensic builds of the tensor-core kernels
// (curscan_tc.cuh, curscan_tc_split.cuh).
//
// What it computes, per IQ block b:
//   for every window start s = starts[w] (any static offset, aligned or not):
//     a[m]  = window[m] * x[s + m]                     (u8 planes: x - 127)
//     X     = DFT_N(a)  as two stages, N = n1 * 128:
//               stage 1  B[k1][m2] = sum_m1 a[m1*128 + m2] W_n1^(m1 k1)
//               twiddle  C[k1][m2] = B[k1][m2] W_N^(m2 k1)
//               stage 2  D[k1][k2] = sum_m2 C[k1][m2] W_128^(m2 k2)
//               X[k1 + n1*k2] = D[k1][k2]
//     acc   = fold(acc, weights[w] * |X|)  AVG/RAW: weighted sum, MAX/MIN:
//             extrema; weights[] carries winAdj*2/N (and the closed-form
//             decay weights for AVG/RAW)
//   out[b][(k + N/2) % N] = acc[k]       natural order, fftshifted
//
// What bounds it on the H100: arithmetic, not HBM.  The direct two-stage
// DFT costs N*(n1 + 128) complex multiply-adds per window, about 18 M real
// FMA per 16384-sample block at fft 2048 (15 windows), against 8
// bytes/sample of float32 input (2 bytes/sample of u8): some 140 FMA per
// input byte, far above the ~10 FP32 FMA (20 FLOP) per byte at which the
// card's 67 TFLOP/s FP32 rate and 3.35 TB/s of HBM balance.  In this form
// the stage-2 loop's instruction throughput binds first: every complex
// multiply-add there is fed by a shared-memory load.  Every input sample is
// read from device memory once per window that covers it (through L1/L2;
// the overlapping windows of one block hit cache) and only N floats per
// block are written.
//
// What the design does about it: everything between the load and the
// output stays on chip.  The frame, the stage-1 result and the root tables
// live in shared memory; each thread owns up to ROWS output rows of one
// column and keeps their partial sums and the running fold in registers,
// so the fold needs no shared-memory traffic and no atomics.  Within a warp
// the stage-1 roots and the stage-2 inputs are warp-uniform (broadcast
// loads).  Windows are processed in order, so the result is deterministic.
// This is the simple, exact-in-f32 form; tensor-core (wgmma) precision
// classes and a cheaper stage 2 are later work.
//
// Accuracy: the rounding error of a direct sum grows with its length.  With
// float32 sums a 128-term stage 1 (fft 16384) missed the per-bin bound
// against torch.fft on MIN folds at 90% overlap (2 of 262,144 bins at twice
// the bound, on the H100), so above fft 8192 (n1 > 64) the stage sums, the
// stage-1 rows and the root tables are float64 (type A below); the frame,
// the weights and the output stay float32.
//
// Launch plan: grid (T, splits).  The n1 rows k1 of one block's DFT are
// dealt out to `splits` thread blocks of up to MAX_GROUPS * ROWS = 32 rows
// each (one thread block when n1 <= 32).  Stage 1 of a row needs every m1
// of its 128 columns but no other row, so each thread block loads the whole
// windowed frame and keeps only its own rows' stage-1 result: the blocks of
// one IQ block share nothing, and each writes its own output bins.
//
// Shared memory: N * 8 bytes of frame plus (32 * 128 + n1 + 128) * sizeof(A2)
// of stage-1 rows and roots.  N = 8192 (float32 sums) needs 99,840 bytes,
// N = 16384 (float64 sums) 200,704 of the 232,448 a block may use; 16384 is
// the largest fft_size this kernel takes
// (ops/cuda_curscan.DIRECT_MAX_FFT_SIZE).
//
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int N2 = 128;        // stage-2 length: the kernel's fixed second factor
constexpr int ROWS = 8;        // stage rows per thread
constexpr int MAX_GROUPS = 4;  // 128-thread row groups per block (<= 512 threads)
constexpr int F32_MAX_N1 = 64; // float32 stage sums up to n1 = 64 (fft 8192)

enum Fold { FOLD_SUM = 0, FOLD_MAX = 1, FOLD_MIN = 2 };

template <typename A> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

__device__ __forceinline__ float sample(const float* p, int i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float sample(const uint8_t* p, int i) {
  return static_cast<float>(__ldg(p + i)) - 127.0f;
}

template <typename V>
__device__ __forceinline__ V widen(float2 v) {
  V r;
  r.x = v.x;
  r.y = v.y;
  return r;
}

// acc += x * f (complex)
template <typename V>
__device__ __forceinline__ void cmac(V& acc, V x, V f) {
  acc.x = fma(x.x, f.x, fma(-x.y, f.y, acc.x));
  acc.y = fma(x.x, f.y, fma(x.y, f.x, acc.y));
}

template <typename V>
__device__ __forceinline__ V cmul(V x, V f) {
  V r;
  r.x = x.x * f.x - x.y * f.y;
  r.y = x.x * f.y + x.y * f.x;
  return r;
}

template <typename T, typename A>
__global__ void __launch_bounds__(N2 * MAX_GROUPS)
curscan_sublane_kernel(const T* __restrict__ re, const T* __restrict__ im,
                       float* __restrict__ out,
                       const int* __restrict__ starts,
                       const float* __restrict__ weights,
                       const float* __restrict__ window,
                       const float2* __restrict__ roots,
                       int full_size, int n, int n_windows, int fold) {
  using A2 = typename Vec2<A>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n1 = n / N2;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int ngrp = nthreads / N2;
  const int rows = ngrp * ROWS;   // k1 rows of this thread block
  A2* c = reinterpret_cast<A2*>(smem);  // own stage-1 rows after twiddle, c[lr * 128 + m2]
  A2* w1 = c + rows * N2;         // exp(-2 pi i e / n1) = roots[e * 128]
  A2* w_128 = w1 + n1;            // exp(-2 pi i j / 128) = roots[j * n1]
  float2* a = reinterpret_cast<float2*>(w_128 + N2);  // windowed frame, a[m1 * 128 + m2]

  const int col = tid % N2;       // m2 in stage 1, k2 in stage 2
  const int grp = tid / N2;       // local rows lr = grp + r * ngrp
  const int row0 = blockIdx.y * rows;

  for (int j = tid; j < n1; j += nthreads) w1[j] = widen<A2>(roots[j * N2]);
  for (int j = tid; j < N2; j += nthreads) w_128[j] = widen<A2>(roots[j * n1]);

  const size_t base = static_cast<size_t>(blockIdx.x) * full_size;
  const T* xr = re + base;
  const T* xi = im + base;

  float acc[ROWS];
  const float init = fold == FOLD_MAX ? -CUDART_INF_F
                   : fold == FOLD_MIN ? CUDART_INF_F : 0.0f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = init;

  for (int w = 0; w < n_windows; ++w) {
    const int s = starts[w];
    const float wt = weights[w];

    // Load + decode + window.  a[] was last read in the previous window's
    // stage 1, which every thread finished before that window's 2nd barrier.
    for (int m = tid; m < n; m += nthreads) {
      const float g = __ldg(window + m);
      a[m] = make_float2(sample(xr, s + m) * g, sample(xi, s + m) * g);
    }
    __syncthreads();

    // Stage 1 (length-n1 DFT down each of the 128 columns, own rows only)
    // + twiddle.
    A2 b[ROWS];
    int e[ROWS];   // (m1 * k1) mod n1, stepped without an integer division
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      b[r].x = 0;
      b[r].y = 0;
      e[r] = 0;
    }
    for (int m1 = 0; m1 < n1; ++m1) {
      const A2 x = widen<A2>(a[m1 * N2 + col]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int k1 = row0 + grp + r * ngrp;
        if (k1 < n1) {
          cmac(b[r], x, w1[e[r]]);
          e[r] += k1;
          if (e[r] >= n1) e[r] -= n1;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int lr = grp + r * ngrp;
      const int k1 = row0 + lr;
      if (k1 < n1)
        c[lr * N2 + col] =
            cmul(b[r], widen<A2>(__ldg(roots + (col * k1) % n)));
    }
    __syncthreads();

    // Stage 2 (length-128 DFT along each own row), |.|, fold.
    A2 d[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      d[r].x = 0;
      d[r].y = 0;
    }
    for (int m2 = 0; m2 < N2; ++m2) {
      const A2 f = w_128[(m2 * col) & (N2 - 1)];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int lr = grp + r * ngrp;
        if (row0 + lr < n1) cmac(d[r], c[lr * N2 + m2], f);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float mag =
          wt * static_cast<float>(sqrt(d[r].x * d[r].x + d[r].y * d[r].y));
      acc[r] = fold == FOLD_SUM ? acc[r] + mag
             : fold == FOLD_MAX ? fmaxf(acc[r], mag) : fminf(acc[r], mag);
    }
  }

  float* o = out + static_cast<size_t>(blockIdx.x) * n;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int k1 = row0 + grp + r * ngrp;
    if (k1 < n1) o[(k1 + n1 * col + n / 2) % n] = acc[r];
  }
}

template <typename T, typename A>
int launch(const void* re, const void* im, void* out, const void* starts,
           const void* weights, const void* window, const void* roots,
           int t, int full_size, int n, int n_windows, int fold,
           cudaStream_t stream) {
  const int n1 = n / N2;
  int groups = (n1 + ROWS - 1) / ROWS;
  if (groups > MAX_GROUPS) groups = MAX_GROUPS;
  const int rows = groups * ROWS;
  const dim3 grid(t, (n1 + rows - 1) / rows);
  const size_t smem = static_cast<size_t>(n) * sizeof(float2) +
                      (rows * N2 + n1 + N2) * sizeof(typename Vec2<A>::type);
  cudaError_t err = cudaFuncSetAttribute(
      curscan_sublane_kernel<T, A>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  curscan_sublane_kernel<T, A><<<grid, N2 * groups, smem, stream>>>(
      static_cast<const T*>(re), static_cast<const T*>(im),
      static_cast<float*>(out), static_cast<const int*>(starts),
      static_cast<const float*>(weights), static_cast<const float*>(window),
      static_cast<const float2*>(roots), full_size, n, n_windows, fold);
  return static_cast<int>(cudaGetLastError());
}

// float64 stage sums above fft 8192 (see "Accuracy" above).
template <typename T>
int launch_acc(const void* re, const void* im, void* out, const void* starts,
               const void* weights, const void* window, const void* roots,
               int t, int full_size, int n, int n_windows, int fold,
               cudaStream_t stream) {
  if (n / N2 > F32_MAX_N1)
    return launch<T, double>(re, im, out, starts, weights, window, roots, t,
                             full_size, n, n_windows, fold, stream);
  return launch<T, float>(re, im, out, starts, weights, window, roots, t,
                          full_size, n, n_windows, fold, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Planes are (t, full_size)
// row-major, float32 or uint8 (is_u8); out is (t, n) float32.  Returns the
// CUDA error code of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int kspec_curscan_sublane(const void* re, const void* im, int is_u8,
                                     void* out, const void* starts,
                                     const void* weights, const void* window,
                                     const void* roots, int t, int full_size,
                                     int n, int n_windows, int fold,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8)
    return launch_acc<uint8_t>(re, im, out, starts, weights, window, roots,
                               t, full_size, n, n_windows, fold, s);
  return launch_acc<float>(re, im, out, starts, weights, window, roots, t,
                           full_size, n, n_windows, fold, s);
}
