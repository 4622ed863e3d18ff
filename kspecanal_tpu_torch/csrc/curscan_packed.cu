// Packed tiny-FFT curscan kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel_packed (the Pallas
// kernel for fft_size <= 128, entry curscan_fused_packed), the kernel of the
// quickFullScan preset (fft 64, 512-sample blocks, 71 windows at 90%
// overlap, 1226 bands a sweep).
//
// What it computes, per IQ block b of full_size samples:
//   for every window start s = starts[w] (any static offset):
//     X_w[k] = sum_j x[s + j] * D[j][k],   D[j][k] = win[j] * winAdj*2/N
//                                                    * exp(-2 pi i j k / N)
//              (window and scale folded into the DFT table, built in
//               float64 and rounded once; u8 planes decode as x - 127)
//     acc[k] = fold(acc[k], |X_w[k]|)   AVG/RAW: sum of weights[w] * |X_w|
//                                       (closed-form decay weights), MAX/MIN:
//                                       extrema
//   out[b][(k + N/2) % N] = acc[k]       natural order, fftshifted
//
// The Pallas body packs 128/N frames side by side in 128-lane rows, builds
// one lane-shifted view of the block per distinct start residue, folds slots
// with lane rolls and masks slots that hold no window.  All of that is
// Mosaic's layout, not math: here a misaligned start is an offset into
// shared memory and every slot holds a real window.
//
// What bounds it on the H100: the shared-memory loads of the direct DFT.
// A block costs W * N^2 complex multiply-adds (71 * 64^2 = 290 K, 1.2 M real
// FMA at quickFullScan) against 8 bytes/sample of f32 input read once: some
// 280 FMA per input byte, so HBM is far from binding.  Each multiply-add
// needs a table entry and a sample; with both in shared memory the loads,
// not the FMA pipes, set the pace.
//
// What the design does about it: one thread per output bin, THREADS / N IQ
// blocks per thread block.  The table (N*N float2) and the thread block's
// IQ blocks (staged once, decoded on the way in) live in shared memory; a
// thread walks the windows in order, WC at a time, so one table load feeds
// WC multiply-adds and the samples are warp-uniform broadcasts (N >= 32).
// The fold stays in a register, in window order: no atomics, deterministic.
//
// Shared memory: (N*N + (THREADS/N) * full_size) * 8 bytes; quickFullScan
// needs 49,152, fft 128 with 1024-sample blocks 147,456.  The wrapper
// refuses configs above the 232,448 a block may use
// (ops/cuda_packed.supports_fused_packed).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // threads per block: THREADS / N IQ blocks
constexpr int WC = 4;          // windows per pass over the table

enum Fold { FOLD_SUM = 0, FOLD_MAX = 1, FOLD_MIN = 2 };

__device__ __forceinline__ float sample(const float* p, size_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float sample(const uint8_t* p, size_t i) {
  return static_cast<float>(__ldg(p + i)) - 127.0f;
}

// acc += x * f (complex)
__device__ __forceinline__ void cmac(float2& acc, float2 x, float2 f) {
  acc.x = fmaf(x.x, f.x, fmaf(-x.y, f.y, acc.x));
  acc.y = fmaf(x.x, f.y, fmaf(x.y, f.x, acc.y));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
curscan_packed_kernel(const T* __restrict__ re, const T* __restrict__ im,
                      float* __restrict__ out,
                      const int* __restrict__ starts,
                      const float* __restrict__ weights,
                      const float2* __restrict__ table,
                      int t, int full_size, int n, int n_windows, int fold) {
  extern __shared__ float2 smem[];
  const int bpc = THREADS / n;     // IQ blocks of this thread block
  float2* dt = smem;               // dt[j * n + k]
  float2* x = dt + n * n;          // staged blocks, x[lb * full_size + m]
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * bpc;

  for (int i = tid; i < n * n; i += THREADS) dt[i] = table[i];
  for (int lb = 0; lb < bpc && b0 + lb < t; ++lb) {
    const size_t base = static_cast<size_t>(b0 + lb) * full_size;
    float2* xb = x + lb * full_size;
    for (int m = tid; m < full_size; m += THREADS)
      xb[m] = make_float2(sample(re, base + m), sample(im, base + m));
  }
  __syncthreads();

  const int lb = tid / n;
  const int k = tid % n;
  if (b0 + lb >= t) return;        // after the block's only barrier
  const float2* xb = x + lb * full_size;

  float acc = fold == FOLD_MAX ? -CUDART_INF_F
            : fold == FOLD_MIN ? CUDART_INF_F : 0.0f;
  for (int w0 = 0; w0 < n_windows; w0 += WC) {
    int s[WC];
    float2 X[WC];
#pragma unroll
    for (int q = 0; q < WC; ++q) {
      s[q] = starts[min(w0 + q, n_windows - 1)];
      X[q] = make_float2(0.0f, 0.0f);
    }
    for (int j = 0; j < n; ++j) {
      const float2 f = dt[j * n + k];
#pragma unroll
      for (int q = 0; q < WC; ++q) cmac(X[q], xb[s[q] + j], f);
    }
#pragma unroll
    for (int q = 0; q < WC; ++q) {
      const int w = w0 + q;
      if (w < n_windows) {
        const float mag = sqrtf(X[q].x * X[q].x + X[q].y * X[q].y);
        acc = fold == FOLD_SUM ? fmaf(weights[w], mag, acc)
            : fold == FOLD_MAX ? fmaxf(acc, mag) : fminf(acc, mag);
      }
    }
  }
  out[static_cast<size_t>(b0 + lb) * n + (k + n / 2) % n] = acc;
}

template <typename T>
int launch(const void* re, const void* im, void* out, const void* starts,
           const void* weights, const void* table, int t, int full_size,
           int n, int n_windows, int fold, cudaStream_t stream) {
  const int bpc = THREADS / n;
  const size_t smem =
      (static_cast<size_t>(n) * n + static_cast<size_t>(bpc) * full_size) *
      sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      curscan_packed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  curscan_packed_kernel<T><<<(t + bpc - 1) / bpc, THREADS, smem, stream>>>(
      static_cast<const T*>(re), static_cast<const T*>(im),
      static_cast<float*>(out), static_cast<const int*>(starts),
      static_cast<const float*>(weights), static_cast<const float2*>(table),
      t, full_size, n, n_windows, fold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  Planes are (t, full_size)
// row-major, float32 or uint8 (is_u8); out is (t, n) float32; table is the
// (n, n) complex64 window-folded DFT table.  Returns the CUDA error code of
// the launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int kspec_curscan_packed(const void* re, const void* im, int is_u8,
                                    void* out, const void* starts,
                                    const void* weights, const void* table,
                                    int t, int full_size, int n,
                                    int n_windows, int fold, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8)
    return launch<uint8_t>(re, im, out, starts, weights, table, t, full_size,
                           n, n_windows, fold, s);
  return launch<float>(re, im, out, starts, weights, table, t, full_size, n,
                       n_windows, fold, s);
}
