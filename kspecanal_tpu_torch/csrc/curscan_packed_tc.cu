// Tensor-core packed DFT curscan kernel (Kernel B) for NVIDIA Hopper
// (sm_90a): the HIGH and DEFAULT precision classes of K2.
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel_packed (:872, K2,
// entry curscan_fused_packed) at tpuPrecision HIGH and DEFAULT, for fft
// sizes 2-128 dividing 128 (quickFullScan runs 64).
//
// What it computes, per IQ block b and window start s = starts[w]:
//   X_w[k] = sum_j x[s + j] * Dt[j][k],   Dt[j][k] = W_n^(jk) win[j]
//            * winAdj*2/n (folded in float64 and rounded to float32 by the
//            wrapper, as _build_packed folds it)
//   acc[k] = fold(acc, weights[w] * |X_w[k]|)     float32, window order
//   out[b][(k + n/2) % n] = acc[k]
// The complex product is the 4M form at every class, as in JAX
// (Re = Xr Dr - Xi Di, Im = Xi Dr + Xr Di); each real product rounds its
// float32 operands to bf16 (to nearest even) and sums in float32 on
// mma.sync m16n8k16, once at DEFAULT and as the bf16x3 split at HIGH.  u8
// planes decode as x - 127 in the load, which is exact in bf16.
//
// The Pallas body packs 128/n frames side by side in 128-lane rows with one
// lane-shifted view of the block per start residue and a block-diagonal
// table.  That is Mosaic's layout: here a frame at any start is an address,
// and the product is (frames x n) (n x n) with frames on the M side.
//
// What bounds it on the H100: the planes read once (quickFullScan at
// T = 19616 reads 80 MB, 0.024 ms at 3.35 TB/s, against 8 n^2 flops a window
// for 4M, 0.002 ms at 989 TFLOP/s bf16; 3 times that at HIGH).
//
// What the design does about it (a right, simple first design):
//   * One thread block of 128 threads takes one IQ block and walks its
//     windows in chunks of at most 64 (the wrapper's chunk, a multiple of
//     16): the threads stage the chunk's frames (float32, u8 decoded) in
//     shared memory, rows of 16 KC + 8 floats (conflict-free float2
//     fragment loads; columns from n to 16 KC and windows past the last are
//     zero); each warp takes 16-window tiles, loads the table's B fragments
//     from global memory (pre-rounded, fragment order, 8 bytes a thread;
//     the table is at most 128 KB) and writes |X_w| to shared memory;
//     thread k then folds bin k over the chunk's windows in order.  Two
//     runs give identical bits.
//   * n is padded to 16 on K (zero table rows, zero frame columns) and to 8
//     on N (zero table columns), which is exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNK = 64;

enum Fold { FOLD_SUM = 0, FOLD_MAX = 1, FOLD_MIN = 2 };

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x0)))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(
                __float2bfloat16_rn(x1))) << 16);
}

template <bool HIGH>
__device__ __forceinline__ void operand(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo) {
  hi = pack(x0, x1);
  if (HIGH) {
    const float h0 = __uint_as_float(hi << 16);
    const float h1 = __uint_as_float(hi & 0xffff0000u);
    lo = pack(__fsub_rn(x0, h0), __fsub_rn(x1, h1));
  }
}

template <bool HIGH>
__device__ __forceinline__ void product(float (&big)[4], float (&small)[4],
                                        const uint32_t (&ahi)[4],
                                        const uint32_t (&alo)[4],
                                        const uint2& bhi, const uint2& blo) {
  mma(big, ahi, bhi.x, bhi.y);
  if (HIGH) {
    mma(small, ahi, blo.x, blo.y);
    mma(small, alo, bhi.x, bhi.y);
  }
}

template <bool HIGH>
__device__ __forceinline__ float value(const float (&big)[4],
                                       const float (&small)[4], int i) {
  return HIGH ? __fadd_rn(big[i], small[i]) : big[i];
}

template <typename T>
__device__ __forceinline__ float sample(const T* p, size_t i);
template <>
__device__ __forceinline__ float sample<float>(const float* p, size_t i) {
  return __ldg(p + i);
}
template <>
__device__ __forceinline__ float sample<uint8_t>(const uint8_t* p, size_t i) {
  return static_cast<float>(__ldg(p + i)) - 127.0f;
}

__device__ __forceinline__ float fold_op(int fold, float acc, float v) {
  return fold == FOLD_SUM ? __fadd_rn(acc, v)
         : fold == FOLD_MAX ? fmaxf(acc, v) : fminf(acc, v);
}

// Kernel B.  Grid: one thread block per IQ block.  KC = k-chunks of 16
// (n padded to 16 KC); dt holds the table's B fragments
// [slot][kc][nt][lane] (uint2), slots (re hi, re lo, im hi, im lo).
template <typename T, bool HIGH, int KC>
__global__ void __launch_bounds__(THREADS)
curscan_packed_tc_kernel(const T* __restrict__ re, const T* __restrict__ im,
                         float* __restrict__ out,
                         const int* __restrict__ starts,
                         const float* __restrict__ weights,
                         const uint2* __restrict__ dt, int full, int n,
                         int n_windows, int fold, int chunk) {
  constexpr int K = 16 * KC;
  constexpr int ROW = K + 8;
  extern __shared__ float smem[];
  float* fr = smem;                      // (chunk, ROW) frames, re
  float* fi = smem + chunk * ROW;        // im
  float* mags = smem + 2 * chunk * ROW;  // (chunk, n) |X_w|
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x;
  const int nt_count = (n + 7) / 8;
  const T* pre = re + static_cast<size_t>(b) * full;
  const T* pim = im + static_cast<size_t>(b) * full;
  float acc = 0.f;

  for (int c0 = 0; c0 < n_windows; c0 += chunk) {
    const int cw = min(chunk, n_windows - c0);
    for (int i = tid; i < chunk * K; i += THREADS) {
      const int wl = i / K, j = i % K;
      float vr = 0.f, vi = 0.f;
      if (wl < cw && j < n) {
        const int s = starts[c0 + wl];
        vr = sample(pre, s + j);
        vi = sample(pim, s + j);
      }
      fr[wl * ROW + j] = vr;
      fi[wl * ROW + j] = vi;
    }
    __syncthreads();
    for (int mt = warp; mt * 16 < cw; mt += WARPS) {
      for (int nt = 0; nt < nt_count; ++nt) {
        float big[4][4], small[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int i = 0; i < 4; ++i) big[p][i] = small[p][i] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t xh[2][4], xl[2][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {   // a0..a3: (g, 2t), (g+8, 2t),
            const int row = mt * 16 + g8 + (q & 1) * 8;   // (g, 2t+8), ...
            const int c = kc * 16 + 2 * t4 + (q >> 1) * 8;
            const float2 pr = *reinterpret_cast<const float2*>(
                fr + row * ROW + c);
            const float2 pi = *reinterpret_cast<const float2*>(
                fi + row * ROW + c);
            operand<HIGH>(pr.x, pr.y, xh[0][q], xl[0][q]);
            operand<HIGH>(pi.x, pi.y, xh[1][q], xl[1][q]);
          }
          const int base = (kc * nt_count + nt) * 32 + lane;
          const int slot = KC * nt_count * 32;
          const uint2 rh = __ldg(dt + base), ih = __ldg(dt + 2 * slot + base);
          uint2 rl = rh, il = ih;
          if (HIGH) {
            rl = __ldg(dt + slot + base);
            il = __ldg(dt + 3 * slot + base);
          }
          // Xr Dr, Xi Di, Xi Dr, Xr Di
          product<HIGH>(big[0], small[0], xh[0], xl[0], rh, rl);
          product<HIGH>(big[1], small[1], xh[1], xl[1], ih, il);
          product<HIGH>(big[2], small[2], xh[1], xl[1], rh, rl);
          product<HIGH>(big[3], small[3], xh[0], xl[0], ih, il);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = mt * 16 + g8 + (i >> 1) * 8;
          const int k = nt * 8 + 2 * t4 + (i & 1);
          const float xr = __fsub_rn(value<HIGH>(big[0], small[0], i),
                                     value<HIGH>(big[1], small[1], i));
          const float xi = __fadd_rn(value<HIGH>(big[2], small[2], i),
                                     value<HIGH>(big[3], small[3], i));
          if (row < cw && k < n)
            mags[row * n + k] = __fsqrt_rn(
                __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi)));
        }
      }
    }
    __syncthreads();
    if (tid < n) {
      for (int wl = 0; wl < cw; ++wl) {
        const float v = __fmul_rn(weights[c0 + wl], mags[wl * n + tid]);
        acc = (c0 + wl == 0) ? v : fold_op(fold, acc, v);
      }
    }
    __syncthreads();
  }
  if (tid < n) out[static_cast<size_t>(b) * n + (tid + n / 2) % n] = acc;
}

template <typename T, bool HIGH, int KC>
int launch(const void* re, const void* im, void* out, const void* starts,
           const void* weights, const void* dt, int t, int full, int n,
           int n_windows, int fold, int chunk, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(chunk) *
                      (2 * (16 * KC + 8) + n) * sizeof(float);
  if (smem > 48 * 1024) {        // above the default only on request
    const cudaError_t err = cudaFuncSetAttribute(
        curscan_packed_tc_kernel<T, HIGH, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  curscan_packed_tc_kernel<T, HIGH, KC><<<t, THREADS, smem, stream>>>(
      static_cast<const T*>(re), static_cast<const T*>(im),
      static_cast<float*>(out), static_cast<const int*>(starts),
      static_cast<const float*>(weights), static_cast<const uint2*>(dt),
      full, n, n_windows, fold, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool HIGH>
int dispatch(const void* re, const void* im, void* out, const void* starts,
             const void* weights, const void* dt, int t, int full, int n,
             int n_windows, int fold, int chunk, cudaStream_t s) {
#define KSPEC_PTC(KC)                                                       \
  launch<T, HIGH, KC>(re, im, out, starts, weights, dt, t, full, n,        \
                      n_windows, fold, chunk, s)
  switch (n) {
    case 2: case 4: case 8: case 16: return KSPEC_PTC(1);
    case 32: return KSPEC_PTC(2);
    case 64: return KSPEC_PTC(4);
    case 128: return KSPEC_PTC(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KSPEC_PTC
}

}  // namespace

// Plain C entry point (bound with ctypes).  Planes are (t, full) row-major,
// float32 or uint8 (is_u8); out is (t, n) float32; starts (n_windows,)
// int32, weights (n_windows,) float32 (decay weights, ones for MAX/MIN);
// dt the fragment-ordered table of ops/cuda_tc.packed_tc_tables; precision 0
// DEFAULT, 1 HIGH; chunk the windows staged at once (a multiple of 16, at
// most 64).  Returns the CUDA error code of the launch (0 on success); the
// kernel runs asynchronously on `stream`.
extern "C" int kspec_curscan_packed_tc(const void* re, const void* im,
                                       int is_u8, void* out,
                                       const void* starts,
                                       const void* weights, const void* dt,
                                       int t, int full, int n, int n_windows,
                                       int fold, int precision, int chunk,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 16 || chunk > MAX_CHUNK || chunk % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_u8)
    return precision
        ? dispatch<uint8_t, true>(re, im, out, starts, weights, dt, t, full,
                                  n, n_windows, fold, chunk, s)
        : dispatch<uint8_t, false>(re, im, out, starts, weights, dt, t, full,
                                   n, n_windows, fold, chunk, s);
  return precision
      ? dispatch<float, true>(re, im, out, starts, weights, dt, t, full, n,
                              n_windows, fold, chunk, s)
      : dispatch<float, false>(re, im, out, starts, weights, dt, t, full, n,
                               n_windows, fold, chunk, s);
}
