// Packed tiny-FFT curscan kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel_packed (:872, the
// Pallas kernel for fft_size <= 128 dividing 128, entry
// curscan_fused_packed), the kernel of the quickFullScan preset (fft 64,
// 512-sample blocks, 71 windows at 90% overlap, 1226 bands a sweep).
//
// What it computes, per IQ block b of full_size samples:
//   for every window start s = starts[w] (any offset, non-decreasing):
//     X_w = DFT_N(x[s : s+N] * ws),   ws[j] = win[j] * winAdj*2/N
//           (ws and the twiddles built in float64; u8 planes decode as
//            x - 127 when read)
//     acc[k] = fold(acc[k], |X_w[k]|)   AVG/RAW: sum of weights[w] * |X_w|
//                                       (closed-form decay weights),
//                                       MAX/MIN: extrema
//   out[b][(k + N/2) % N] = acc[k]       natural order, fftshifted
//
// The Pallas body packs 128/N frames side by side in 128-lane rows, builds
// one lane-shifted view of the block per start residue and runs a
// block-diagonal DFT dot on the MXU.  That is Mosaic's layout, not math:
// here a misaligned start is an offset into shared memory.
//
// What bounds it on the H100: operations.  quickFullScan at T=19616 needs
// 19616 * 71 windows of 5 N log2 N + 4 N = 2,176 flops: 3.03 GFLOP, 0.045
// ms at 67 TFLOP/s, against 85 MB of float32 planes read once, 0.025 ms at
// 3.35 TB/s.  A direct DFT does N^2 complex multiply-adds a window, 15 times
// the FFT's work at N = 64.
//
// What the design does about it:
//   * An FFT in registers.  A window's N = P * L points are split over a
//     group of L lanes with P points each (P = N for N <= 16, 8 x 4 lanes at
//     32, 8 x 8 at 64, 16 x 8 at 128).  Lane j1 holds x[j1 + L*j2], j2 < P,
//     and runs a radix-2 P-point FFT on them in registers; a twiddle
//     W_N^(j1*k1) follows; the L-point DFT across the lanes is log2(L)
//     radix-2 passes, each exchanging half of the registers with the
//     partner lane by __shfl_xor_sync (a lane bit and a register bit trade
//     places): no shared memory and no barrier.  Bin k = k1 + P*k2 of
//     register r in lane j1 is fixed (bin_of), so each lane folds its P bins
//     in registers.  The N-point window and twiddle tables sit in shared
//     memory (3 KiB at N = 128).
//   * Why float64, though N <= 128 takes at most 7 passes: float32 rounding
//     is set by the frame's energy, while a MIN fold over hundreds of
//     windows ends far below it.  At fft 64 with 951 windows a float32
//     version of this kernel reached 1.10 of the per-bin bound (5e-5 of the
//     bin plus 1e-6 of the peak) against the plain version run in float64,
//     and the float32 torch.fft chain 1.19.  So the window, the twiddles
//     (one entry of the N-point float64 table each), the passes, the
//     exchanges and |X|^2 are float64; |X| is sqrtf of |X|^2 rounded to
//     float32, and the folds are float32.  The H100 runs float64 at half the
//     float32 rate, which moves the bound from the FFT's flops towards the
//     shuffles and loads around them.
//   * The fold in registers, in a fixed order.  G lane groups share an IQ
//     block; group g takes windows w = g, g + G, ... in window order and
//     folds them; the G partial folds meet in shared memory and are combined
//     in group order.  No atomics: two runs give identical bits.
//   * No size limit.  The thread block walks its IQ blocks' windows in
//     chunks of C windows; a chunk's span (last start - first start + N
//     samples, widened to 16 bytes) is staged with cp.async, double-buffered
//     when there is more than one chunk; u8 planes are staged as bytes.
//     The wrapper (ops/cuda_packed.launch_plan) picks G and C from T and the
//     window count: enough groups to fill the card at the serial
//     quickFullScan's T = 1226 (G = 32, one IQ block a thread block), several
//     IQ blocks a thread block at catch-up's T = 19616 (G = 4, 8 blocks).
//     Shared memory stays near 80 KiB at most, whatever full_size is.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // threads of one thread block

enum Fold { FOLD_SUM = 0, FOLD_MAX = 1, FOLD_MIN = 2 };

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

__host__ __device__ constexpr int bitrev(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((x >> i) & 1);
  return r;
}

__device__ __forceinline__ double decode(float x) { return x; }

__device__ __forceinline__ double decode(uint8_t x) {
  return static_cast<double>(x) - 127.0;
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float fold1(int fold, float acc, float x) {
  return fold == FOLD_SUM ? acc + x
       : fold == FOLD_MAX ? fmaxf(acc, x) : fminf(acc, x);
}

// Radix-2 decimation-in-frequency FFT of the P registers: v[r] ends as
// Y[bitrev(r)].  W_P^m = tw[m * L]; m = 0 and m = P/4 (-i) are exact.
template <int P, int L>
__device__ __forceinline__ void fft_regs(double2 (&v)[P],
                                         const double2* tw) {
  constexpr int LP = ilog2(P);
#pragma unroll
  for (int s = 0; s < LP; ++s) {
    const int half = P >> (s + 1);
#pragma unroll
    for (int blk = 0; blk < P; blk += 2 * half) {
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const double2 a = v[blk + i], b = v[blk + i + half];
        v[blk + i] = make_double2(a.x + b.x, a.y + b.y);
        const double2 d = make_double2(a.x - b.x, a.y - b.y);
        const int m = i * (P / (2 * half));
        v[blk + i + half] = m == 0 ? d
                          : 4 * m == P ? make_double2(d.y, -d.x)
                          : cmul(d, tw[m * L]);
      }
    }
  }
}

// The L-point DFT across the group's lanes, radix 2, decimation in
// frequency: pass s pairs lane bit h = L >> (s+1) with register bit
// p = P >> (s+1).  Each lane sends the half of its registers its partner
// needs and keeps the other half, so both end up with whole butterflies
// (a, b): the low lane keeps a and receives b, the high lane the reverse.
// Both store a + b = own + recv in register r and
// (a - b) * W_2h^(lane mod h) = (own - recv) * sgn * W in register r | p,
// sgn = -1 in the high lane: the lane bit and the register bit trade places
// (bin_of tracks them).  W = tw[(lane mod h) * N/(2h)].
template <int P, int L>
__device__ __forceinline__ void cross_lanes(double2 (&v)[P],
                                            const double2* tw, int lane,
                                            unsigned mask) {
  constexpr int LL = ilog2(L);
#pragma unroll
  for (int s = 0; s < LL; ++s) {
    const int h = L >> (s + 1);
    const int p = P >> (s + 1);
    const bool hi = lane & h;
    const double sgn = hi ? -1.0 : 1.0;
    double2 w = make_double2(sgn, 0.0);
    if (h > 1) {
      w = tw[(lane % h) * (P * L / (2 * h))];
      w = make_double2(w.x * sgn, w.y * sgn);
    }
#pragma unroll
    for (int r = 0; r < P; ++r) {
      if (r & p) continue;
      const double2 own = hi ? v[r | p] : v[r];
      const double2 send = hi ? v[r] : v[r | p];
      const double2 recv = make_double2(__shfl_xor_sync(mask, send.x, h),
                                        __shfl_xor_sync(mask, send.y, h));
      v[r] = make_double2(own.x + recv.x, own.y + recv.y);
      const double2 d = make_double2(own.x - recv.x, own.y - recv.y);
      v[r | p] = h > 1 ? cmul(d, w) : make_double2(d.x * sgn, d.y * sgn);
    }
  }
}

// The bin that register r of lane `lane` holds after the passes.
template <int P, int L>
__device__ __forceinline__ int bin_of(int r, int lane) {
  constexpr int LP = ilog2(P), LL = ilog2(L);
  int pos = 0, rk = r;
#pragma unroll
  for (int s = 0; s < LL; ++s) {
    const int h = L >> (s + 1), p = P >> (s + 1);
    rk &= ~p;
    if (r & p) pos |= h;
    if (lane & h) rk |= p;
  }
  return bitrev(rk, LP) + P * bitrev(pos, LL);
}

// Stage chunk c of every IQ block of the thread block: the samples
// [a0, a1) of both planes, 16 bytes a copy, into buffer `dst`
// ((blocks, 2, stride) samples).
template <typename T, int N>
__device__ __forceinline__ void stage_chunk(
    T* dst, const T* __restrict__ re, const T* __restrict__ im,
    const int* __restrict__ starts, int c, int chunk, int n_windows,
    int blocks, int b0, int t, int full_size, int stride) {
  constexpr int ALIGN = 16 / sizeof(T);
  const int a0 = starts[c * chunk] / ALIGN * ALIGN;
  const int last = starts[min(n_windows, (c + 1) * chunk) - 1];
  const int pieces = ((last + N + ALIGN - 1) / ALIGN * ALIGN - a0) / ALIGN;
  for (int i = threadIdx.x; i < blocks * 2 * pieces; i += THREADS) {
    const int q = i % pieces, row = i / pieces;      // row = 2 * lb + plane
    const int b = b0 + row / 2;
    if (b >= t) continue;
    const T* src = (row % 2 ? im : re) + static_cast<size_t>(b) * full_size
                   + a0 + q * ALIGN;
    __pipeline_memcpy_async(dst + row * stride + q * ALIGN, src, 16);
  }
  __pipeline_commit();
}

// At most 64 registers for P <= 8 (four blocks an SM): 0.406 against
// 0.465 ms with the 89 ptxas picks unbounded, quickFullScan at T=19616
// (NVIDIA H100 80GB HBM3, 700 W).  P = 16 keeps its registers.
template <typename T, int P, int L>
__global__ void __launch_bounds__(THREADS, P <= 8 ? 4 : 1)
curscan_packed_kernel(const T* __restrict__ re, const T* __restrict__ im,
                      float* __restrict__ out,
                      const int* __restrict__ starts,
                      const float* __restrict__ weights,
                      const double* __restrict__ wscale,
                      const double2* __restrict__ tw,
                      int t, int full_size, int n_windows, int fold,
                      int groups, int chunk, int n_chunks, int stride) {
  constexpr int N = P * L;
  constexpr int ALIGN = 16 / sizeof(T);
  constexpr int LP = ilog2(P);
  extern __shared__ __align__(16) unsigned char smem[];
  const int blocks = THREADS / L / groups;     // IQ blocks of this block
  const int buf_elems = blocks * 2 * stride;
  // Shared memory: the twiddles and the window, the staged chunks, the
  // partial folds.
  double2* tws = reinterpret_cast<double2*>(smem);
  double* wss = reinterpret_cast<double*>(tws + N);
  T* stage = reinterpret_cast<T*>(wss + N);
  float* comb = reinterpret_cast<float*>(
      stage + (n_chunks > 1 ? 2 : 1) * buf_elems);

  const int lane = threadIdx.x % L;            // lane within the group
  const int gi = threadIdx.x / L;              // group within the block
  const int lb = gi / groups;                  // its IQ block
  const int g = gi % groups;                   // its share of the windows
  const int b0 = blockIdx.x * blocks;
  const bool live = b0 + lb < t;
  const unsigned mask = (L == 1 ? 1u : (1u << L) - 1u)
                        << ((threadIdx.x % 32) / L * L);

  for (int i = threadIdx.x; i < N; i += THREADS) {
    tws[i] = tw[i];
    wss[i] = wscale[i];
  }
  float acc[P];
#pragma unroll
  for (int r = 0; r < P; ++r)
    acc[r] = fold == FOLD_MAX ? -CUDART_INF_F
           : fold == FOLD_MIN ? CUDART_INF_F : 0.0f;

  stage_chunk<T, N>(stage, re, im, starts, 0, chunk, n_windows, blocks, b0,
                    t, full_size, stride);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage_chunk<T, N>(stage + ((c + 1) & 1) * buf_elems, re, im, starts,
                        c + 1, chunk, n_windows, blocks, b0, t, full_size,
                        stride);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (live) {
      const T* xr = stage + (c & 1) * buf_elems + lb * 2 * stride;
      const T* xi = xr + stride;
      const int a0 = starts[c * chunk] / ALIGN * ALIGN;
      const int w_end = min(n_windows, (c + 1) * chunk);
      for (int w = c * chunk + g; w < w_end; w += groups) {
        const int off = starts[w] - a0 + lane;
        double2 v[P];
#pragma unroll
        for (int r = 0; r < P; ++r) {
          const double ws = wss[lane + L * r];
          v[r] = make_double2(decode(xr[off + L * r]) * ws,
                              decode(xi[off + L * r]) * ws);
        }
        fft_regs<P, L>(v, tws);
        if (L > 1) {                      // W_N^(lane * k1)
#pragma unroll
          for (int r = 1; r < P; ++r)
            v[r] = cmul(v[r], tws[(lane * bitrev(r, LP)) % N]);
        }
        cross_lanes<P, L>(v, tws, lane, mask);
        const float wt = weights[w];
#pragma unroll
        for (int r = 0; r < P; ++r) {
          const float mag = sqrtf(__double2float_rn(v[r].x * v[r].x +
                                                    v[r].y * v[r].y));
          acc[r] = fold == FOLD_SUM ? fmaf(wt, mag, acc[r])
                 : fold == FOLD_MAX ? fmaxf(acc[r], mag)
                                    : fminf(acc[r], mag);
        }
      }
    }
    if (c + 1 < n_chunks) __syncthreads();     // the buffer is refilled next
  }

  // The partial folds of the IQ block's groups, combined in group order.
#pragma unroll
  for (int r = 0; r < P; ++r)
    comb[gi * N + bin_of<P, L>(r, lane)] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < blocks * N; i += THREADS) {
    const int bb = i / N, k = i % N;
    if (b0 + bb >= t) continue;
    const float* part = comb + bb * groups * N + k;
    float a = part[0];
    for (int q = 1; q < groups; ++q) a = fold1(fold, a, part[q * N]);
    out[static_cast<size_t>(b0 + bb) * N + (k + N / 2) % N] = a;
  }
}

template <typename T, int P, int L>
int launch(const void* re, const void* im, void* out, const void* starts,
           const void* weights, const void* wscale, const void* tw, int t,
           int full_size, int n_windows, int fold, int groups, int chunk,
           int n_chunks, int stride, cudaStream_t stream) {
  const int blocks = THREADS / L / groups;
  const size_t smem =
      static_cast<size_t>(P) * L * (sizeof(double2) + sizeof(double)) +
      (n_chunks > 1 ? 2 : 1) * static_cast<size_t>(blocks) * 2 * stride *
          sizeof(T) +
      static_cast<size_t>(THREADS) * P * sizeof(float);
  if (smem > 48 * 1024) {        // above the default only on request
    const cudaError_t err = cudaFuncSetAttribute(
        curscan_packed_kernel<T, P, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  curscan_packed_kernel<T, P, L>
      <<<(t + blocks - 1) / blocks, THREADS, smem, stream>>>(
          static_cast<const T*>(re), static_cast<const T*>(im),
          static_cast<float*>(out), static_cast<const int*>(starts),
          static_cast<const float*>(weights),
          static_cast<const double*>(wscale), static_cast<const double2*>(tw),
          t, full_size, n_windows, fold, groups, chunk, n_chunks, stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int n, const void* re, const void* im, void* out,
             const void* starts, const void* weights, const void* wscale,
             const void* tw, int t, int full_size, int n_windows, int fold,
             int groups, int chunk, int n_chunks, int stride,
             cudaStream_t s) {
#define KSPEC_PACKED(P, L)                                                  \
  launch<T, P, L>(re, im, out, starts, weights, wscale, tw, t, full_size,  \
                  n_windows, fold, groups, chunk, n_chunks, stride, s)
  switch (n) {
    case 2: return KSPEC_PACKED(2, 1);
    case 4: return KSPEC_PACKED(4, 1);
    case 8: return KSPEC_PACKED(8, 1);
    case 16: return KSPEC_PACKED(16, 1);
    case 32: return KSPEC_PACKED(8, 4);
    case 64: return KSPEC_PACKED(8, 8);
    case 128: return KSPEC_PACKED(16, 8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KSPEC_PACKED
}

}  // namespace

// Plain C entry point (bound with ctypes).  Planes are (t, full_size)
// row-major, float32 or uint8 (is_u8), 16-byte aligned; out is (t, n)
// float32; wscale is the (n,) float64 window times winAdj*2/n, tw the (n,)
// complex128 table W_n^m; groups, chunk, n_chunks and stride come from
// ops/cuda_packed.launch_plan.  Returns the CUDA error code of the launch
// (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int kspec_curscan_packed(const void* re, const void* im, int is_u8,
                                    void* out, const void* starts,
                                    const void* weights, const void* wscale,
                                    const void* tw, int t, int full_size,
                                    int n, int n_windows, int fold,
                                    int groups, int chunk, int n_chunks,
                                    int stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8)
    return dispatch<uint8_t>(n, re, im, out, starts, weights, wscale, tw, t,
                             full_size, n_windows, fold, groups, chunk,
                             n_chunks, stride, s);
  return dispatch<float>(n, re, im, out, starts, weights, wscale, tw, t,
                         full_size, n_windows, fold, groups, chunk, n_chunks,
                         stride, s);
}
