// Tensor-core two-stage DFT curscan for any split n = n1 * n2 (Kernel C) for
// NVIDIA Hopper (sm_90a): the HIGH and DEFAULT precision classes of K1 above
// fft 16384 and of K3 on every split.  Device code, instantiated by
// curscan_tc_split.cu (DEFAULT, and the C entry points) and
// curscan_tc_split_high.cu (HIGH): two nvcc runs in parallel.
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel (:116, K3, entry
// curscan_fused, split _factorize(n)) and ::_kernel_sublane (:423, K1, entry
// curscan_fused_sublane, split (n / 128, 128)) at tpuPrecision HIGH and
// DEFAULT, wherever the JAX dispatcher picks them and Kernel A
// (curscan_tc.cuh: the sublane split up to fft 16384) does not take the
// config.  The wrapper (ops/cuda_tc.curscan_tc_split) passes the split that
// the JAX dispatcher's _fused_choice takes (ops/cuda_curscan.tc_split).
//
// What it computes, per IQ block b and window start s = starts[w]:
//   A[m1][m2] = win[n2 m1 + m2] * x[s + n2 m1 + m2]      float32
//   B = F1 A          stage 1, F1[k1][m1] = W_n1^(k1 m1)
//   C = B o T         twiddle in float32, T[k1][m2] = W_n^(k1 m2)
//   D = C F2^T        stage 2, F2[k2][m2] = W_n2^(k2 m2)
//   acc[k1][k2] = fold(acc, weights[w] * |D[k1][k2]|)   float32, window order
//   out[b][(k1 + n1 k2 + n/2) % n] = acc[k1][k2]
// with the rounding of Kernel A: every real product rounds its operands to
// bf16 (to nearest even) and sums in float32 on mma.sync m16n8k16, once at
// DEFAULT and as the bf16x3 split at HIGH; the complex products in the 3M or
// 4M form (curscan_tc_common.cuh, Acc); each operand (the windowed frame,
// C) rounded once from its float32 value; the element-wise steps with the
// _rn intrinsics, so each rounds where the plain version
// (ops/cuda_tc.curscan_tc_split_plain) rounds.
//
// The Pallas bodies frame by n2-aligned rows (lane kernel) or rotate lanes
// (sublane kernel) and run block-diagonal dots on the MXU: Mosaic's layouts.
// Here a window start is an address and every sample is loaded on its own,
// so any n2 (odd too: 41 at fft 2050, 199 at fft 39800) and any start work.
//
// What bounds it on the H100: operations (4 products of 2 n1 n2 (n1 + n2)
// flops a window at 4M, times 3 at HIGH, at 989 TFLOP/s bf16), or at few
// windows the planes read once.
//
// What the design does about it (a first design, right before fast):
//   * A thread block takes one IQ block and MT m-tiles of 16 rows k1 (a
//     k1 tile; rows are independent through stage 2 and the fold), 256
//     threads, and walks all windows in order.  F1 does not fit in shared
//     memory from n1 = 256 on, so no table is staged: each warp reads F1's
//     A fragments (the wrapper's fragment-ordered table, as Kernel A's) and
//     F2^T's B fragments from L2 as it needs them.
//   * Stage 1 by column strips of 8: warp j % 8 takes strip j for the
//     block's MT m-tiles over all n1 (k-chunks of 16).  Each lane loads the
//     4 frame samples of its B fragment straight from the planes (u8
//     decoded in the load), windows and rounds them: every frame element is
//     loaded and rounded once a block.  The twiddled C is rounded once into
//     bf16 operand planes in shared memory (forms re, im, and at 3M re + im;
//     hi, and at HIGH lo), rows of n2p + 8 bf16.
//   * Stage 2 by output column strips: warp j % 8 takes k2-strip j for the
//     MT m-tiles, C's A fragments read from the planes by 32-bit loads,
//     F2^T's from L2; |D| weighted and folded by the one lane that owns
//     each element, in the output row in device memory, already fftshifted,
//     window by window in order.  Two barriers a window.
//   * n1 and n2 are padded to 16 with zero rows and columns of F1, F2^T and
//     the twiddles (exact); padded rows and columns are never stored.
//   * MT (1, 2 or 4 m-tiles; 4 at DEFAULT only) is the largest whose planes
//     fit a block's shared memory (pick_mt): the planes take forms x halves
//     x 16 MT x (n2p + 8) x 2 bytes, so n2p reaches 1200 at 3M HIGH, 1808 at
//     HIGH and 3616 at DEFAULT (lane splits of fft 1.4M, 3.2M and 13M).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "curscan_tc_common.cuh"

namespace kspec_tcs {

using kspec_tc::Acc;
using kspec_tc::fold_op;
using kspec_tc::operand;
using kspec_tc::sample;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr size_t SMEM_LIMIT = 232448;   // a block's shared memory (H100)

__host__ __device__ inline int pad16(int x) { return (x + 15) & ~15; }

// Bytes of a block's C planes: forms x halves planes of 16 mt rows of
// n2p + 8 bf16.
inline size_t smem_bytes(int n2, int mt, bool high, bool tm) {
  return static_cast<size_t>(tm ? 3 : 2) * (high ? 2 : 1) * 16 * mt *
         (pad16(n2) + 8) * 2;
}

// The m-tiles a block: the largest of 4 (DEFAULT only; HIGH's four tiles of
// accumulators would spill), 2 and 1 whose planes fit, halved while half
// still covers n1's m-tiles; 0 where none fits.
inline int pick_mt(int n1, int n2, bool high, bool tm) {
  int mt = high ? 2 : 4;
  while (mt >= 1 && smem_bytes(n2, mt, high, tm) > SMEM_LIMIT) mt /= 2;
  while (mt > 1 && mt / 2 >= pad16(n1) / 16) mt /= 2;
  return mt;
}

// Kernel C.  Grid: t * tiles thread blocks, tiles = ceil(n1p / (16 MT));
// block (b, tile) computes rows k1 of m-tiles tile*MT .. for IQ block b.  f1
// holds F1's A fragments [slot][mt][kc][lane] (uint4; n1p/16 squared tiles),
// f2 F2^T's B fragments [slot][kc][nt][lane] (uint2; n2p/16 x n2p/8 tiles),
// slot = 2 * form + half (form re, im, re + im); tw the (n1p, n2p) twiddles,
// zero outside (n1, n2).
template <typename T, bool HIGH, bool TM, int MT>
__global__ void __launch_bounds__(THREADS, 1)
curscan_tc_split_kernel(const T* __restrict__ re, const T* __restrict__ im,
                        float* __restrict__ out,
                        const int* __restrict__ starts,
                        const float* __restrict__ weights,
                        const float* __restrict__ window,
                        const uint4* __restrict__ f1,
                        const uint2* __restrict__ f2,
                        const float2* __restrict__ tw, int full, int n, int n1,
                        int n2, int n_windows, int fold) {
  constexpr int H = HIGH ? 2 : 1;
  constexpr int FH = (TM ? 3 : 2) * H;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* cw = reinterpret_cast<uint32_t*>(smem);   // C's planes, words
  const int n1p = pad16(n1), n2p = pad16(n2);
  const int nmt = n1p / 16;            // m-tiles of k1, k-chunks of stage 1
  const int tiles = (nmt + MT - 1) / MT;
  const int rw = (n2p + 8) / 2;        // a plane's row stride in words
  const int ps = 16 * MT * rw;         // a plane's words
  const int strips = n2p / 8;          // column strips of 8 (m2, then k2)
  const int kc2 = n2p / 16;            // stage 2's k-chunks
  const int f1n = nmt * nmt * 32;      // uint4s of one F1 slot
  const int f2n = kc2 * strips * 32;   // uint2s of one F2^T slot
  const int b = blockIdx.x / tiles;
  const int mt0 = (blockIdx.x % tiles) * MT;   // the block's first m-tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const T* pre = re + static_cast<size_t>(b) * full;
  const T* pim = im + static_cast<size_t>(b) * full;
  float* dst = out + static_cast<size_t>(b) * n;

  for (int w = 0; w < n_windows; ++w) {
    const T* xr = pre + starts[w];
    const T* xi = pim + starts[w];

    // Stage 1: B = F1 A over strip j of the block's m-tiles; C = B o T.
    for (int j = warp; j < strips; j += WARPS) {
      Acc<TM> a[MT];
#pragma unroll
      for (int u = 0; u < MT; ++u) a[u].zero();
      const int m2 = j * 8 + g8;       // this lane's B-fragment column
      for (int kc = 0; kc < nmt; ++kc) {
        // The B fragment's rows m1 = kc*16 + 2t, 2t+1 (b0), 2t+8, 2t+9 (b1).
        float vr[4], vi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m1 = kc * 16 + 2 * t4 + (e & 1) + (e >> 1) * 8;
          vr[e] = vi[e] = 0.f;
          if (m1 < n1 && m2 < n2) {
            const int o = m1 * n2 + m2;
            const float wv = __ldg(window + o);
            vr[e] = __fmul_rn(sample(xr, o), wv);
            vi[e] = __fmul_rn(sample(xi, o), wv);
          }
        }
        uint32_t x[3][2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          operand<HIGH>(vr[2 * h], vr[2 * h + 1], x[0][0][h], x[0][1][h]);
          operand<HIGH>(vi[2 * h], vi[2 * h + 1], x[1][0][h], x[1][1][h]);
          if (TM)
            operand<HIGH>(__fadd_rn(vr[2 * h], vi[2 * h]),
                          __fadd_rn(vr[2 * h + 1], vi[2 * h + 1]),
                          x[2][0][h], x[2][1][h]);
        }
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          const int m = mt0 + u;
          if (m < nmt) {
            uint32_t f[3][2][4];
            const int i = (m * nmt + kc) * 32 + lane;
#pragma unroll
            for (int q = 0; q < FH; ++q) {
              const uint4 v = __ldg(f1 + (2 * (q / H) + q % H) * f1n + i);
              f[q / H][q % H][0] = v.x; f[q / H][q % H][1] = v.y;
              f[q / H][q % H][2] = v.z; f[q / H][q % H][3] = v.w;
            }
            a[u].template products<HIGH>(f, x);
          }
        }
      }
      // C = B o T in float32; its operands (word (row, column pair)) into
      // every plane: plane q = form * H + half.
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        if (mt0 + u >= nmt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = u * 16 + g8 + h * 8;           // the block's row
          const int k1 = (mt0 + u) * 16 + g8 + h * 8;
          float cr[2], ci[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float br, bi;
            a[u].template complex<HIGH>(2 * h + e, br, bi);
            const float2 t = __ldg(tw + static_cast<size_t>(k1) * n2p +
                                   j * 8 + 2 * t4 + e);
            cr[e] = __fsub_rn(__fmul_rn(br, t.x), __fmul_rn(bi, t.y));
            ci[e] = __fadd_rn(__fmul_rn(br, t.y), __fmul_rn(bi, t.x));
          }
          const int o = r * rw + j * 4 + t4;
          uint32_t hi, lo;
          operand<HIGH>(cr[0], cr[1], hi, lo);
          cw[o] = hi;
          if (HIGH) cw[ps + o] = lo;
          operand<HIGH>(ci[0], ci[1], hi, lo);
          cw[H * ps + o] = hi;
          if (HIGH) cw[(H + 1) * ps + o] = lo;
          if (TM) {
            operand<HIGH>(__fadd_rn(cr[0], ci[0]), __fadd_rn(cr[1], ci[1]),
                          hi, lo);
            cw[2 * H * ps + o] = hi;
            if (HIGH) cw[(2 * H + 1) * ps + o] = lo;
          }
        }
      }
    }
    __syncthreads();

    // Stage 2: D = C F2^T over k2-strip j of the block's m-tiles; |D|
    // weighted and folded into the output row, fftshifted.
    const float wgt = weights[w];
    for (int j = warp; j < strips; j += WARPS) {
      Acc<TM> a[MT];
#pragma unroll
      for (int u = 0; u < MT; ++u) a[u].zero();
      for (int kc = 0; kc < kc2; ++kc) {
        uint32_t fb[3][2][2];
#pragma unroll
        for (int q = 0; q < FH; ++q) {
          const uint2 v = __ldg(f2 + (2 * (q / H) + q % H) * f2n +
                                (kc * strips + j) * 32 + lane);
          fb[q / H][q % H][0] = v.x;
          fb[q / H][q % H][1] = v.y;
        }
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          if (mt0 + u < nmt) {
            // A fragment of rows u*16.., columns kc*16..: a0 (g, 2t), a1
            // (g + 8, 2t), a2 (g, 2t + 8), a3 (g + 8, 2t + 8).
            const int o = (u * 16 + g8) * rw + kc * 8 + t4;
            uint32_t c[3][2][4];
#pragma unroll
            for (int q = 0; q < FH; ++q) {
              const uint32_t* p = cw + q * ps + o;
              c[q / H][q % H][0] = p[0];
              c[q / H][q % H][1] = p[8 * rw];
              c[q / H][q % H][2] = p[4];
              c[q / H][q % H][3] = p[8 * rw + 4];
            }
            a[u].template products<HIGH>(c, fb);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < MT; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k1 = (mt0 + u) * 16 + g8 + (i >> 1) * 8;
          const int k2 = j * 8 + 2 * t4 + (i & 1);
          if (k1 < n1 && k2 < n2) {
            float dr, di;
            a[u].template complex<HIGH>(i, dr, di);
            const float v = __fmul_rn(
                wgt, __fsqrt_rn(__fadd_rn(__fmul_rn(dr, dr),
                                          __fmul_rn(di, di))));
            float* p = dst + (k1 + n1 * k2 + n / 2) % n;
            *p = w == 0 ? v : fold_op(fold, *p, v);
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool HIGH, bool TM, int MT>
int launch_one(const void* re, const void* im, void* out, const void* starts,
               const void* weights, const void* window, const void* f1,
               const void* f2, const void* tw, int t, int full, int n,
               int n1, int n2, int n_windows, int fold, cudaStream_t stream) {
  const size_t smem = smem_bytes(n2, MT, HIGH, TM);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {        // above the default only on request
    const cudaError_t err = cudaFuncSetAttribute(
        curscan_tc_split_kernel<T, HIGH, TM, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (pad16(n1) / 16 + MT - 1) / MT;
  curscan_tc_split_kernel<T, HIGH, TM, MT>
      <<<static_cast<unsigned>(t) * tiles, THREADS, smem, stream>>>(
          static_cast<const T*>(re), static_cast<const T*>(im),
          static_cast<float*>(out), static_cast<const int*>(starts),
          static_cast<const float*>(weights),
          static_cast<const float*>(window), static_cast<const uint4*>(f1),
          static_cast<const uint2*>(f2), static_cast<const float2*>(tw),
          full, n, n1, n2, n_windows, fold);
  return static_cast<int>(cudaGetLastError());
}

// CALL(T, TM, MT) for the instantiation of (is_u8, three_mult, mt); HIGH
// has no MT = 4.
#define KSPEC_TCS_MT(CALL, T, TM)                                           \
  (mt == 1 ? CALL(T, TM, 1) : mt == 2 ? CALL(T, TM, 2) : CALL(T, TM, 4))
#define KSPEC_TCS_DISPATCH(CALL)                                            \
  (is_u8 ? (three_mult ? KSPEC_TCS_MT(CALL, uint8_t, true)                 \
                       : KSPEC_TCS_MT(CALL, uint8_t, false))               \
         : (three_mult ? KSPEC_TCS_MT(CALL, float, true)                   \
                       : KSPEC_TCS_MT(CALL, float, false)))

// The instantiation for (input, form, pick_mt) at one class.
template <bool HIGH>
int launch_class(int is_u8, int three_mult, const void* re, const void* im,
                 void* out, const void* starts, const void* weights,
                 const void* window, const void* f1, const void* f2,
                 const void* tw, int t, int full, int n, int n1, int n2,
                 int n_windows, int fold, cudaStream_t stream) {
  const int mt = n1 < 1 || n2 < 1 ? 0 : pick_mt(n1, n2, HIGH, three_mult);
  if (mt == 0 || static_cast<long long>(n1) * n2 != n || t < 1 ||
      n_windows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define KSPEC_TCS_LAUNCH(T, TM, MT)                                         \
  launch_one<T, HIGH, TM, (HIGH && MT == 4) ? 2 : MT>(                     \
      re, im, out, starts, weights, window, f1, f2, tw, t, full, n, n1, n2, \
      n_windows, fold, stream)
  return KSPEC_TCS_DISPATCH(KSPEC_TCS_LAUNCH);
#undef KSPEC_TCS_LAUNCH
}
#undef KSPEC_TCS_DISPATCH
#undef KSPEC_TCS_MT

// The launchers of the two classes, one class per translation unit.
int launch_default(int is_u8, int three_mult, const void* re, const void* im,
                   void* out, const void* starts, const void* weights,
                   const void* window, const void* f1, const void* f2,
                   const void* tw, int t, int full, int n, int n1, int n2,
                   int n_windows, int fold, cudaStream_t stream);
int launch_high(int is_u8, int three_mult, const void* re, const void* im,
                void* out, const void* starts, const void* weights,
                const void* window, const void* f1, const void* f2,
                const void* tw, int t, int full, int n, int n1, int n2,
                int n_windows, int fold, cudaStream_t stream);

}  // namespace kspec_tcs
