// Tensor-core two-stage DFT curscan for any split n = n1 * n2 (Kernel C) for
// NVIDIA Hopper (sm_90a): the HIGH and DEFAULT precision classes of K1 above
// fft 16384 and of K3 on every split, and in its HIGHEST ablate build the
// six-pass class of K1's ablate keys above fft 16384.  Device code,
// instantiated by curscan_tc_split.cu (DEFAULT, and the C entry points) and
// curscan_tc_split_high.cu (HIGH, or HIGHEST in a -DKSPEC_TC_HIGHEST=1
// build): two nvcc runs in parallel.  The class is the template argument S,
// the bf16 parts an operand: 1 DEFAULT, 2 HIGH, 3 HIGHEST.
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
// DEFAULT, as the bf16x3 split at HIGH and in six passes at HIGHEST; the
// complex products in the 3M or
// 4M form (curscan_tc_common.cuh, Acc); each operand (the windowed frame,
// C) rounded once from its float32 value; the element-wise steps with the
// _rn intrinsics, so each rounds where the plain version
// (ops/cuda_tc.curscan_tc_split_plain) rounds.
//
// The Pallas bodies frame by n2-aligned rows (lane kernel) or rotate lanes
// (sublane kernel) and run block-diagonal dots on the MXU: Mosaic's layouts.
// Here a window start is an address, so any n2 (odd too: 41 at fft 2050, 199
// at fft 39800) and any start work.
//
// What bounds it on the H100: operations (4 products of 2 n1 n2 (n1 + n2)
// flops a window at 4M, times 3 at HIGH, at 989 TFLOP/s bf16), or at few
// windows the planes read once.  On mma.sync the products run at a fraction
// of that rate, and at first the latency of device memory and the barriers
// held the tensor cores back (scripts/tc_split_stages.py's table: the frame
// and stage 1 took 60-90% of the time).  The design keeps them fed from
// shared memory:
//   * A thread block takes one IQ block, a k1 tile of MT m-tiles (16 rows
//     each; rows are independent through stage 2 and the fold) and a window
//     group (G blocks share an IQ block where T x tiles does not fill the
//     card; each folds a contiguous range of windows, a second kernel folds
//     the G partial rows in group order), 256 threads, and walks its
//     windows in order.  Every block of an IQ block stages its whole frame,
//     so MT is as large as the registers allow, 4, each warp holding the
//     accumulators of its strip for all MT m-tiles (8 m-tiles at one block
//     an SM ran 25% slower at fft 10000 DEFAULT than 4 at two).  At HIGH a
//     product's two correction terms (a_hi b_lo, a_lo b_hi) sum in one
//     float32 chain, not two, which is what makes 4 m-tiles fit; at HIGHEST
//     its five (the second-order terms first, then a_hi b_mid, a_mid b_hi).
//   * Both stages run in panels of 64 columns: warp w takes the panel's
//     strip of 8 columns w for all MT m-tiles, so each F1 fragment feeds
//     the products of one strip and each frame fragment those of MT tiles;
//     a strip past n2 leaves its warp idle in that panel only.
//   * Stage 1 walks the frame in chunks of rows m1 (chunk_rows: 16 at
//     DEFAULT; at HIGH, one block an SM, 64 up to n1p 128 and 32 above;
//     at HIGHEST 32).
//     All threads stage a chunk's panel once a block: coalesced loads
//     along rows of the planes
//     (u8 decoded in the load), windowed in float32 and rounded once into
//     bf16 operand planes (re, im, at 3M re + im; hi, at HIGH lo, at
//     HIGHEST mid and lo) in one of
//     two buffers; the next chunk's loads (the next window's first, after
//     the last) are in flight in registers while the warps run the current
//     chunk's products, B fragments read by ldmatrix.trans.  One barrier a
//     chunk; a chunk's products have to outlast its loads' latency, which
//     is what the taller chunks at HIGH are for.  F1's rows of the block
//     (16 MT x n1p,
//     the slots in use) are copied to shared memory once a block where they
//     fit.
//   * The twiddled C is rounded once into bf16 planes (16 MT rows of n2p + 8)
//     that stage 2 reads by ldmatrix; F2^T's fragments, loaded a k-chunk
//     ahead, from a copy in shared memory where it fits, else from L2; the
//     twiddles from a copy of the block's rows where it fits.
//   * |D| is weighted and folded by the one lane that owns each element, in
//     window order, in a float32 fold in shared memory (16 MT rows of n2p +
//     8) written to the output row once at the end, fftshifted, k1 fastest.
//   * Shared memory (layout(): the C planes and the frame buffers, then F1's
//     rows, the fold, the twiddles and F2^T while they fit a budget): two
//     blocks an SM at DEFAULT where the first four fit half an SM (launch
//     bounds: 128 registers), else one.
//     Where the frame buffers do not fit beside one m-tile's C planes (n2p
//     from 3488 at DEFAULT 4M, 1536 at HIGH 4M, 928 at 3M HIGH, with
//     32-row chunks) each lane loads its B fragment's samples straight
//     from the planes; where the fold does not fit, each lane folds its
//     elements in the output (or partial) row in device memory.  One
//     m-tile's C planes fit up to n2p 1200 at 3M HIGH, 1808 at HIGH and
//     3616 at DEFAULT (lane splits of fft 1.4M, 3.2M and 13M), and at
//     HIGHEST up to n2p 1200 at 4M and 784 at 3M: the sublane split's n2 =
//     128 fits at every n1 (C planes and frame buffers 159,744 bytes at 4
//     m-tiles, 4M).
//   * n1 and n2 are padded to 16 with zero rows and columns of F1, F2^T and
//     the twiddles (exact); padded rows and columns are never stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "curscan_tc_common.cuh"

// Forensic cut-offs (profiling only; the port's library leaves
// KSPEC_TCS_STOP 0, and ops/cuda_tc.tc_split_stage_library builds these
// sources with -DKSPEC_TCS_STOP=s into a library of its own).  Cut-off s
// ends the window after its stage and folds, in place of |D|, the sum over
// windows, in window order, of weights[w] (re + im) of every element of
// that stage into the output, at the element's (row, column) as the
// production kernel stores D (fftshifted k1 + n1 k2):
//   1 frame  the windowed frame as staged (its parts summed), (m1, m2)
//   2 s1     B = F1 A in float32, (k1, m2)
//   3 s1tw   C = B o T in float32, written to the planes as stage 2 reads it
//   4 s2     D = C F2^T in float32, (k1, k2)
// Every element of the stage feeds the output, so no product can be
// dropped; every block stages the whole frame, and cut-off 1 folds the
// rows of its k1 tile.  The cut-offs take the staged frame (the wrapper's
// launch fails where it does not fit).  Plain version:
// ops/cuda_tc.curscan_tc_split_stage_plain.
#ifndef KSPEC_TCS_STOP
#define KSPEC_TCS_STOP 0
#endif

// The ablate build (forensics only; the port's library leaves
// KSPEC_TCS_ABLATE 0, and ops/cuda_tc.tc_split_ablate_library builds these
// sources with -DKSPEC_TCS_ABLATE=1, entry kspec_curscan_tc_split_ablate).
// Replaces: the `ablate` keys of
// kspecanal_tpu/ops/pallas_curscan.py::_kernel_sublane (:427, :534-636) at
// tpuPrecision HIGH and DEFAULT above fft 16384, on its split (n / 128,
// 128), and with -DKSPEC_TC_HIGHEST=1 at HIGHEST.  A run-time mask
// (curscan_tc_common.cuh, Ablate) removes stages as Kernel A's ablate build
// does (curscan_tc.cuh): the window (its loads), stage 1's products (B = the
// staged frame, read from the chunk buffers), the twiddle (and its loads),
// stage 2's products (D = C as staged), the square root, the weighted fold
// (an unweighted sum over the windows and the groups, whatever the mode).  The frame is staged as ever; the build
// takes the staged frame only (the launch fails where it does not fit).
// With no bit set it runs the production kernel's operations.  Plain
// version: ops/cuda_tc.curscan_tc_split_plain(..., ablate).
#ifndef KSPEC_TCS_ABLATE
#define KSPEC_TCS_ABLATE 0
#endif

namespace kspec_tcs {

using kspec_tc::AB_CUMULATE;
using kspec_tc::AB_SHIFT;
using kspec_tc::AB_SQRT;
using kspec_tc::AB_STAGE1;
using kspec_tc::AB_STAGE2;
using kspec_tc::AB_TWIDDLE;
using kspec_tc::AB_WIN;
using kspec_tc::fold_op;
using kspec_tc::ldsm2t;
using kspec_tc::ldsm4;
using kspec_tc::ldsm4t;
using kspec_tc::mma;
using kspec_tc::operand;
using kspec_tc::operand3;
using kspec_tc::operand_value;
using kspec_tc::part_value;
using kspec_tc::put_parts3;
using kspec_tc::parts;
using kspec_tc::sample;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PW = 64;                  // a panel's columns: a strip a warp
constexpr int FR = PW + 8;              // a chunk plane's row (bf16)
constexpr size_t SMEM_LIMIT = 232448;   // a block's shared memory (H100)
// A block's share where two fit an SM: half of the SM's 233,472 bytes less
// the 1,024 the runtime reserves a block.
constexpr size_t SMEM_HALF = 233472 / 2 - 1024;

__host__ __device__ inline int pad16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~15; }

// The blocks an SM is to hold (launch bounds) at a class of s parts an
// operand: two at DEFAULT (128 registers a thread), one at HIGH and HIGHEST
// (their two sums a product).
__host__ __device__ constexpr int min_blocks(int s) {
  return s > 1 ? 1 : 2;
}

// Rows m1 of a frame chunk: 16 at DEFAULT; at HIGH, whose block holds its
// SM alone, 64 where n1p is at most 128 (fft 3000, 10000: a window's frame
// in one or two chunks) and 32 above (its registers hold a chunk's loads
// of 8 or 4 pairs a thread; 64 rows ran slower there); at HIGHEST, whose
// route is the sublane split above fft 16384 (n1p above 128), 32.
__host__ __device__ inline int chunk_rows(int s, int n1) {
  return s == 1 ? 16 : s == 2 && pad16(n1) <= 128 ? 64 : 32;
}

// Bytes of a block's C planes: forms x parts planes of 16 mt rows of
// n2p + 8 bf16 (s: the class's parts an operand, 1 DEFAULT, 2 HIGH, 3
// HIGHEST).
__host__ __device__ inline size_t c_bytes(int n2, int mt, int s, bool tm) {
  return static_cast<size_t>(tm ? 3 : 2) * s * 16 * mt * (pad16(n2) + 8) *
         2;
}

// Bytes of the frame's two chunk buffers: forms x parts planes of
// chunk_rows rows of PW + 8 bf16 each.
__host__ __device__ inline size_t frame_bytes(int n1, int s, bool tm) {
  return 2 * static_cast<size_t>(tm ? 3 : 2) * s * chunk_rows(s, n1) * FR *
         2;
}

// Bytes of the fold (16 mt rows of n2p + 8 floats) and of F1's rows of a
// block (the slots in use: forms x halves x mt x n1p/16 fragments of 512).
__host__ __device__ inline size_t fold_bytes(int n2, int mt) {
  return static_cast<size_t>(16) * mt * (pad16(n2) + 8) * 4;
}
__host__ __device__ inline size_t f1_bytes(int n1, int mt, int s, bool tm) {
  return static_cast<size_t>(tm ? 3 : 2) * s * mt * (pad16(n1) / 16) * 512;
}

// A block's m-tiles: 4, halved while the C planes and the frame buffers
// do not fit a block, 0 where one m-tile's C planes alone do not (one that
// fits without the buffers loads the frame lane by lane); then halved
// while half still covers n1's m-tiles.
inline int pick(int n1, int n2, int s, bool tm) {
  if (n1 < 1 || n2 < 1) return 0;
  int mt = 4;
  while (mt > 1 &&
         c_bytes(n2, mt, s, tm) + frame_bytes(n1, s, tm) > SMEM_LIMIT)
    mt /= 2;
  if (c_bytes(n2, mt, s, tm) > SMEM_LIMIT) return 0;
  while (mt > 1 && mt / 2 >= pad16(n1) / 16) mt /= 2;
  return mt;
}

// Bytes of each shared-memory region, in this order; 0 where a region is
// not in shared memory.  Required: the C planes and (where they fit beside
// them) the frame's two chunk buffers.  Then, while they fit the budget
// (half an SM where two blocks are to fit it and the required regions,
// F1's rows and the fold do, else a block's whole share), in this order of
// priority: F1's rows of the block (read every chunk), the fold (every
// window), the block's twiddle rows, F2^T (the slots in use; read a
// k-chunk ahead).  The window is loaded with the samples.
// kspec_curscan_tc_split_smem reports the total.
struct Layout {
  size_t c, frame, fold, f1, f2, tw;
  __host__ __device__ size_t total() const {
    return c + frame + fold + f1 + f2 + tw;
  }
};

__host__ __device__ inline size_t take(size_t& used, size_t budget,
                                       size_t want) {
  want = up16(want);
  if (used + want > budget) return 0;
  used += want;
  return want;
}

__host__ __device__ inline Layout layout(int n1, int n2, int s, bool tm,
                                         int mt) {
  const size_t fh = static_cast<size_t>(tm ? 3 : 2) * s;
  const size_t n2p = pad16(n2);
  Layout l{};
  l.c = c_bytes(n2, mt, s, tm);
  l.frame = frame_bytes(n1, s, tm);
  if (l.c + l.frame > SMEM_LIMIT) l.frame = 0;
  size_t used = l.c + l.frame;
  const size_t budget =
      min_blocks(s) == 2 &&
              used + up16(f1_bytes(n1, mt, s, tm)) + fold_bytes(n2, mt) <=
                  SMEM_HALF
          ? SMEM_HALF
          : SMEM_LIMIT;
  l.f1 = take(used, budget, f1_bytes(n1, mt, s, tm));
  l.fold = take(used, budget, fold_bytes(n2, mt));
  l.tw = take(used, budget, 16 * mt * n2p * 8);
  l.f2 = take(used, budget, fh * n2p * n2p * 2);
  return l;
}

// The products of a tile: 3M T1, T2, T3; 4M rr, ii, ri, ir.  Each is
// hh = a_hi b_hi and, at HIGH, lo = a_hi b_lo + a_lo b_hi summed in one
// float32 chain (Kernel A's Acc keeps the two in chains of their own; one
// chain saves a third of the accumulators, so a warp takes 4 m-tiles at
// HIGH too), added as hh + lo.  At HIGHEST lo sums the five other products
// of the six passes (a_hi b_lo, a_mid b_mid, a_lo b_hi, then a_hi b_mid,
// a_mid b_hi) in the one chain (product6).
template <bool TM>
struct Acc {
  static constexpr int P = TM ? 3 : 4;
  float hh[P][4], lo[P][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) hh[p][i] = lo[p][i] = 0.f;
  }
  template <bool HIGH>
  __device__ __forceinline__ void product(int p, const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4],
                                          const uint32_t (&bhi)[2],
                                          const uint32_t (&blo)[2]) {
    mma(hh[p], ahi, bhi[0], bhi[1]);
    if (HIGH) {
      mma(lo[p], ahi, blo[0], blo[1]);
      mma(lo[p], alo, bhi[0], bhi[1]);
    }
  }
  // The complex product's real products from operand forms a[f][half] and
  // b[f][half] (f: re, im, re + im), as kspec_tc::Acc::products.
  template <bool HIGH>
  __device__ __forceinline__ void products(const uint32_t (&a)[3][2][4],
                                           const uint32_t (&b)[3][2][2]) {
    product<HIGH>(0, a[0][0], a[0][1], b[0][0], b[0][1]);
    product<HIGH>(1, a[1][0], a[1][1], b[1][0], b[1][1]);
    if (TM) {
      product<HIGH>(2, a[2][0], a[2][1], b[2][0], b[2][1]);
    } else {
      product<HIGH>(2, a[0][0], a[0][1], b[1][0], b[1][1]);
      product<HIGH>(3, a[1][0], a[1][1], b[0][0], b[0][1]);
    }
  }
  // HIGHEST's six passes of product p from parts a[part], b[part] (hi,
  // mid, lo), and of the complex product (as products).
  __device__ __forceinline__ void product6(int p, const uint32_t (&a)[3][4],
                                           const uint32_t (&b)[3][2]) {
    mma(hh[p], a[0], b[0][0], b[0][1]);
    mma(lo[p], a[0], b[2][0], b[2][1]);
    mma(lo[p], a[1], b[1][0], b[1][1]);
    mma(lo[p], a[2], b[0][0], b[0][1]);
    mma(lo[p], a[0], b[1][0], b[1][1]);
    mma(lo[p], a[1], b[0][0], b[0][1]);
  }
  __device__ __forceinline__ void products6(const uint32_t (&a)[3][3][4],
                                            const uint32_t (&b)[3][3][2]) {
    product6(0, a[0], b[0]);
    product6(1, a[1], b[1]);
    if (TM) {
      product6(2, a[2], b[2]);
    } else {
      product6(2, a[0], b[1]);
      product6(3, a[1], b[0]);
    }
  }
  template <bool HIGH>
  __device__ __forceinline__ float value(int p, int i) const {
    return HIGH ? __fadd_rn(hh[p][i], lo[p][i]) : hh[p][i];
  }
  // (Re, Im) of element i in the complex form.  4M: rr - ii, ri + ir.
  template <bool HIGH>
  __device__ __forceinline__ void complex(int i, float& re, float& im) const {
    if (TM) {
      const float t1 = value<HIGH>(0, i);
      const float t2 = value<HIGH>(1, i);
      const float t3 = value<HIGH>(2, i);
      re = __fsub_rn(t1, t2);
      im = __fsub_rn(__fsub_rn(t3, t1), t2);
    } else {
      re = __fsub_rn(value<HIGH>(0, i), value<HIGH>(1, i));
      im = __fadd_rn(value<HIGH>(2, i), value<HIGH>(3, i));
    }
  }
};

// The operands of the pairs (r0, r1) and (i0, i1), adjacent columns of one
// row, at word o (element 2 o) of every plane of pw words: plane q =
// form * H + half (forms re, im, 3M re + im; halves hi, HIGH lo).
template <bool HIGH, bool TM>
__device__ __forceinline__ void put(uint32_t* pl, int pw, int o, float r0,
                                    float r1, float i0, float i1) {
  constexpr int H = HIGH ? 2 : 1;
  uint32_t hi, lo;
  operand<HIGH>(r0, r1, hi, lo);
  pl[o] = hi;
  if (HIGH) pl[pw + o] = lo;
  operand<HIGH>(i0, i1, hi, lo);
  pl[H * pw + o] = hi;
  if (HIGH) pl[(H + 1) * pw + o] = lo;
  if (TM) {
    operand<HIGH>(__fadd_rn(r0, i0), __fadd_rn(r1, i1), hi, lo);
    pl[2 * H * pw + o] = hi;
    if (HIGH) pl[(2 * H + 1) * pw + o] = lo;
  }
}

// HIGHEST's put: the three parts of each form, plane q = form * 3 + part.
template <bool TM>
__device__ __forceinline__ void put3(uint32_t* pl, int pw, int o, float r0,
                                     float r1, float i0, float i1) {
  put_parts3(pl, pw, o, r0, r1);
  put_parts3(pl + 3 * pw, pw, o, i0, i1);
  if (TM)
    put_parts3(pl + 6 * pw, pw, o, __fadd_rn(r0, i0), __fadd_rn(r1, i1));
}

// The class's put, S parts an operand.
#define KSPEC_TCS_PUT(...)                                                  \
  do {                                                                       \
    if constexpr (S == 3) put3<TM>(__VA_ARGS__);                             \
    else put<HIGH, TM>(__VA_ARGS__);                                         \
  } while (0)

// Kernel C.  Grid: t * tiles * groups thread blocks, tiles = ceil(n1p / (16
// MT)); block ((b * tiles + tile) * groups + g) computes rows k1 of m-tiles
// tile*MT.. of IQ block b over windows [g W / G, (g + 1) W / G).  f1 holds
// F1's A fragments [slot][mt][kc][lane] (uint4; n1p/16 squared tiles), f2
// F2^T's B fragments [slot][kc][nt][lane] (uint2; n2p/16 x n2p/8 tiles),
// slot = P2 * form + part (form re, im, re + im; P2 = parts(S)); tw the
// (n1p, n2p)
// twiddles, zero outside (n1, n2).  STAGED: the frame goes through the
// chunk buffers of KR rows (else each lane loads its B fragments'
// samples).  The ablate build takes its mask in `fold`'s bits from AB_SHIFT
// up.
template <typename T, int S, bool TM, int MT, int KR, bool STAGED>
__global__ void __launch_bounds__(THREADS, min_blocks(S))
curscan_tc_split_kernel(const T* __restrict__ re, const T* __restrict__ im,
                        float* __restrict__ out, float* __restrict__ part,
                        const int* __restrict__ starts,
                        const float* __restrict__ weights,
                        const float* __restrict__ window,
                        const uint4* __restrict__ f1,
                        const uint2* __restrict__ f2,
                        const float2* __restrict__ tw, int full, int n,
                        int n1, int n2, int n_windows, int groups, int fold) {
  constexpr bool HIGH = S > 1;                   // HIGH's value of a product
  constexpr int H = S;
  constexpr int P2 = parts(S);                   // table slots a matrix
  constexpr int FH = (TM ? 3 : 2) * H;
  constexpr int KS = KR / 16;                    // a chunk's k-chunks
  constexpr int FPE = KR * FR;                   // a chunk plane's elements
  constexpr int PAIRS = KR * PW / 2 / THREADS;   // pairs a thread stages
  // The ablate build's stages to remove (all false in the port's library).
  const int ab = KSPEC_TCS_ABLATE ? fold >> AB_SHIFT : 0;
  const int fk = KSPEC_TCS_STOP ? kspec_tc::FOLD_SUM
      : KSPEC_TCS_ABLATE
          ? kspec_tc::ablated_fold(fold & ((1 << AB_SHIFT) - 1), ab) : fold;
  const bool no_win = KSPEC_TCS_ABLATE && (ab & AB_WIN);
  const bool no_s1 = KSPEC_TCS_ABLATE && (ab & AB_STAGE1);
  const bool no_tw = KSPEC_TCS_ABLATE && (ab & AB_TWIDDLE);
  const bool no_s2 = KSPEC_TCS_ABLATE && (ab & AB_STAGE2);
  const bool no_sqrt = KSPEC_TCS_ABLATE && (ab & AB_SQRT);
  const bool no_cum = KSPEC_TCS_ABLATE && (ab & AB_CUMULATE);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(n1, n2, S, TM, MT);
  const int n1p = pad16(n1), n2p = pad16(n2);
  const int nmt = n1p / 16;               // m-tiles of k1, k-chunks of m1
  const int tiles = (nmt + MT - 1) / MT;
  const int nch = (nmt + KS - 1) / KS;    // frame chunks a panel
  const int strips = n2p / 8;             // column strips of 8 (m2, k2)
  const int kc2 = n2p / 16;               // stage 2's k-chunks
  const int panels = (strips + WARPS - 1) / WARPS;
  const int crs = n2p + 8;                // a C plane's row (bf16)
  const int cpe = 16 * MT * crs;          // a C plane's elements
  const int fst = n2p + 8;                // the fold's row (floats)
  const int f1n = nmt * nmt * 32;         // uint4s of one F1 slot
  const int f2n = kc2 * strips * 32;      // uint2s of one F2^T slot
  uint32_t* cw = reinterpret_cast<uint32_t*>(smem);   // C planes, words
  unsigned char* rg = smem + l.c;
  uint16_t* fpl = reinterpret_cast<uint16_t*>(rg);    // chunk buffers
  float* fs = reinterpret_cast<float*>(rg += l.frame);
  uint4* f1s = reinterpret_cast<uint4*>(rg += l.fold);
  uint2* f2s = reinterpret_cast<uint2*>(rg += l.f1);
  float2* tws = reinterpret_cast<float2*>(rg += l.f2);
  const uint32_t c_s = static_cast<uint32_t>(__cvta_generic_to_shared(cw));
  const uint32_t f_s = static_cast<uint32_t>(__cvta_generic_to_shared(fpl));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int g = blockIdx.x % groups, bt = blockIdx.x / groups;
  const int b = bt / tiles, mt0 = (bt % tiles) * MT;
  const int r0 = mt0 * 16;                // the block's first row k1
  const int w0 = static_cast<int>(static_cast<long long>(g) * n_windows /
                                  groups);
  const int w1 = static_cast<int>(static_cast<long long>(g + 1) * n_windows /
                                  groups);
  const T* pre = re + static_cast<size_t>(b) * full;
  const T* pim = im + static_cast<size_t>(b) * full;
  float* dst = groups > 1
      ? part + (static_cast<size_t>(b) * groups + g) * n
      : out + static_cast<size_t>(b) * n;

  // The tables' copies, once a block: F1's rows of the block (slot q =
  // form * H + half; m-tiles past n1p zero), F2^T, the twiddle rows.
  if (l.f1) {
    for (int i = tid; i < FH * MT * nmt * 32; i += THREADS) {
      const int q = i / (MT * nmt * 32), r = i % (MT * nmt * 32);
      const int u = r / (nmt * 32);
      f1s[i] = mt0 + u < nmt
          ? __ldg(f1 + (P2 * (q / H) + q % H) * f1n + mt0 * nmt * 32 + r)
          : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (l.f2) {
    for (int i = tid; i < FH * f2n; i += THREADS) {
      const int q = i / f2n;
      f2s[i] = __ldg(f2 + (P2 * (q / H) + q % H) * f2n + i % f2n);
    }
  }
  if (l.tw) {
    for (int i = tid; i < 16 * MT * n2p; i += THREADS)
      tws[i] = r0 + i / n2p < n1p
          ? __ldg(tw + static_cast<size_t>(r0) * n2p + i)
          : make_float2(0.f, 0.f);
  }
  __syncthreads();

  // Element (row rl of the block, column col) of the fold: in shared memory
  // or in dst at its fftshifted place; the first window of the group sets.
  auto fold_at = [&](int rl, int col, float v, bool first) {
    float* p = l.fold ? fs + rl * fst + col
                      : dst + (r0 + rl + n1 * col + n / 2) % n;
    *p = first ? v : fold_op(fk, *p, v);
  };

  // The frame pipeline: chunk (w, p, kc) is rows kc*KR.. of window w's
  // frame, columns p*PW.. (panel p).  Thread tid stages pairs tid + k
  // THREADS of the chunk's KR x PW/2 (row-major): px, py, pw hold the
  // next chunk's samples (re, im) and window values from their loads until
  // they are staged.
  float px[PAIRS][2], py[PAIRS][2], pw[PAIRS][2];
  auto load_chunk = [&](int w, int p, int kc) {
    const T* xr = pre + starts[w];
    const T* xi = pim + starts[w];
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int pi = tid + k * THREADS;
      const int m1 = kc * KR + pi / (PW / 2);
      const int m2 = p * PW + 2 * (pi % (PW / 2));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = m1 < n1 && m2 + e < n2;
        const int o = m1 * n2 + m2 + e;
        px[k][e] = ok ? sample(xr, o) : 0.f;
        py[k][e] = ok ? sample(xi, o) : 0.f;
        pw[k][e] = ok ? (no_win ? 1.f : __ldg(window + o)) : 0.f;
      }
    }
  };
  auto stage_chunk = [&](int buf) {
    uint32_t* fw = reinterpret_cast<uint32_t*>(fpl) + buf * (FH * FPE / 2);
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int pi = tid + k * THREADS;
      const int r = pi / (PW / 2), c = 2 * (pi % (PW / 2));
      float v[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[0][e] = __fmul_rn(px[k][e], pw[k][e]);
        v[1][e] = __fmul_rn(py[k][e], pw[k][e]);
      }
      KSPEC_TCS_PUT(fw, FPE / 2, (r * FR + c) >> 1, v[0][0], v[0][1],
                    v[1][0], v[1][1]);
    }
  };
  // Cut-off frame: the staged chunk's elements of the block's rows, each
  // folded by the thread that staged it.
  auto fold_chunk = [&](int buf, int p, int kc, float wgt, bool first) {
    const uint16_t* fb = fpl + buf * (FH * FPE);
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int pi = tid + k * THREADS;
      const int r = pi / (PW / 2), c = 2 * (pi % (PW / 2));
      const int m1 = kc * KR + r;
      if (m1 < r0 || m1 >= r0 + 16 * MT) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m2 = p * PW + c + e, o = r * FR + c + e;
        if (m1 >= n1 || m2 >= n2) continue;
        const float xr = part_value<S>(fb, FPE, o);
        const float xi = part_value<S>(fb + H * FPE, FPE, o);
        fold_at(m1 - r0, m2, __fmul_rn(wgt, __fadd_rn(xr, xi)), first);
      }
    }
  };
  // Stage 1's B fragments (rows ks*16.. x 8 columns) of every plane of
  // buffer buf, this warp's strip of the panel, by ldmatrix.trans: lane l
  // addresses row l % 16 of plane l / 16, so one x4 loads planes q, q + 1.
  auto b_frags = [&](uint32_t (&x)[3][P2][2], int buf, int ks) {
    const uint32_t addr = f_s + 2u * (buf * FH * FPE + (lane >> 4) * FPE +
                                      (ks * 16 + (lane & 15)) * FR +
                                      warp * 8);
#pragma unroll
    for (int q = 0; q < FH; q += 2) {
      if (q + 1 < FH) {
        uint32_t r[4];
        ldsm4t(r, addr + 2u * q * FPE);
        x[q / H][q % H][0] = r[0];
        x[q / H][q % H][1] = r[1];
        x[(q + 1) / H][(q + 1) % H][0] = r[2];
        x[(q + 1) / H][(q + 1) % H][1] = r[3];
      } else {
        ldsm2t(x[q / H][q % H][0], x[q / H][q % H][1], addr + 2u * q * FPE);
      }
    }
  };
  // The ablate build's B without stage 1: the frame as staged in chunk
  // buffer buf (rows kc*KR..), at the elements of the lane's C (rows u*16 +
  // g8 (+ 8) of the block, columns 2t, 2t + 1 of this warp's strip), into
  // a[u]'s first two products' accumulators (re, im).
  auto frame_rows = [&](Acc<TM> (&a)[MT], int buf, int kc) {
    const uint16_t* fb = fpl + buf * (FH * FPE);
#pragma unroll
    for (int u = 0; u < MT; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + u * 16 + g8 + (i >> 1) * 8 - kc * KR;
        if (r < 0 || r >= KR) continue;
        const int o = r * FR + warp * 8 + 2 * t4 + (i & 1);
        a[u].hh[0][i] = part_value<S>(fb, FPE, o);
        a[u].hh[1][i] = part_value<S>(fb + H * FPE, FPE, o);
      }
    }
  };
  // The same fragments loaded by the lane itself from the planes (frame
  // buffers that do not fit): rows m1 = kc*16 + 2t, 2t+1 (b0), 2t+8, 2t+9
  // (b1) of column m2.
  auto b_direct = [&](uint32_t (&x)[3][P2][2], int w, int m2, int kc) {
    const T* xr = pre + starts[w];
    const T* xi = pim + starts[w];
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
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (S == 3) {
        operand3(vr[2 * h], vr[2 * h + 1], x[0][0][h], x[0][1][h],
                 x[0][2][h]);
        operand3(vi[2 * h], vi[2 * h + 1], x[1][0][h], x[1][1][h],
                 x[1][2][h]);
        if (TM)
          operand3(__fadd_rn(vr[2 * h], vi[2 * h]),
                   __fadd_rn(vr[2 * h + 1], vi[2 * h + 1]), x[2][0][h],
                   x[2][1][h], x[2][2][h]);
      } else {
        operand<HIGH>(vr[2 * h], vr[2 * h + 1], x[0][0][h], x[0][1][h]);
        operand<HIGH>(vi[2 * h], vi[2 * h + 1], x[1][0][h], x[1][1][h]);
        if (TM)
          operand<HIGH>(__fadd_rn(vr[2 * h], vi[2 * h]),
                        __fadd_rn(vr[2 * h + 1], vi[2 * h + 1]), x[2][0][h],
                        x[2][1][h]);
      }
    }
  };
  auto f1_frags = [&](uint32_t (&f)[3][P2][4], int u, int kc) {
#pragma unroll
    for (int q = 0; q < FH; ++q) {
      const uint4 v = l.f1
          ? f1s[((q * MT + u) * nmt + kc) * 32 + lane]
          : __ldg(f1 + (P2 * (q / H) + q % H) * f1n +
                  ((mt0 + u) * nmt + kc) * 32 + lane);
      f[q / H][q % H][0] = v.x;
      f[q / H][q % H][1] = v.y;
      f[q / H][q % H][2] = v.z;
      f[q / H][q % H][3] = v.w;
    }
  };
  // F2^T's B fragments of k-chunk kc, strip j.
  auto f2_frags = [&](uint32_t (&fb)[3][P2][2], int kc, int j) {
    const int i = (kc * strips + j) * 32 + lane;
#pragma unroll
    for (int q = 0; q < FH; ++q) {
      const uint2 v = l.f2 ? f2s[q * f2n + i]
                           : __ldg(f2 + (P2 * (q / H) + q % H) * f2n + i);
      fb[q / H][q % H][0] = v.x;
      fb[q / H][q % H][1] = v.y;
    }
  };

  if (STAGED && w0 < w1) load_chunk(w0, 0, 0);
  int ci = 0;                             // chunks staged so far
  for (int w = w0; w < w1; ++w) {
    const float wgt = weights[w];
    const bool first = w == w0;

    // Stage 1, panel by panel: B = F1 A over this warp's strip of the
    // panel for the block's m-tiles, chunk by chunk (KS k-chunks each),
    // then C = B o T into the C planes.
    for (int p = 0; p < panels; ++p) {
      const int j = p * WARPS + warp;     // this warp's strip
      const bool on = j < strips;
      Acc<TM> a[MT];
#pragma unroll
      for (int u = 0; u < MT; ++u) a[u].zero();
      for (int kc = 0; kc < nch; ++kc, ++ci) {
        const int buf = ci & 1;
        if (STAGED) {
          stage_chunk(buf);
          __syncthreads();
          // The next chunk's loads: this panel's, the next panel's, or the
          // next window's first.
          int nw = w, np = p, nk = kc + 1;
          if (nk == nch) {
            nk = 0;
            if (++np == panels) np = 0, ++nw;
          }
          if (nw < w1) load_chunk(nw, np, nk);
          if (KSPEC_TCS_STOP == 1) {
            fold_chunk(buf, p, kc, wgt, first);
            continue;
          }
        }
        if (!on) continue;
        if (no_s1) {
          frame_rows(a, buf, kc);
          continue;
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int kk = kc * KS + ks;    // the k-chunk of 16 rows m1
          if (kk >= nmt) break;
          uint32_t x[3][P2][2];
          if (STAGED) b_frags(x, buf, ks);
          else b_direct(x, w, j * 8 + g8, kk);
#pragma unroll
          for (int u = 0; u < MT; ++u) {
            if (mt0 + u >= nmt) continue;
            uint32_t f[3][P2][4];
            f1_frags(f, u, kk);
            KSPEC_CLASS_PRODUCTS(a[u], f, x);
          }
        }
      }
      if (KSPEC_TCS_STOP == 1 || !on) continue;
      // C = B o T in float32, each lane's pairs (row, columns 2t, 2t + 1)
      // into every plane.
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        if (mt0 + u >= nmt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = u * 16 + g8 + h * 8;   // the block's row
          float cr[2], ci_[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 8 + 2 * t4 + e;
            float br, bi;
            if (no_s1) {
              br = a[u].hh[0][2 * h + e];
              bi = a[u].hh[1][2 * h + e];
            } else {
              a[u].template complex<HIGH>(2 * h + e, br, bi);
            }
            if (no_tw) {
              cr[e] = br;
              ci_[e] = bi;
            } else {
              const float2 t = l.tw ? tws[rl * n2p + col]
                  : __ldg(tw + static_cast<size_t>(r0 + rl) * n2p + col);
              cr[e] = __fsub_rn(__fmul_rn(br, t.x), __fmul_rn(bi, t.y));
              ci_[e] = __fadd_rn(__fmul_rn(br, t.y), __fmul_rn(bi, t.x));
            }
            if ((KSPEC_TCS_STOP == 2 || KSPEC_TCS_STOP == 3) &&
                r0 + rl < n1 && col < n2)
              fold_at(rl, col, __fmul_rn(wgt, KSPEC_TCS_STOP == 2
                                                  ? __fadd_rn(br, bi)
                                                  : __fadd_rn(cr[e], ci_[e])),
                      first);
          }
          if (KSPEC_TCS_STOP != 2)
            KSPEC_TCS_PUT(cw, cpe / 2, (rl * crs + j * 8 + 2 * t4) >> 1,
                          cr[0], cr[1], ci_[0], ci_[1]);
        }
      }
    }
    __syncthreads();
    if (KSPEC_TCS_STOP >= 1 && KSPEC_TCS_STOP <= 3) continue;

    // Stage 2, panel by panel: D = C F2^T over this warp's output strip of
    // the panel for the block's m-tiles, F2^T's fragments loaded a k-chunk
    // ahead; |D| weighted and folded.
    for (int p = 0; p < panels; ++p) {
      const int j = p * WARPS + warp;
      if (j >= strips) continue;
      Acc<TM> a[MT];
#pragma unroll
      for (int u = 0; u < MT; ++u) a[u].zero();
      uint32_t fn[3][P2][2];
      if (!no_s2) f2_frags(fn, 0, j);
      for (int kc = 0; kc < (no_s2 ? 0 : kc2); ++kc) {
        uint32_t fb[3][P2][2];
#pragma unroll
        for (int q = 0; q < FH; ++q) {
          fb[q / H][q % H][0] = fn[q / H][q % H][0];
          fb[q / H][q % H][1] = fn[q / H][q % H][1];
        }
        if (kc + 1 < kc2) f2_frags(fn, kc + 1, j);
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          if (mt0 + u >= nmt) continue;
          // A fragments of rows u*16.., columns kc*16..: lane l addresses
          // row l % 8 + 8 ((l / 8) % 2), column 8 (l / 16).
          const uint32_t addr = c_s + 2u * ((u * 16 + (lane & 7) +
                                             ((lane >> 3) & 1) * 8) * crs +
                                            kc * 16 + (lane >> 4) * 8);
          uint32_t c[3][P2][4];
#pragma unroll
          for (int q = 0; q < FH; ++q)
            ldsm4(c[q / H][q % H], addr + 2u * q * cpe);
          KSPEC_CLASS_PRODUCTS(a[u], c, fb);
        }
      }
#pragma unroll
      for (int u = 0; u < MT; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rl = u * 16 + g8 + (i >> 1) * 8;
          const int k2 = j * 8 + 2 * t4 + (i & 1);
          if (r0 + rl < n1 && k2 < n2) {
            float dr, di;
            if (no_s2) {   // D = C as staged for stage 2
              const uint16_t* cp = reinterpret_cast<const uint16_t*>(cw);
              dr = part_value<S>(cp, cpe, rl * crs + k2);
              di = part_value<S>(cp + H * cpe, cpe, rl * crs + k2);
            } else {
              a[u].template complex<HIGH>(i, dr, di);
            }
            const float sq = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
            // cut-off s2: D's re + im in place of |D|, summed
            const float mag = KSPEC_TCS_STOP == 4 ? __fadd_rn(dr, di)
                : no_sqrt ? sq : __fsqrt_rn(sq);
            fold_at(rl, k2, __fmul_rn(no_cum ? 1.f : wgt, mag), first);
          }
        }
      }
    }
    // Unstaged, no barrier of the next window's stage 1 keeps its C writes
    // from this window's stage-2 reads.
    if (!STAGED) __syncthreads();
  }

  // X[k1 + n1 k2] = acc[k1][k2], stored fftshifted, k1 fastest.
  if (l.fold) {
    __syncthreads();
    const int rows = min(16 * MT, n1 - r0);
    for (int i = tid; i < rows * n2; i += THREADS) {
      const int rl = i % rows, k2 = i / rows;
      dst[(r0 + rl + n1 * k2 + n / 2) % n] = fs[rl * fst + k2];
    }
  }
}

// Blocks' tiles of a split: ceil(n1p / (16 mt)).
inline int tiles_of(int n1, int mt) { return (pad16(n1) / 16 + mt - 1) / mt; }

template <typename T, int S, bool TM, int MT, int KR, bool STAGED>
int launch_one(const void* re, const void* im, void* out, void* part,
               const void* starts, const void* weights, const void* window,
               const void* f1, const void* f2, const void* tw, int t,
               int full, int n, int n1, int n2, int n_windows, int groups,
               int fold, cudaStream_t stream) {
  if constexpr ((KSPEC_TCS_STOP != 0 || KSPEC_TCS_ABLATE) && !STAGED) {
    // cut-offs and the ablate build: staged only
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const size_t smem = layout(n1, n2, S, TM, MT).total();
    if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {      // above the default only on request
      const cudaError_t err = cudaFuncSetAttribute(
          curscan_tc_split_kernel<T, S, TM, MT, KR, STAGED>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long blocks =
        static_cast<long long>(t) * tiles_of(n1, MT) * groups;
    curscan_tc_split_kernel<T, S, TM, MT, KR, STAGED>
        <<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
            static_cast<const T*>(re), static_cast<const T*>(im),
            static_cast<float*>(out), static_cast<float*>(part),
            static_cast<const int*>(starts),
            static_cast<const float*>(weights),
            static_cast<const float*>(window),
            static_cast<const uint4*>(f1), static_cast<const uint2*>(f2),
            static_cast<const float2*>(tw), full, n, n1, n2, n_windows,
            groups, fold);
    return static_cast<int>(cudaGetLastError());
  }
}

// Blocks an SM holds of the instantiation (registers and shared memory).
template <typename T, int S, bool TM, int MT, int KR, bool STAGED>
int occupancy_one(int n1, int n2) {
  int blocks = 0;
  const size_t smem = layout(n1, n2, S, TM, MT).total();
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(
          curscan_tc_split_kernel<T, S, TM, MT, KR, STAGED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, curscan_tc_split_kernel<T, S, TM, MT, KR, STAGED>,
          THREADS, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// CALL(T, TM, MT, KR, STAGED) for the instantiation of (is_u8, three_mult)
// and pick's m-tiles and chunk_rows: the frame unstaged only at one m-tile,
// where the C planes leave no room; chunks of 64 rows at HIGH only, 32 at
// HIGH and HIGHEST (both branches one instantiation at DEFAULT and
// HIGHEST).
#define KSPEC_TCS_KR(CALL, T, TM, MT)                                       \
  (kr == 64 ? CALL(T, TM, MT, (S == 2 ? 64 : S == 3 ? 32 : 16), true)      \
            : CALL(T, TM, MT, (S > 1 ? 32 : 16), true))
#define KSPEC_TCS_SHAPE(CALL, T, TM)                                        \
  (!staged ? CALL(T, TM, 1, 16, false)                                     \
   : mt == 4 ? KSPEC_TCS_KR(CALL, T, TM, 4)                                \
   : mt == 2 ? KSPEC_TCS_KR(CALL, T, TM, 2) : KSPEC_TCS_KR(CALL, T, TM, 1))
#define KSPEC_TCS_DISPATCH(CALL)                                            \
  (is_u8 ? (three_mult ? KSPEC_TCS_SHAPE(CALL, uint8_t, true)              \
                       : KSPEC_TCS_SHAPE(CALL, uint8_t, false))            \
         : (three_mult ? KSPEC_TCS_SHAPE(CALL, float, true)                \
                       : KSPEC_TCS_SHAPE(CALL, float, false)))

// pick's m-tiles, whether the frame is staged and its chunk rows, or false
// where no m-tile fits (pick leaves the frame unstaged only at one m-tile).
template <int S>
bool shape_of(int n1, int n2, int three_mult, int& mt, bool& staged,
              int& kr) {
  mt = pick(n1, n2, S, three_mult);
  if (mt == 0) return false;
  staged = layout(n1, n2, S, three_mult, mt).frame > 0;
  kr = chunk_rows(S, n1);
  return staged || mt == 1;
}

// The instantiation for (input, form, m-tiles) at one class (S parts an
// operand).
template <int S>
int launch_class(int is_u8, int three_mult, const void* re, const void* im,
                 void* out, void* part, const void* starts,
                 const void* weights, const void* window, const void* f1,
                 const void* f2, const void* tw, int t, int full, int n,
                 int n1, int n2, int n_windows, int groups, int fold,
                 cudaStream_t stream) {
  int mt, kr;
  bool staged;
  if (!shape_of<S>(n1, n2, three_mult, mt, staged, kr) ||
      static_cast<long long>(n1) * n2 != n || t < 1 || n_windows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define KSPEC_TCS_LAUNCH(T, TM, MT, KR, STAGED)                             \
  launch_one<T, S, TM, MT, KR, STAGED>(re, im, out, part, starts,          \
                                       weights, window, f1, f2, tw, t, full, \
                                       n, n1, n2, n_windows, groups, fold,   \
                                       stream)
  return KSPEC_TCS_DISPATCH(KSPEC_TCS_LAUNCH);
#undef KSPEC_TCS_LAUNCH
}

// The blocks an SM holds of the instantiation launch_class<S> launches
// for these arguments, or -1.
template <int S>
int occupancy_class(int is_u8, int three_mult, int n1, int n2) {
  int mt, kr;
  bool staged;
  if (!shape_of<S>(n1, n2, three_mult, mt, staged, kr)) return -1;
#define KSPEC_TCS_OCCUPANCY(T, TM, MT, KR, STAGED)                          \
  occupancy_one<T, S, TM, MT, KR, STAGED>(n1, n2)
  return KSPEC_TCS_DISPATCH(KSPEC_TCS_OCCUPANCY);
#undef KSPEC_TCS_OCCUPANCY
}
#undef KSPEC_TCS_DISPATCH
#undef KSPEC_TCS_SHAPE
#undef KSPEC_TCS_KR
#undef KSPEC_TCS_PUT

// The launchers and occupancy queries of the two classes, one class per
// translation unit (in a -DKSPEC_TC_HIGHEST=1 build launch_high and
// occupancy_high run HIGHEST and the DEFAULT ones refuse).
int launch_default(int is_u8, int three_mult, const void* re, const void* im,
                   void* out, void* part, const void* starts,
                   const void* weights, const void* window, const void* f1,
                   const void* f2, const void* tw, int t, int full, int n,
                   int n1, int n2, int n_windows, int groups, int fold,
                   cudaStream_t stream);
int launch_high(int is_u8, int three_mult, const void* re, const void* im,
                void* out, void* part, const void* starts,
                const void* weights, const void* window, const void* f1,
                const void* f2, const void* tw, int t, int full, int n,
                int n1, int n2, int n_windows, int groups, int fold,
                cudaStream_t stream);
int occupancy_default(int is_u8, int three_mult, int n1, int n2);
int occupancy_high(int is_u8, int three_mult, int n1, int n2);

}  // namespace kspec_tcs
