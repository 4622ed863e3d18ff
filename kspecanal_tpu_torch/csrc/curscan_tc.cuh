// Tensor-core two-stage DFT curscan kernel (Kernel A) for NVIDIA Hopper
// (sm_90a): the HIGH and DEFAULT precision classes of K1 and of K3's cell on
// the 128 grid, and in forensic builds the six-pass HIGHEST class (K4 and
// K1's ablate keys at HIGHEST).  Device code, instantiated by curscan_tc.cu
// (DEFAULT, and the C entry point) and curscan_tc_high.cu (HIGH, or HIGHEST
// in a -DKSPEC_TC_HIGHEST=1 build): two nvcc runs in parallel.  The class is
// the template argument S, the bf16 parts an operand: 1 DEFAULT, 2 HIGH, 3
// HIGHEST.
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel_sublane (:423, K1,
// entry curscan_fused_sublane) and ::_kernel (:116, K3) at tpuPrecision HIGH
// and DEFAULT, for n = n1 * 128 with n1 <= 128 (fft 256-16384 on the grid).
//
// What it computes, per IQ block b and window start s = starts[w]:
//   A[m1][m2] = win[128 m1 + m2] * x[s + 128 m1 + m2]     float32
//   B = F1 A          stage 1, F1[k1][m1] = W_n1^(k1 m1)
//   C = B o T         twiddle in float32, T[k1][m2] = W_n^(k1 m2)
//   D = C F2^T        stage 2, F2[k2][m2] = W_128^(k2 m2)
//   acc[k1][k2] = fold(acc, weights[w] * |D[k1][k2]|)   float32, window order
//   out[b][(k1 + n1 k2 + n/2) % n] = acc[k1][k2]
// Every real product rounds its float32 operands to bf16 (to nearest even)
// and sums in float32 on mma.sync m16n8k16: once at DEFAULT, at HIGH as
// the bf16x3 split a_hi b_hi + (a_hi b_lo + a_lo b_hi), the hi/lo halves of
// B's operand C taken from its float32 value, and at HIGHEST (forensic
// builds; JAX's HIGHEST inside its kernels, Mosaic's six bf16 passes) as
// the three-part split hi + mid + lo, its six products whose orders sum to
// at most 2 (curscan_tc_common.cuh, Acc::products6).  The complex products
// are 3M (T1 = Fr Xr, T2 = Fi Xi, T3 = (Fr + Fi)(Xr + Xi); Re = T1 - T2,
// Im = (T3 - T1) - T2, Xr + Xi added in float32 before its rounding) or 4M,
// as the wrapper's gate says (ops/cuda_tc.three_mult).  The element-wise
// steps use the _rn intrinsics, so no multiply-add is contracted and each
// rounds where the plain version (ops/cuda_tc.curscan_tc_plain) rounds.
//
// The Pallas body stacks frames on sublanes, rotates lanes for misaligned
// starts and runs block-diagonal dots on the MXU.  Those are Mosaic's
// layouts: here a start at any offset is an address.
//
// What bounds it on the H100: operations at HIGH and where the window count
// is high (4 products of 2 * n1 * 128 * (n1 + 128) flops a window at 4M,
// times 3 at HIGH and 6 at HIGHEST, at 989 TFLOP/s bf16), else the planes
// read once.
//
// What the design does about it:
//   * A thread block takes one IQ block and a group of its windows, 256
//     threads, and walks the windows in order, wb at a time (a pass; the
//     wrapper picks wb so that a pass stacks at most 64 rows, 4 windows at
//     fft 2048, one at fft >= 8192).
//   * Each operand is rounded once.  The staging step writes each windowed
//     frame element (float32 x * win, u8 decoded in the load; 4 samples a
//     load where the start is a multiple of 4) as bf16 operand planes:
//     re and im (and at 3M re + im, added in float32), each hi and at HIGH
//     also lo (HIGHEST: hi, mid, lo), window i in rows i*n1p.. of every
//     plane.  Stage 1 reads its
//     B fragments from them by ldmatrix.trans and writes C = B o T over the
//     frame once, in the same planes and forms, each taken from C's
//     float32 value.  Stage 2 reads its A fragments by ldmatrix: no float32
//     loads of C, no conversions.
//   * Stage 1 runs by column strips where F1's fragments sit in shared
//     memory (warp j%8 owns the 8 columns j*8.. of every row, so it reads
//     only its own strip and writes C over it).  Where they do not fit (4M
//     HIGH and 3M DEFAULT at n1p >= 112, one window a pass) it runs by
//     m-tiles: warp w holds m-tile w's F1 fragments in registers, loaded
//     from L2 once a pass, the warps walk the 16 strips together and each
//     writes its part of a strip after a barrier.  3M HIGH from n1p = 80
//     (its F1 fragments would take 120-192 registers) streams F1 from L2
//     once a strip.
//   * Stage 2 runs by output column tiles over all the pass's rows, each
//     warp holding its tile's F2^T fragments in registers (one load of the
//     table from L2 a tile a pass): 128 KiB of C read a window at fft 2048
//     4M DEFAULT, half of what float32 planes of C would take;
//     at DEFAULT from n1p = 80 a warp takes its two tiles at once, so each
//     A fragment serves both.  Each output element is folded by the one
//     lane that owns it, window by window in order.  Three barriers a pass.
//   * Shared memory, in this order (layout()): the planes (forms x halves
//     planes of wb * n1p rows of 136 bf16: rows of 272 bytes make every
//     ldmatrix phase and the C stores conflict-free); the fold (n1p rows of
//     136 floats) where it fits beside them, else (3M HIGH from n1p = 112)
//     each lane folds its elements in the output (or partial) row in device
//     memory, already fftshifted; F1's A fragments (the slots in use,
//     copied once a block) where they fit.  At n1 = 128 DEFAULT 4M: 69,632
//     + 69,632 + 65,536 bytes; at fft 2048 DEFAULT 4M 44,544, two blocks an
//     SM (launch bounds: at most 128 registers up to n1p = 64).
//   * HIGHEST (forensic builds) stages three parts a form: one block an SM
//     (launch bounds: up to 255 registers; at fft 2048 two blocks' planes
//     would not fit an SM), stage 1 by column strips, one output tile a
//     warp; from n1p = 112 the fold lives in the output rows, the cut-offs'
//     too (in K4's layout).  3M's nine planes fit up to n1p = 80.
//   * n1 and K are padded to 16 with zero rows and columns of F1 (exact);
//     padded rows of C are zero and never stored to the output.
//   * Window groups: where T alone does not fill the card, G thread blocks
//     share an IQ block, each folding a contiguous range of windows; a
//     second kernel combines the G partial folds in group order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "curscan_tc_common.cuh"

// Forensic cut-offs: K4's stages at HIGH and DEFAULT (profiling only; the
// port's library leaves KSPEC_TC_STOP 0, and ops/cuda_tc.stage_library
// builds these sources with -DKSPEC_TC_STOP=s into a library of its own).
// Replaces: scripts/roofline_r2.py::_kernel_ablate (:43, K4; its stages
// :56-124) at tpuPrecision HIGH and DEFAULT.  Each cut-off writes its
// stage's reduction, as K4's reduce_to_out does, in place of the fold:
//   1 read  every sample of the block read once: acc[r][c] = sum over the
//           n-sample slabs j (of the block's window group's share) of
//           re[j n + 128 r + c] + im[...], unweighted, float32;
//   2 frame the staged frames as rounded (hi, plus lo at HIGH; (hi + mid)
//           + lo at HIGHEST),
//   3 s1    B = F1 A in float32, before the twiddle,
//   4 s1tw  C = B o T in float32 (written over the frame, as stage 1 does),
//   5 s2    D = C F2^T in float32:
//           acc[r][c] = sum over windows w of weights[w] (x_re + x_im),
//           in window order;
// every element of the stage feeds the output, so no product can be
// dropped.  A cut-off stores acc in K4's (n1, 128) layout, unshifted
// (out[b][r * 128 + c]), and the combine kernel sums the groups' partials.
// The cut-offs take float32 planes, 4M and AVG weights (K4's and
// scripts/tc_stages.py's form, ops/cuda_tc.curscan_tc_stage): a cut-off
// build instantiates that alone.  Where the fold does not fit beside the
// planes (HIGHEST from n1p = 112) each lane folds its elements in the output
// (or partial) row, in K4's layout.
#ifndef KSPEC_TC_STOP
#define KSPEC_TC_STOP 0
#endif

// The ablate build (forensics only; the port's library leaves
// KSPEC_TC_ABLATE 0, and ops/cuda_tc.tc_ablate_library builds these sources
// with -DKSPEC_TC_ABLATE=1, entry kspec_curscan_tc_ablate).  Replaces: the
// `ablate` keys of kspecanal_tpu/ops/pallas_curscan.py::_kernel_sublane
// (:427, :534-636; scripts/kernel_ablate.py) at tpuPrecision HIGH and
// DEFAULT, and with -DKSPEC_TC_HIGHEST=1 at HIGHEST.  A run-time mask
// (curscan_tc_common.cuh, Ablate) removes stages:
//   AB_WIN       the window: the frame is staged unwindowed (its load
//                skipped), rounded as ever;
//   AB_STAGE1    stage 1's products: B = the frame as staged (its parts
//                summed, part_value), read from the planes;
//   AB_TWIDDLE   the twiddle (and its loads): C = B;
//   AB_STAGE2    stage 2's products: D = C as staged for stage 2;
//   AB_SQRT      the square root: the fold takes |D|^2;
//   AB_CUMULATE  the weighted fold: |D| summed over the windows, unweighted,
//                whatever the mode, and the window groups' partials summed.
// What a removed stage leaves still feeds the output, and the mask is known
// only at run time, so no variant lets the compiler drop other work.  With
// no bit set the build runs the production kernel's operations: its output
// equals the port's library's bit for bit.  Plain version:
// ops/cuda_tc.curscan_tc_plain(..., ablate).
#ifndef KSPEC_TC_ABLATE
#define KSPEC_TC_ABLATE 0
#endif

namespace kspec_tc {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int N2 = 128;          // the sublane layout's fixed n2
constexpr int ROW = N2 + 8;      // the fold's row stride in floats
constexpr int RS = N2 + 8;       // an operand plane's row stride in bf16
constexpr int NT = N2 / 8;       // 16 column strips / output column tiles
constexpr int KC2 = N2 / 16;     // stage 2's 8 k-chunks
constexpr size_t SMEM_LIMIT = 232448;   // a block's shared memory (H100)

// The operand planes of a class (S parts an operand) and form: forms re,
// im (and at 3M re + im) times parts hi (and at HIGH lo; at HIGHEST mid,
// lo); plane q = form * H + part.  The fragment arrays hold P2 parts and the
// wrapper's tables P2 slots a matrix (slot P2 * form + part).
template <int S, bool TM>
struct Planes {
  static constexpr bool HIGH = S == 2;
  static constexpr int H = S;
  static constexpr int P2 = parts(S);
  static constexpr int F = TM ? 3 : 2;
  static constexpr int FH = F * H;
  // Writes the operands of the pairs (r0, r1) and (i0, i1), adjacent
  // columns of one row, at word o (element 2 o) of every plane.
  static __device__ __forceinline__ void put(uint32_t* pl, int ps, int o,
                                             float r0, float r1, float i0,
                                             float i1) {
    if constexpr (S == 3) {
      put_parts3(pl, ps, o, r0, r1);
      put_parts3(pl + 3 * ps, ps, o, i0, i1);
      if (TM)
        put_parts3(pl + 6 * ps, ps, o, __fadd_rn(r0, i0),
                   __fadd_rn(r1, i1));
    } else {
      uint32_t hi, lo;
      operand<HIGH>(r0, r1, hi, lo);
      pl[o] = hi;
      if (HIGH) pl[ps + o] = lo;
      operand<HIGH>(i0, i1, hi, lo);
      pl[H * ps + o] = hi;
      if (HIGH) pl[(H + 1) * ps + o] = lo;
      if (TM) {
        operand<HIGH>(__fadd_rn(r0, i0), __fadd_rn(r1, i1), hi, lo);
        pl[2 * H * ps + o] = hi;
        if (HIGH) pl[(2 * H + 1) * ps + o] = lo;
      }
    }
  }
  // C's pairs of m-tile mt (its rows mt*16..) in column strip j, as
  // twiddle() leaves them, written to every plane (ps elements a plane).
  static __device__ __forceinline__ void put_c(uint32_t* pw, int ps, int mt,
                                               int j, const float (&c)[8]) {
    const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      put(pw, ps / 2, ((mt * 16 + g8 + h * 8) * RS + j * 8 + 2 * t4) >> 1,
          c[2 * h], c[2 * h + 1], c[4 + 2 * h], c[5 + 2 * h]);
  }
  // Stage 1's B fragments (16 rows x 8 columns) of every plane by
  // ldmatrix.trans; lane l's `addr` is row l % 16 of plane l / 16.
  static __device__ __forceinline__ void b_frags(uint32_t (&x)[3][P2][2],
                                                 uint32_t addr, int ps) {
#pragma unroll
    for (int q = 0; q < FH; q += 2) {
      if (q + 1 < FH) {
        uint32_t r[4];
        ldsm4t(r, addr + 2u * q * ps);
        x[q / H][q % H][0] = r[0]; x[q / H][q % H][1] = r[1];
        x[(q + 1) / H][(q + 1) % H][0] = r[2];
        x[(q + 1) / H][(q + 1) % H][1] = r[3];
      } else {
        ldsm2t(x[q / H][q % H][0], x[q / H][q % H][1], addr + 2u * q * ps);
      }
    }
  }
  // Stage 2's A fragments (16 x 16) of every plane by ldmatrix; lane l's
  // `addr` is row l % 8 + 8 ((l / 8) % 2), column 8 (l / 16) of plane 0.
  static __device__ __forceinline__ void a_frags(uint32_t (&c)[3][P2][4],
                                                 uint32_t addr, int ps) {
#pragma unroll
    for (int q = 0; q < FH; ++q) ldsm4(c[q / H][q % H], addr + 2u * q * ps);
  }
  // F1's A fragments, element i of each slot in use: from the wrapper's
  // table (slot P2 f + h) or from its copy in shared memory (slot q).
  static __device__ __forceinline__ void f1_frags(uint32_t (&f)[3][P2][4],
                                                  const uint4* f1, int f1n,
                                                  int i) {
#pragma unroll
    for (int q = 0; q < FH; ++q)
      set4(f[q / H][q % H], __ldg(f1 + (P2 * (q / H) + q % H) * f1n + i));
  }
  static __device__ __forceinline__ void f1_frags_smem(
      uint32_t (&f)[3][P2][4], const uint4* f1s, int f1n, int i) {
#pragma unroll
    for (int q = 0; q < FH; ++q) set4(f[q / H][q % H], f1s[q * f1n + i]);
  }
  static __device__ __forceinline__ void set4(uint32_t (&r)[4], uint4 v) {
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  }
};


// The blocks an SM is to hold of an instantiation with mt m-tiles a pass
// (its launch bounds): two up to 4 (n1p <= 64; 128 registers a thread),
// else one; one at HIGHEST (s = 3), whose planes take an SM's share.
constexpr int min_blocks(int s, int mt) {
  return s > 2 ? 1 : mt <= 4 ? 2 : 1;
}

// Bytes of each shared-memory region for (n1, wb, class, form), in this
// order: the planes; the fold where it fits beside them (else it lives in
// the output rows); F1's fragments where they fit (else read from L2).
// F2^T's fragments are read from L2 (a copy here was no faster at fft
// 2048).  kspec_curscan_tc_smem reports its total.
struct Layout {
  size_t planes, fold, f1;
  size_t total() const { return planes + fold + f1; }
};
// s: the class's parts an operand (1 DEFAULT, 2 HIGH, 3 HIGHEST).
inline Layout layout(int n1, int wb, int s, bool tm) {
  const size_t n1p = (n1 + 15) & ~15, nmt = n1p / 16;
  const size_t fh = static_cast<size_t>(tm ? 3 : 2) * s;
  Layout l;
  l.planes = fh * wb * n1p * RS * 2;
  l.fold = n1p * ROW * sizeof(float);
  l.f1 = fh * nmt * nmt * 32 * 16;
  if (l.planes + l.fold > SMEM_LIMIT) l.fold = 0;
  if (l.total() > SMEM_LIMIT) l.f1 = 0;
  return l;
}

// The twiddles of the 4 elements a lane holds of m-tile ml (its window's
// rows ml*16..), column strip j.
__device__ __forceinline__ void tw_load(float2 (&t)[4],
                                        const float2* __restrict__ tw,
                                        int ml, int j) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    t[i] = __ldg(tw + (ml * 16 + g8 + (i >> 1) * 8) * N2 + j * 8 + 2 * t4
                 + (i & 1));
}

// C = B o T of those 4 elements: c[i] = Re, c[4 + i] = Im, in float32.
template <int S, bool TM>
__device__ __forceinline__ void twiddle(const Acc<TM>& a,
                                        const float2 (&t)[4],
                                        float (&c)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float br, bi;
    a.template complex<(S > 1)>(i, br, bi);
    c[i] = __fsub_rn(__fmul_rn(br, t[i].x), __fmul_rn(bi, t[i].y));
    c[4 + i] = __fadd_rn(__fmul_rn(br, t[i].y), __fmul_rn(bi, t[i].x));
  }
}

// Cut-off read: slabs [j0, j1) of n samples from the block's planes, re +
// im summed slab by slab into acc (n1 rows of rs floats), 4 samples a load.
template <typename T>
__device__ __forceinline__ void fold_slabs(const T* pre, const T* pim,
                                           float* acc, int rs, int n, int j0,
                                           int j1) {
  for (int e = 4 * threadIdx.x; e < n; e += 4 * THREADS) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = j0; j < j1; ++j) {
      const size_t o = static_cast<size_t>(j) * n + e;
      const float4 r = sample4(pre + o), i = sample4(pim + o);
      a[0] = __fadd_rn(__fadd_rn(a[0], r.x), i.x);
      a[1] = __fadd_rn(__fadd_rn(a[1], r.y), i.y);
      a[2] = __fadd_rn(__fadd_rn(a[2], r.z), i.z);
      a[3] = __fadd_rn(__fadd_rn(a[3], r.w), i.w);
    }
    float* p = acc + (e >> 7) * rs + (e & (N2 - 1));
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = a[q];
  }
}

// Cut-off frame: the nb windows staged in the planes (window k in rows
// k n1p..), each element's value as rounded (part_value), re + im weighted
// and folded into acc (rows of rs floats) in window order (window w + k; w0
// first).
template <int S>
__device__ __forceinline__ void fold_planes(const uint16_t* pl, int ps,
                                            float* acc, int rs,
                                            const float* weights, int w,
                                            int nb, int w0, int n1,
                                            int n1p) {
  for (int e = threadIdx.x; e < n1 * N2; e += THREADS) {
    const int r = e >> 7, c = e & (N2 - 1);
    float* p = acc + r * rs + c;
    for (int k = 0; k < nb; ++k) {
      const int o = (k * n1p + r) * RS + c;
      const float xr = part_value<S>(pl, ps, o);
      const float xi = part_value<S>(pl + S * ps, ps, o);
      const float v = __fmul_rn(weights[w + k], __fadd_rn(xr, xi));
      *p = w + k == w0 ? v : __fadd_rn(*p, v);
    }
  }
}

// Cut-offs s1 and s1tw: the 4 elements a lane holds of m-tile ml (its
// window's rows ml*16..), column strip j (re in v[i], im in v[4 + i], as
// twiddle() leaves them), weighted re + im folded into acc (rows of rs
// floats).
__device__ __forceinline__ void fold_tile(float* acc, int rs, int ml, int j,
                                          const float (&v)[8], float wgt,
                                          bool first) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* p = acc + (ml * 16 + g8 + (i >> 1) * 8) * rs + j * 8 + 2 * t4
               + (i & 1);
    const float x = __fmul_rn(wgt, __fadd_rn(v[i], v[4 + i]));
    *p = first ? x : __fadd_rn(*p, x);
  }
}

// The ablate build's C of the 4 elements a lane holds of the pass's m-tile
// mt (its stacked rows mt*16..), column strip j, as twiddle() lays them
// out: B from stage 1's products, or (no_s1) the frame as staged in the
// planes; C = B o T, or (no_tw) B.
template <int S, bool TM>
__device__ __forceinline__ void ablated_c(const Acc<TM>& a, bool no_s1,
                                          bool no_tw, const uint16_t* pl,
                                          int ps, int mt, int j,
                                          const float2 (&t)[4],
                                          float (&c)[8]) {
  constexpr int H = S;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float br, bi;
    if (no_s1) {
      const int o = (mt * 16 + g8 + (i >> 1) * 8) * RS + j * 8 + 2 * t4 +
                    (i & 1);
      br = part_value<S>(pl, ps, o);
      bi = part_value<S>(pl + H * ps, ps, o);
    } else {
      a.template complex<(S > 1)>(i, br, bi);
    }
    if (no_tw) {
      c[i] = br;
      c[4 + i] = bi;
    } else {
      c[i] = __fsub_rn(__fmul_rn(br, t[i].x), __fmul_rn(bi, t[i].y));
      c[4 + i] = __fadd_rn(__fmul_rn(br, t[i].y), __fmul_rn(bi, t[i].x));
    }
  }
}

// Stage 1's tile before the twiddle (cut-off s1): B's 4 elements as
// twiddle() lays out C's.
template <int S, bool TM>
__device__ __forceinline__ void untwiddled(const Acc<TM>& a, float (&c)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.template complex<(S > 1)>(i, c[i], c[4 + i]);
}

// Kernel A.  Grid: t * groups thread blocks; block (b, g) folds windows
// [g*W/G, (g+1)*W/G) of IQ block b, wb windows a pass: their frames are
// stacked in the planes (window i of the pass in rows i*n1p..), so each
// stage is one product over wb * n1p rows.  MT >= wb * n1p / 16 (a power of
// two, at most 8) sizes stage 1's register buffer.  f1 holds F1's A
// fragments [slot][mt][kc][lane] (uint4, slot = P2 * form + part), f2
// F2^T's B fragments [slot][kc][nt][lane] (uint2), tw the (n1p, 128) twiddles
// (zero rows from n1).  fold_smem and f1_smem say which regions layout()
// kept in shared memory.  The ablate build takes its mask in `fold`'s bits
// from AB_SHIFT up.
template <typename T, int S, bool TM, int MT>
__global__ void __launch_bounds__(THREADS, min_blocks(S, MT))
curscan_tc_kernel(const T* __restrict__ re, const T* __restrict__ im,
                  float* __restrict__ out, float* __restrict__ part,
                  const int* __restrict__ starts,
                  const float* __restrict__ weights,
                  const float* __restrict__ window,
                  const uint4* __restrict__ f1, const uint2* __restrict__ f2,
                  const float2* __restrict__ tw, int full, int n, int n1,
                  int n_windows, int groups, int fold, int wb, int fold_smem,
                  int f1_smem) {
  using PL = Planes<S, TM>;
  constexpr int H = PL::H, FH = PL::FH, P2 = PL::P2;
  // Output tiles a warp takes at once: two at DEFAULT from n1p = 80 (one
  // block an SM), else one (the 128 registers of two blocks an SM).
  constexpr int NTW = (S > 1 || MT <= 4) ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n1p = (n1 + 15) & ~15;
  const int nmt = n1p / 16;          // m-tiles of a window, stage 1's K
  const int rows = wb * n1p;         // stacked rows of a pass
  const int ps = rows * RS;          // a plane's elements
  uint16_t* pl = reinterpret_cast<uint16_t*>(smem);
  uint32_t* pw = reinterpret_cast<uint32_t*>(smem);   // pl as words
  const uint32_t pl_s = static_cast<uint32_t>(__cvta_generic_to_shared(pl));
  float* acc = reinterpret_cast<float*>(smem + size_t(FH) * ps * 2);
  const int f1n = nmt * nmt * 32;    // uint4s of one F1 slot
  constexpr int F2N = KC2 * NT * 32;  // uint2s of one F2^T slot
  const uint4* f1s = reinterpret_cast<const uint4*>(
      smem + size_t(FH) * ps * 2 + (fold_smem ? n1p * ROW * 4 : 0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / groups, g = blockIdx.x % groups;
  const int w0 = static_cast<int>(static_cast<long long>(g) * n_windows /
                                  groups);
  const int w1 = static_cast<int>(static_cast<long long>(g + 1) * n_windows /
                                  groups);
  const T* pre = re + static_cast<size_t>(b) * full;
  const T* pim = im + static_cast<size_t>(b) * full;
  const int frame = n1 * N2;
  float* dst = groups > 1
      ? part + (static_cast<size_t>(b) * groups + g) * n
      : out + static_cast<size_t>(b) * n;
#if KSPEC_TC_STOP
  // A cut-off whose fold does not fit beside the planes folds in dst, in
  // K4's layout; ars is the fold's row stride.
  if (!fold_smem) acc = dst;
  const int ars = fold_smem ? ROW : N2;
#else
  constexpr int ars = ROW;
#endif
  // The ablate build's stages to remove (all false in the port's library).
  const int ab = KSPEC_TC_ABLATE ? fold >> AB_SHIFT : 0;
  if (KSPEC_TC_ABLATE) fold = ablated_fold(fold & ((1 << AB_SHIFT) - 1), ab);
  const bool no_win = KSPEC_TC_ABLATE && (ab & AB_WIN);
  const bool no_s1 = KSPEC_TC_ABLATE && (ab & AB_STAGE1);
  const bool no_tw = KSPEC_TC_ABLATE && (ab & AB_TWIDDLE);
  const bool no_s2 = KSPEC_TC_ABLATE && (ab & AB_STAGE2);
  const bool no_sqrt = KSPEC_TC_ABLATE && (ab & AB_SQRT);
  const bool no_cum = KSPEC_TC_ABLATE && (ab & AB_CUMULATE);
  const int nk1 = no_s1 ? 0 : nmt;   // stage 1's k-chunks

  if (KSPEC_TC_STOP == 1) {
    // Cut-off read: group g sums its share of the block's slabs.
    const int slabs = full / n;
    fold_slabs(pre, pim, acc, ars, n, g * slabs / groups,
               (g + 1) * slabs / groups);
  } else {
    // Padded rows (n1..n1p-1 of each window) stay zero; C's are zero
    // there.  The planes' rows start on 16 bytes (the wrapper's check,
    // full % 128 == 0), so a start that is a multiple of 4 reads 4
    // samples a load.
    for (int i = tid; i < FH * ps / 2; i += THREADS) pw[i] = 0u;
    // F1's slots in use: plane q's from the wrapper's slot 2 f + h.
    if (f1_smem) {
      uint4* d = const_cast<uint4*>(f1s);
      for (int i = tid; i < FH * f1n; i += THREADS) {
        const int q = i / f1n;
        d[i] = __ldg(f1 + (P2 * (q / H) + q % H) * f1n + i % f1n);
      }
    }
  }
  __syncthreads();

  const int w_end = KSPEC_TC_STOP == 1 ? w0 : w1;
  for (int w = w0; w < w_end; w += wb) {
    const int nb = min(wb, w1 - w);  // windows in this pass
    const int mts = nb * nmt;        // m-tiles in this pass
    for (int k = 0; k < nb; ++k) {
      const int s = starts[w + k];
      uint32_t* fw = pw + k * n1p * RS / 2;
      if ((s & 3) == 0) {   // 4 samples a thread a load (planes aligned)
        for (int e = 4 * tid; e < frame; e += 4 * THREADS) {
          const int o = ((e >> 7) * RS + (e & (N2 - 1))) >> 1;
          const float4 wv = no_win ? make_float4(1.f, 1.f, 1.f, 1.f)
              : __ldg(reinterpret_cast<const float4*>(window + e));
          const float4 a = sample4(pre + s + e), c = sample4(pim + s + e);
          PL::put(fw, ps / 2, o, __fmul_rn(a.x, wv.x), __fmul_rn(a.y, wv.y),
                  __fmul_rn(c.x, wv.x), __fmul_rn(c.y, wv.y));
          PL::put(fw, ps / 2, o + 1, __fmul_rn(a.z, wv.z),
                  __fmul_rn(a.w, wv.w), __fmul_rn(c.z, wv.z),
                  __fmul_rn(c.w, wv.w));
        }
      } else {              // 2 samples a thread (a row holds 128)
        for (int e = 2 * tid; e < frame; e += 2 * THREADS) {
          const int o = ((e >> 7) * RS + (e & (N2 - 1))) >> 1;
          const float2 wv = no_win ? make_float2(1.f, 1.f)
              : __ldg(reinterpret_cast<const float2*>(window + e));
          PL::put(fw, ps / 2, o, __fmul_rn(sample(pre, s + e), wv.x),
                  __fmul_rn(sample(pre, s + e + 1), wv.y),
                  __fmul_rn(sample(pim, s + e), wv.x),
                  __fmul_rn(sample(pim, s + e + 1), wv.y));
        }
      }
    }
    __syncthreads();
    if (KSPEC_TC_STOP == 2) {
      fold_planes<S>(pl, ps, acc, ars, weights, w, nb, w0, n1, n1p);
      __syncthreads();
      continue;
    }

    // Stage 1: B = F1 A, C = B o T written over the frame.  One window a
    // pass of 5-8 m-tiles (n1p >= 80; not 3M HIGH nor HIGHEST, whose F1
    // fragments would take up to 192 registers or more): by m-tiles, warp
    // w keeping m-tile w's F1 fragments in registers, loaded once a pass,
    // the warps walking the strips together and writing each after a
    // barrier.  Else by column strips: warp j % 8 owns strip j of every
    // row, reads only it and writes C over it.
    if (MT == 8 && FH <= 4 && wb == 1) {
      uint32_t fa[MT][3][P2][4];
      if (warp < mts) {
#pragma unroll
        for (int kc = 0; kc < MT; ++kc) {
          if (kc < nk1) {
            const int i = (warp * nmt + kc) * 32 + lane;
            if (f1_smem) PL::f1_frags_smem(fa[kc], f1s, f1n, i);
            else PL::f1_frags(fa[kc], f1, f1n, i);
          }
        }
      }
      float2 tn[4];            // the next strip's twiddles, loaded ahead
      if (warp < mts && !no_tw) tw_load(tn, tw, warp, 0);
      for (int j = 0; j < NT; ++j) {
        float cv[8];
        if (warp < mts) {
          const float2 t[4] = {tn[0], tn[1], tn[2], tn[3]};
          if (j + 1 < NT && !no_tw) tw_load(tn, tw, warp, j + 1);
          Acc<TM> a;
          a.zero();
#pragma unroll
          for (int kc = 0; kc < MT; ++kc) {
            if (kc < nk1) {
              uint32_t x[3][P2][2];
              PL::b_frags(x, pl_s + 2u * ((lane >> 4) * ps +
                          (kc * 16 + (lane & 15)) * RS + j * 8), ps);
              KSPEC_CLASS_PRODUCTS(a, fa[kc], x);
            }
          }
          if (KSPEC_TC_STOP == 3) untwiddled<S>(a, cv);
          else if (no_s1 || no_tw)
            ablated_c<S>(a, no_s1, no_tw, pl, ps, warp, j, t, cv);
          else twiddle<S>(a, t, cv);
        }
        __syncthreads();
        if (warp < mts) {
          if (KSPEC_TC_STOP != 3) PL::put_c(pw, ps, warp, j, cv);
          if (KSPEC_TC_STOP == 3 || KSPEC_TC_STOP == 4)
            fold_tile(acc, ars, warp, j, cv, weights[w], w == w0);
        }
      }
    } else {
      for (int j = warp; j < NT; j += WARPS) {
        float cbuf[MT][8];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt < mts) {
            const int ml = mt % nmt, base = (mt - ml) * 16;  // window's row 0
            Acc<TM> a;
            a.zero();
            for (int kc = 0; kc < nk1; ++kc) {
              uint32_t x[3][P2][2], f[3][P2][4];
              PL::b_frags(x, pl_s + 2u * ((lane >> 4) * ps +
                          (base + kc * 16 + (lane & 15)) * RS + j * 8), ps);
              const int i = (ml * nmt + kc) * 32 + lane;
              if (f1_smem) PL::f1_frags_smem(f, f1s, f1n, i);
              else PL::f1_frags(f, f1, f1n, i);
              KSPEC_CLASS_PRODUCTS(a, f, x);
            }
            if (KSPEC_TC_STOP == 3) {
              untwiddled<S>(a, cbuf[mt]);
            } else {
              float2 t[4];
              if (!no_tw) tw_load(t, tw, ml, j);
              if (no_s1 || no_tw)
                ablated_c<S>(a, no_s1, no_tw, pl, ps, mt, j, t, cbuf[mt]);
              else twiddle<S>(a, t, cbuf[mt]);
            }
          }
        }
        __syncwarp();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt < mts) {
            if (KSPEC_TC_STOP != 3) PL::put_c(pw, ps, mt, j, cbuf[mt]);
            if (KSPEC_TC_STOP == 3 || KSPEC_TC_STOP == 4) {
              const int k = mt / nmt;   // window w + k, in window order
              fold_tile(acc, ars, mt % nmt, j, cbuf[mt], weights[w + k],
                        w + k == w0);
            }
          }
        }
      }
    }
    __syncthreads();
    if (KSPEC_TC_STOP == 3 || KSPEC_TC_STOP == 4) continue;

    // Stage 2: D = C F2^T by output column tiles over the stacked rows, each
    // tile's F2^T fragments held in registers; |D| folded in place, window
    // by window in order (a window's tiles come after the previous one's).
    for (int nt0 = warp; nt0 < NT; nt0 += NTW * WARPS) {
      uint32_t fb[NTW][KC2][3][P2][2];
      if (!no_s2) {
#pragma unroll
        for (int u = 0; u < NTW; ++u)
#pragma unroll
          for (int kc = 0; kc < KC2; ++kc)
#pragma unroll
            for (int q = 0; q < FH; ++q) {
              const uint2 v = __ldg(f2 + (P2 * (q / H) + q % H) * F2N +
                                    (kc * NT + nt0 + u * WARPS) * 32 + lane);
              fb[u][kc][q / H][q % H][0] = v.x;
              fb[u][kc][q / H][q % H][1] = v.y;
            }
      }
      for (int mt = 0; mt < mts; ++mt) {
        const int ml = mt % nmt, k = mt / nmt;   // tile of window w + k
        Acc<TM> a[NTW];
#pragma unroll
        for (int u = 0; u < NTW; ++u) a[u].zero();
        // A fragments of rows mt*16.., columns kc*16..: lane l addresses
        // row l % 8 + 8 ((l / 8) % 2), column 8 (l / 16).
        const uint32_t addr = pl_s + 2u * ((mt * 16 + (lane & 7) +
            ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8);
        if (!no_s2) {
#pragma unroll
          for (int kc = 0; kc < KC2; ++kc) {
            uint32_t c[3][P2][4];
            PL::a_frags(c, addr + 2u * kc * 16, ps);
#pragma unroll
            for (int u = 0; u < NTW; ++u)
              KSPEC_CLASS_PRODUCTS(a[u], c, fb[u][kc]);
          }
        }
        const float wgt = no_cum ? 1.f : weights[w + k];
        const bool first = w + k == w0;
#pragma unroll
        for (int u = 0; u < NTW; ++u) {
          const int nt = nt0 + u * WARPS;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k1 = ml * 16 + g8 + h * 8;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float dr, di;
              if (no_s2) {   // D = C as staged for stage 2
                const int o = (mt * 16 + g8 + h * 8) * RS + nt * 8 + 2 * t4
                              + e;
                dr = part_value<S>(pl, ps, o);
                di = part_value<S>(pl + H * ps, ps, o);
              } else {
                a[u].template complex<(S > 1)>(2 * h + e, dr, di);
              }
              const float sq = __fadd_rn(__fmul_rn(dr, dr),
                                         __fmul_rn(di, di));
              // cut-off s2: D's re + im in place of |D|
              const float mag = KSPEC_TC_STOP == 5 ? __fadd_rn(dr, di)
                  : no_sqrt ? sq : __fsqrt_rn(sq);
              v[e] = __fmul_rn(wgt, mag);
            }
            if (fold_smem) {
              float2* p = reinterpret_cast<float2*>(
                  acc + k1 * ROW + nt * 8 + 2 * t4);
              if (first) {
                *p = make_float2(v[0], v[1]);
              } else {
                const float2 q = *p;
                *p = make_float2(fold_op(fold, q.x, v[0]),
                                 fold_op(fold, q.y, v[1]));
              }
            } else if (k1 < n1) {   // fold in dst, fftshifted
#pragma unroll
              for (int e = 0; e < 2; ++e) {
#if KSPEC_TC_STOP                   // cut-off s2: K4's layout
                float* p = dst + k1 * N2 + nt * 8 + 2 * t4 + e;
#else
                const int x = k1 + n1 * (nt * 8 + 2 * t4 + e);
                float* p = dst + (x + n / 2) % n;
#endif
                *p = first ? v[e] : fold_op(fold, *p, v[e]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // X[k1 + n1 k2] = acc[k1][k2], stored fftshifted; a cut-off's reduction
  // in K4's layout, acc[r][c] at r * 128 + c.
  if (fold_smem) {
    for (int o = tid; o < n; o += THREADS) {
      const int x = (o + n / 2) % n;
      dst[o] = KSPEC_TC_STOP ? acc[(o >> 7) * ROW + (o & (N2 - 1))]
                             : acc[(x % n1) * ROW + x / n1];
    }
  }
}

template <typename T, int S, bool TM, int MT>
int launch_one(const void* re, const void* im, void* out, void* part,
               const void* starts, const void* weights, const void* window,
               const void* f1, const void* f2, const void* tw, int t,
               int full, int n, int n1, int n_windows, int groups, int fold,
               int wb, cudaStream_t stream) {
  const Layout l = layout(n1, wb, S, TM);
  const size_t smem = l.total();
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {        // above the default only on request
    const cudaError_t err = cudaFuncSetAttribute(
        curscan_tc_kernel<T, S, TM, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  curscan_tc_kernel<T, S, TM, MT><<<t * groups, THREADS, smem, stream>>>(
      static_cast<const T*>(re), static_cast<const T*>(im),
      static_cast<float*>(out), static_cast<float*>(part),
      static_cast<const int*>(starts), static_cast<const float*>(weights),
      static_cast<const float*>(window), static_cast<const uint4*>(f1),
      static_cast<const uint2*>(f2), static_cast<const float2*>(tw), full, n,
      n1, n_windows, groups, fold, wb, l.fold > 0, l.f1 > 0);
  return static_cast<int>(cudaGetLastError());
}

// Blocks an SM holds of the instantiation (registers and shared memory).
template <typename T, int S, bool TM, int MT>
int occupancy_one(int n1, int wb) {
  int blocks = 0;
  const size_t smem = layout(n1, wb, S, TM).total();
  if (smem > SMEM_LIMIT) return -1;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(curscan_tc_kernel<T, S, TM, MT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, curscan_tc_kernel<T, S, TM, MT>, THREADS, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// CALL(T, TM, MT) for the instantiation of (is_u8, three_mult) with nmt
// m-tiles a pass; a cut-off build has float32 4M alone (`fails` for the
// rest).
#define KSPEC_TC_MT(CALL, T, TM)                                            \
  (nmt <= 1 ? CALL(T, TM, 1) : nmt <= 2 ? CALL(T, TM, 2)                   \
   : nmt <= 4 ? CALL(T, TM, 4) : CALL(T, TM, 8))
#if KSPEC_TC_STOP
#define KSPEC_TC_DISPATCH(CALL)                                             \
  (is_u8 || three_mult ? fails : KSPEC_TC_MT(CALL, float, false))
#else
#define KSPEC_TC_DISPATCH(CALL)                                             \
  (is_u8 ? (three_mult ? KSPEC_TC_MT(CALL, uint8_t, true)                  \
                       : KSPEC_TC_MT(CALL, uint8_t, false))                \
         : (three_mult ? KSPEC_TC_MT(CALL, float, true)                    \
                       : KSPEC_TC_MT(CALL, float, false)))
#endif

// The instantiation for (input, form, MT) at one class (S parts an
// operand).
template <int S>
int launch_class(int is_u8, int three_mult, const void* re, const void* im,
                 void* out, void* part, const void* starts,
                 const void* weights, const void* window, const void* f1,
                 const void* f2, const void* tw, int t, int full, int n,
                 int n1, int n_windows, int groups, int fold, int wb,
                 cudaStream_t stream) {
  const int nmt = wb * ((n1 + 15) / 16);   // m-tiles of a pass
  const int fails = static_cast<int>(cudaErrorInvalidValue);
  if (n1 < 2 || n1 > 128 || n != n1 * N2 || wb < 1 || nmt > 8) return fails;
#define KSPEC_TC_LAUNCH(T, TM, MT)                                          \
  launch_one<T, S, TM, MT>(re, im, out, part, starts, weights, window,     \
                           f1, f2, tw, t, full, n, n1, n_windows, groups,  \
                           fold, wb, stream)
  return KSPEC_TC_DISPATCH(KSPEC_TC_LAUNCH);
#undef KSPEC_TC_LAUNCH
}

// The blocks an SM holds of the instantiation launch_class<S> launches
// for these arguments, or -1.
template <int S>
int occupancy_class(int is_u8, int three_mult, int n1, int wb) {
  const int nmt = wb * ((n1 + 15) / 16);
  const int fails = -1;
  if (n1 < 2 || n1 > 128 || wb < 1 || nmt > 8) return fails;
#define KSPEC_TC_OCCUPANCY(T, TM, MT) occupancy_one<T, S, TM, MT>(n1, wb)
  return KSPEC_TC_DISPATCH(KSPEC_TC_OCCUPANCY);
#undef KSPEC_TC_OCCUPANCY
}
#undef KSPEC_TC_DISPATCH
#undef KSPEC_TC_MT

// The launchers and occupancy queries of the two classes, one class per
// translation unit (in a -DKSPEC_TC_HIGHEST=1 build launch_high and
// occupancy_high run HIGHEST and the DEFAULT ones refuse).
int launch_default(int is_u8, int three_mult, const void* re, const void* im,
                   void* out, void* part, const void* starts,
                   const void* weights, const void* window, const void* f1,
                   const void* f2, const void* tw, int t, int full, int n,
                   int n1, int n_windows, int groups, int fold, int wb,
                   cudaStream_t stream);
int launch_high(int is_u8, int three_mult, const void* re, const void* im,
                void* out, void* part, const void* starts,
                const void* weights, const void* window, const void* f1,
                const void* f2, const void* tw, int t, int full, int n,
                int n1, int n_windows, int groups, int fold, int wb,
                cudaStream_t stream);
int occupancy_default(int is_u8, int three_mult, int n1, int wb);
int occupancy_high(int is_u8, int three_mult, int n1, int wb);

}  // namespace kspec_tc
