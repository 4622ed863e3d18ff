// Tensor-core two-stage DFT curscan kernel (Kernel A) for NVIDIA Hopper
// (sm_90a): the HIGH and DEFAULT precision classes of K1 and of K3's cell on
// the 128 grid.  Device code, instantiated by curscan_tc.cu (DEFAULT, and the
// C entry point) and curscan_tc_high.cu (HIGH): two nvcc runs in parallel.
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
// and sums in float32 on mma.sync m16n8k16: once at DEFAULT, and at HIGH as
// the bf16x3 split a_hi b_hi + (a_hi b_lo + a_lo b_hi), the hi/lo halves of
// B's operand C taken from its float32 value.  The complex products are 3M
// (T1 = Fr Xr, T2 = Fi Xi, T3 = (Fr + Fi)(Xr + Xi); Re = T1 - T2,
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
// is high (3 products of 2 * n1 * 128 * (n1 + 128) flops a window at 3M,
// times 3 at HIGH, at 989 TFLOP/s bf16), else the planes read once.
//
// What the design does about it (a right, simple first design):
//   * A thread block takes one IQ block and a group of its windows, 256
//     threads, and walks the windows in order, wb at a time (a pass; the
//     wrapper picks wb so that a pass stacks at most 64 rows, 4 windows at
//     fft 2048, one at fft >= 8192).  Per pass: the threads stage the
//     windowed frames (float32, u8 decoded in the load; 4 samples a load
//     where the start is a multiple of 4) in shared memory,
//     window i in rows i*n1p..; stage 1 runs by column strips, warp j%8
//     owning the 8 columns j*8.. of every row, so it reads only its own
//     strip and writes C over it in place (held in registers until the
//     strip is done); stage 2 runs by output column tiles over all the
//     pass's rows, each warp holding its tile's F2^T fragments in registers
//     (one load of the table a tile a pass), and folds each output element
//     in the shared fold buffer that only its own lane touches, window by
//     window in order.  Three barriers a pass.
//   * Shared memory: the frame/C planes and the fold, (2 wb + 1) * n1p * 136
//     floats (n1p = n1 rounded up to 16; 208,896 bytes at n1 = 128).  Rows
//     of 136 floats make the float2 fragment loads of stage 2 conflict-free.
//   * The DFT tables do not fit beside them at n1 = 128 (DEFAULT 3M needs
//     Fr, Fi, Fr + Fi for both stages, 192 KB in bf16; HIGH twice that), so
//     the warps load their mma fragments straight from global memory, where
//     the wrapper stores them pre-rounded in fragment order (one 16-byte
//     load a thread for F1's A fragments, 8 bytes for F2^T's B fragments);
//     all tables together are under 0.5 MB and stay in L2.  That costs
//     table traffic: stage 1 streams F1 once per column strip (16 times a
//     pass), stage 2 F2^T once per column tile a pass.
//   * n1 and K are padded to 16 with zero rows and columns of F1 (exact);
//     padded rows of C are zero and never stored to the output.
//   * Window groups: where T alone does not fill the card, G thread blocks
//     share an IQ block, each folding a contiguous range of windows; a
//     second kernel combines the G partial folds in group order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Forensic cut-offs (profiling only: scripts/tc_stages.py compiles these
// sources with -DKSPEC_TC_STOP=1 or 2 into a library of its own; the port's
// library leaves it 0).  1 stops each pass after its frames are staged, 2
// after stage 1; the output then holds the first rows of the frame/C plane
// (re) in place of the fold, wrong by construction.
#ifndef KSPEC_TC_STOP
#define KSPEC_TC_STOP 0
#endif

namespace kspec_tc {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int N2 = 128;          // the sublane layout's fixed n2
constexpr int ROW = N2 + 8;      // shared-memory row stride in floats
constexpr int NT = N2 / 8;       // 16 column strips / output column tiles
constexpr int KC2 = N2 / 16;     // stage 2's 8 k-chunks

enum Fold { FOLD_SUM = 0, FOLD_MAX = 1, FOLD_MIN = 2 };

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (x0 in the low half), each to nearest even.
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An operand pair rounded for the class: hi = bf16(x); at HIGH also
// lo = bf16(x - hi), from the float32 value.
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

// Products kept per tile: 3M T1, T2, T3; 4M rr, ii, ri, ir.  Each is
// a_hi b_hi, and at HIGH also a_hi b_lo and a_lo b_hi, three independent
// float32 sums (three mma chains) added as hh + (hl + lh), as dot3 adds them.
template <bool TM>
struct Acc {
  static constexpr int P = TM ? 3 : 4;
  float hh[P][4], hl[P][4], lh[P][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) hh[p][i] = hl[p][i] = lh[p][i] = 0.f;
  }
  // Product p's fragments at the class.
  template <bool HIGH>
  __device__ __forceinline__ void product(int p, const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4],
                                          const uint32_t (&bhi)[2],
                                          const uint32_t (&blo)[2]) {
    mma(hh[p], ahi, bhi[0], bhi[1]);
    if (HIGH) {
      mma(hl[p], ahi, blo[0], blo[1]);
      mma(lh[p], alo, bhi[0], bhi[1]);
    }
  }
  template <bool HIGH>
  __device__ __forceinline__ float value(int p, int i) const {
    return HIGH ? __fadd_rn(hh[p][i], __fadd_rn(hl[p][i], lh[p][i]))
                : hh[p][i];
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

// Operand forms of one fragment register set: re, im and (3M) re + im, each
// with hi and lo halves.
template <int R>
struct Forms {
  uint32_t hi[3][R];
  uint32_t lo[3][R];
};

template <bool HIGH, bool TM, int R>
__device__ __forceinline__ void forms_of(const float (&xr)[2 * R],
                                         const float (&xi)[2 * R],
                                         Forms<R>& f) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    operand<HIGH>(xr[2 * r], xr[2 * r + 1], f.hi[0][r], f.lo[0][r]);
    operand<HIGH>(xi[2 * r], xi[2 * r + 1], f.hi[1][r], f.lo[1][r]);
    if (TM)
      operand<HIGH>(__fadd_rn(xr[2 * r], xi[2 * r]),
                    __fadd_rn(xr[2 * r + 1], xi[2 * r + 1]), f.hi[2][r],
                    f.lo[2][r]);
  }
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

// Four consecutive samples from a 16-byte (float) or 4-byte (u8) aligned
// address.
template <typename T>
__device__ __forceinline__ float4 sample4(const T* p);
template <>
__device__ __forceinline__ float4 sample4<float>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <>
__device__ __forceinline__ float4 sample4<uint8_t>(const uint8_t* p) {
  const uchar4 v = __ldg(reinterpret_cast<const uchar4*>(p));
  return make_float4(static_cast<float>(v.x) - 127.0f,
                     static_cast<float>(v.y) - 127.0f,
                     static_cast<float>(v.z) - 127.0f,
                     static_cast<float>(v.w) - 127.0f);
}

__device__ __forceinline__ float fold_op(int fold, float acc, float v) {
  return fold == FOLD_SUM ? __fadd_rn(acc, v)
         : fold == FOLD_MAX ? fmaxf(acc, v) : fminf(acc, v);
}

// Kernel A.  Grid: t * groups thread blocks; block (b, g) folds windows
// [g*W/G, (g+1)*W/G) of IQ block b, wb windows a pass: their frames are
// stacked in shared memory (window i of the pass in rows i*n1p..), so each
// stage is one product over wb * n1p rows.  MT >= wb * n1p / 16 (a power of
// two, at most 8) sizes stage 1's register buffer.  f1 holds F1's A
// fragments [slot][mt][kc][lane] (uint4), f2 F2^T's B fragments
// [slot][kc][nt][lane] (uint2), tw the (n1p, 128) twiddles (zero rows from
// n1).
template <typename T, bool HIGH, bool TM, int MT>
__global__ void __launch_bounds__(THREADS)
curscan_tc_kernel(const T* __restrict__ re, const T* __restrict__ im,
                  float* __restrict__ out, float* __restrict__ part,
                  const int* __restrict__ starts,
                  const float* __restrict__ weights,
                  const float* __restrict__ window,
                  const uint4* __restrict__ f1, const uint2* __restrict__ f2,
                  const float2* __restrict__ tw, int full, int n, int n1,
                  int n_windows, int groups, int fold, int wb) {
  extern __shared__ float smem[];
  const int n1p = (n1 + 15) & ~15;
  const int nmt = n1p / 16;          // m-tiles of a window, stage 1's K
  const int rows = wb * n1p;         // stacked rows of a pass
  float* xr = smem;                  // frames, then C (re)
  float* xi = smem + rows * ROW;     // frames, then C (im)
  float* acc = smem + 2 * rows * ROW;  // the fold, (n1p, ROW)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / groups, g = blockIdx.x % groups;
  const int w0 = static_cast<int>(static_cast<long long>(g) * n_windows /
                                  groups);
  const int w1 = static_cast<int>(static_cast<long long>(g + 1) * n_windows /
                                  groups);
  const T* pre = re + static_cast<size_t>(b) * full;
  const T* pim = im + static_cast<size_t>(b) * full;
  constexpr int S = TM ? 3 : 2;      // operand forms in use
  const int frame = n1 * N2;

  // Padded rows (n1..n1p-1 of each window) stay zero; C's are zero there.
  // The planes' rows start on 16 bytes (the wrapper's check, full % 128
  // == 0), so a start that is a multiple of 4 reads 4 samples a load.
  for (int i = tid; i < 2 * rows * ROW; i += THREADS) smem[i] = 0.f;
  __syncthreads();

  for (int w = w0; w < w1; w += wb) {
    const int nb = min(wb, w1 - w);  // windows in this pass
    const int mts = nb * nmt;        // m-tiles in this pass
    for (int k = 0; k < nb; ++k) {
      const int s = starts[w + k];
      float* fr = xr + k * n1p * ROW;
      float* fi = xi + k * n1p * ROW;
      if ((s & 3) == 0) {   // 4 samples a thread a load (planes aligned)
        for (int e = 4 * tid; e < frame; e += 4 * THREADS) {
          const int o = (e >> 7) * ROW + (e & (N2 - 1));
          const float4 wv = __ldg(reinterpret_cast<const float4*>(window + e));
          const float4 a = sample4(pre + s + e), c = sample4(pim + s + e);
          *reinterpret_cast<float4*>(fr + o) = make_float4(
              __fmul_rn(a.x, wv.x), __fmul_rn(a.y, wv.y),
              __fmul_rn(a.z, wv.z), __fmul_rn(a.w, wv.w));
          *reinterpret_cast<float4*>(fi + o) = make_float4(
              __fmul_rn(c.x, wv.x), __fmul_rn(c.y, wv.y),
              __fmul_rn(c.z, wv.z), __fmul_rn(c.w, wv.w));
        }
      } else {
        for (int e = tid; e < frame; e += THREADS) {
          const int o = (e >> 7) * ROW + (e & (N2 - 1));
          const float wv = __ldg(window + e);
          fr[o] = __fmul_rn(sample(pre, s + e), wv);
          fi[o] = __fmul_rn(sample(pim, s + e), wv);
        }
      }
    }
    __syncthreads();
    if (KSPEC_TC_STOP == 1) continue;

    // Stage 1: B = F1 A by column strips, C = B o T written over the strip.
    for (int j = warp; j < NT; j += WARPS) {
      const int col = j * 8 + g8;
      float cbuf[MT][8];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mts) {
          const int ml = mt % nmt, base = (mt - ml) * 16;  // window's row 0
          Acc<TM> a;
          a.zero();
          for (int kc = 0; kc < nmt; ++kc) {
            const int r0 = base + kc * 16 + 2 * t4;
            float vr[4], vi[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = r0 + (q & 1) + (q >> 1) * 8;
              vr[q] = xr[row * ROW + col];
              vi[q] = xi[row * ROW + col];
            }
            Forms<2> x;
            forms_of<HIGH, TM, 2>(vr, vi, x);
            uint32_t fh[3][4], fl[3][4];
#pragma unroll
            for (int f = 0; f < S; ++f) {
              const uint4 h = __ldg(f1 + ((((2 * f) * nmt + ml) * nmt + kc)
                                          * 32 + lane));
              fh[f][0] = h.x; fh[f][1] = h.y; fh[f][2] = h.z; fh[f][3] = h.w;
              if (HIGH) {
                const uint4 l = __ldg(f1 + ((((2 * f + 1) * nmt + ml) * nmt
                                              + kc) * 32 + lane));
                fl[f][0] = l.x; fl[f][1] = l.y; fl[f][2] = l.z;
                fl[f][3] = l.w;
              }
            }
            if (TM) {
              a.template product<HIGH>(0, fh[0], fl[0], x.hi[0], x.lo[0]);
              a.template product<HIGH>(1, fh[1], fl[1], x.hi[1], x.lo[1]);
              a.template product<HIGH>(2, fh[2], fl[2], x.hi[2], x.lo[2]);
            } else {   // F1r Ar, F1i Ai, F1r Ai, F1i Ar
              a.template product<HIGH>(0, fh[0], fl[0], x.hi[0], x.lo[0]);
              a.template product<HIGH>(1, fh[1], fl[1], x.hi[1], x.lo[1]);
              a.template product<HIGH>(2, fh[0], fl[0], x.hi[1], x.lo[1]);
              a.template product<HIGH>(3, fh[1], fl[1], x.hi[0], x.lo[0]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k1 = ml * 16 + g8 + (i >> 1) * 8;
            const int m2 = j * 8 + 2 * t4 + (i & 1);
            float br, bi;
            a.template complex<HIGH>(i, br, bi);
            const float2 t = __ldg(tw + k1 * N2 + m2);
            cbuf[mt][i] = __fsub_rn(__fmul_rn(br, t.x), __fmul_rn(bi, t.y));
            cbuf[mt][4 + i] = __fadd_rn(__fmul_rn(br, t.y),
                                        __fmul_rn(bi, t.x));
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mts) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = (mt * 16 + g8 + h * 8) * ROW + j * 8 + 2 * t4;
            *reinterpret_cast<float2*>(xr + o) =
                make_float2(cbuf[mt][2 * h], cbuf[mt][2 * h + 1]);
            *reinterpret_cast<float2*>(xi + o) =
                make_float2(cbuf[mt][4 + 2 * h], cbuf[mt][5 + 2 * h]);
          }
        }
      }
    }
    __syncthreads();
    if (KSPEC_TC_STOP == 2) continue;

    // Stage 2: D = C F2^T by output column tiles over the stacked rows, each
    // tile's F2^T fragments held in registers; |D| folded in place, window
    // by window in order (a window's tiles come after the previous one's).
    for (int nt = warp; nt < NT; nt += WARPS) {
      uint32_t fh[KC2][3][2], fl[KC2][3][2];
#pragma unroll
      for (int kc = 0; kc < KC2; ++kc) {
#pragma unroll
        for (int f = 0; f < S; ++f) {
          const uint2 h = __ldg(f2 + (((2 * f) * KC2 + kc) * NT + nt) * 32
                                + lane);
          fh[kc][f][0] = h.x; fh[kc][f][1] = h.y;
          if (HIGH) {
            const uint2 l = __ldg(f2 + (((2 * f + 1) * KC2 + kc) * NT + nt)
                                  * 32 + lane);
            fl[kc][f][0] = l.x; fl[kc][f][1] = l.y;
          }
        }
      }
      for (int mt = 0; mt < mts; ++mt) {
        const int ml = mt % nmt, k = mt / nmt;   // tile of window w + k
        Acc<TM> a;
        a.zero();
#pragma unroll
        for (int kc = 0; kc < KC2; ++kc) {
          float vr[8], vi[8];
#pragma unroll
          for (int q = 0; q < 4; ++q) {   // a0..a3: (g, 2t), (g+8, 2t),
            const int row = mt * 16 + g8 + (q & 1) * 8;   // (g, 2t+8), ...
            const int c = kc * 16 + 2 * t4 + (q >> 1) * 8;
            const float2 pr = *reinterpret_cast<const float2*>(
                xr + row * ROW + c);
            const float2 pi = *reinterpret_cast<const float2*>(
                xi + row * ROW + c);
            vr[2 * q] = pr.x; vr[2 * q + 1] = pr.y;
            vi[2 * q] = pi.x; vi[2 * q + 1] = pi.y;
          }
          Forms<4> c;
          forms_of<HIGH, TM, 4>(vr, vi, c);
          if (TM) {
            a.template product<HIGH>(0, c.hi[0], c.lo[0],
                                     fh[kc][0], fl[kc][0]);
            a.template product<HIGH>(1, c.hi[1], c.lo[1],
                                     fh[kc][1], fl[kc][1]);
            a.template product<HIGH>(2, c.hi[2], c.lo[2],
                                     fh[kc][2], fl[kc][2]);
          } else {   // Cr F2r, Ci F2i, Ci F2r, Cr F2i
            a.template product<HIGH>(0, c.hi[0], c.lo[0],
                                     fh[kc][0], fl[kc][0]);
            a.template product<HIGH>(1, c.hi[1], c.lo[1],
                                     fh[kc][1], fl[kc][1]);
            a.template product<HIGH>(2, c.hi[1], c.lo[1],
                                     fh[kc][0], fl[kc][0]);
            a.template product<HIGH>(3, c.hi[0], c.lo[0],
                                     fh[kc][1], fl[kc][1]);
          }
        }
        const float wgt = weights[w + k];
        const bool first = w + k == w0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = (ml * 16 + g8 + h * 8) * ROW + nt * 8 + 2 * t4;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float dr, di;
            a.template complex<HIGH>(2 * h + e, dr, di);
            const float mag = __fsqrt_rn(
                __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di)));
            v[e] = __fmul_rn(wgt, mag);
          }
          float2* p = reinterpret_cast<float2*>(acc + o);
          if (first) {
            *p = make_float2(v[0], v[1]);
          } else {
            const float2 q = *p;
            *p = make_float2(fold_op(fold, q.x, v[0]), fold_op(fold, q.y,
                                                               v[1]));
          }
        }
      }
    }
    __syncthreads();
  }

  // X[k1 + n1 k2] = acc[k1][k2], stored fftshifted.
  float* dst = groups > 1
      ? part + (static_cast<size_t>(b) * groups + g) * n
      : out + static_cast<size_t>(b) * n;
  const float* src = KSPEC_TC_STOP ? xr : acc;
  for (int o = tid; o < n; o += THREADS) {
    const int x = (o + n / 2) % n;
    dst[o] = src[(x % n1) * ROW + x / n1];
  }
}

inline size_t smem_bytes(int n1, int wb) {
  return static_cast<size_t>(2 * wb + 1) * ((n1 + 15) & ~15) * ROW *
         sizeof(float);
}

template <typename T, bool HIGH, bool TM, int MT>
int launch_one(const void* re, const void* im, void* out, void* part,
               const void* starts, const void* weights, const void* window,
               const void* f1, const void* f2, const void* tw, int t,
               int full, int n, int n1, int n_windows, int groups, int fold,
               int wb, cudaStream_t stream) {
  const size_t smem = smem_bytes(n1, wb);
  if (smem > 48 * 1024) {        // above the default only on request
    const cudaError_t err = cudaFuncSetAttribute(
        curscan_tc_kernel<T, HIGH, TM, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  curscan_tc_kernel<T, HIGH, TM, MT><<<t * groups, THREADS, smem, stream>>>(
      static_cast<const T*>(re), static_cast<const T*>(im),
      static_cast<float*>(out), static_cast<float*>(part),
      static_cast<const int*>(starts), static_cast<const float*>(weights),
      static_cast<const float*>(window), static_cast<const uint4*>(f1),
      static_cast<const uint2*>(f2), static_cast<const float2*>(tw), full, n,
      n1, n_windows, groups, fold, wb);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for (input, form, MT) at one class.
template <bool HIGH>
int launch_class(int is_u8, int three_mult, const void* re, const void* im,
                 void* out, void* part, const void* starts,
                 const void* weights, const void* window, const void* f1,
                 const void* f2, const void* tw, int t, int full, int n,
                 int n1, int n_windows, int groups, int fold, int wb,
                 cudaStream_t stream) {
  const int nmt = wb * ((n1 + 15) / 16);   // m-tiles of a pass
#define KSPEC_TC(T, TM, MT)                                                 \
  launch_one<T, HIGH, TM, MT>(re, im, out, part, starts, weights, window,  \
                              f1, f2, tw, t, full, n, n1, n_windows,       \
                              groups, fold, wb, stream)
#define KSPEC_TC_MT(T, TM)                                                  \
  (nmt <= 1 ? KSPEC_TC(T, TM, 1) : nmt <= 2 ? KSPEC_TC(T, TM, 2)           \
   : nmt <= 4 ? KSPEC_TC(T, TM, 4) : KSPEC_TC(T, TM, 8))
  if (n1 < 2 || n1 > 128 || n != n1 * N2 || wb < 1 || nmt > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_u8)
    return three_mult ? KSPEC_TC_MT(uint8_t, true)
                      : KSPEC_TC_MT(uint8_t, false);
  return three_mult ? KSPEC_TC_MT(float, true) : KSPEC_TC_MT(float, false);
#undef KSPEC_TC_MT
#undef KSPEC_TC
}

// The launchers of the two classes, one per translation unit.
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

}  // namespace kspec_tc
