// Tensor-core packed DFT curscan kernel (Kernel B) for NVIDIA Hopper
// (sm_90a): the HIGH and DEFAULT precision classes of K2.
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel_packed (:872, K2,
// built by _build_packed at :939, entry curscan_fused_packed) at
// tpuPrecision HIGH and DEFAULT, for fft sizes 2-128 dividing 128
// (quickFullScan runs 64: 512-sample blocks, 71 windows at 90% overlap).
//
// What it computes, per IQ block b and window start s = starts[w]:
//   X_w[k] = sum_j x[s + j] * Dt[j][k],   Dt[j][k] = W_n^(jk) win[j]
//            * winAdj*2/n (folded in float64 and rounded to float32 by the
//            wrapper, as _build_packed folds it)
//   acc[k] = fold over w of weights[w] * |X_w[k]|     float32
//   out[b][(k + n/2) % n] = acc[k]
// The complex product is the 4M form at every class, as in JAX
// (Re = Xr Dr - Xi Di, Im = Xi Dr + Xr Di); each real product rounds its
// float32 operands to bf16 (to nearest even) and sums in float32 on
// mma.sync m16n8k16, once at DEFAULT and as the bf16x3 split
// hi hi + (hi lo + lo hi) at HIGH.  u8 planes decode as x - 127, which is
// exact in bf16, so u8 gives the bits of its decoded float32.
//
// The Pallas body packs 128/n frames side by side in 128-lane rows with one
// lane-shifted view of the block per start residue and a block-diagonal
// table.  That is Mosaic's layout: here a frame at any start is an address.
// The product is taken transposed, X^T = Dt^T F: the table is the A operand
// (bins on M, 16 a tile), the frames the B operand (windows on N, 8 a tile:
// 71 windows fill 9 tiles, 72 columns).
//
// What bounds it on the H100: operations (4M: 4 products of 2 n^2 flops a
// window; quickFullScan at T = 19616: 51.4 GFLOP, 0.046 ms at 989 TFLOP/s
// bf16, 3 times that at HIGH) against the planes read once (80 MB of
// float32, 0.024 ms at 3.35 TB/s; 20 MB of u8).
//
// What the design does about it:
//   * Each sample is read from device memory once a staged span.  A thread
//     block walks IQ blocks b = blockIdx.x, + gridDim.x, ... (a persistent
//     grid: the wrapper's grid is the SMs times the blocks an SM holds, or
//     T); an IQ block is one span (its windows' samples, widened to 16
//     bytes), or several chunks of `chunk` windows where the block does not
//     fit (ops/cuda_tc.packed_tc_plan).  Each span is copied by 16-byte
//     cp.async into one of two staging buffers, the next span's copy in
//     flight while the current one is converted and multiplied.
//   * Each operand is rounded once, with no im2col.  One pass converts the
//     staged span (u8 decoded in the same pass) into bf16 operand planes
//     (re, im; hi, and lo at HIGH): a plane P0 of word-aligned pairs
//     (x[2m], x[2m+1]) and a copy P1 shifted by one sample (x[2m+1],
//     x[2m+2]), so the pair a B fragment takes at an odd start (28 of
//     quickFullScan's 71) is one aligned 32-bit load from P1.  The shifted
//     word is assembled from the rounded words by __byte_perm (the next
//     pair's rounded word comes from the next lane by a shuffle; the last
//     lane of a warp rounds that one sample itself).  A shifted copy costs
//     one more plane of stores per span; assembling odd pairs at each load
//     instead would double the fragment loads of every product.  A frame is
//     then an address: window w's B fragment for k-chunk kc is word
//     ((s_w - a0) >> 1) + 8 kc + t (and + 4) of plane P((s_w - a0) & 1).
//   * Each fragment is read once a use.  The table's A fragments (Dr, Di;
//     hi and lo) are pre-rounded by the wrapper in fragment order; warp mt
//     owns bins 16 mt.. and loads its m-tile's fragments of every k-chunk
//     into registers once for the thread block's whole life (n = 128 at
//     HIGH, whose fragments would take 128 registers, copies the table into
//     shared memory once a thread block and reads it from there); the
//     frame fragments are 32-bit shared loads of the operand planes.
//   * The fold runs from the accumulators.  Lane (g, t) holds bins 16 mt +
//     g and + 8 for windows 8 nt + 2t and + 1: it forms |X| and its window
//     weight in registers and folds the windows it holds, n-tile by n-tile
//     (chunk by chunk); at the block's end two xor shuffles combine the 4
//     lanes of a bin in one fixed order.  For AVG/RAW that order of the
//     float32 sums differs from the plain version's window order; two runs
//     give identical bits, and the windows' lanes do not depend on the
//     input type, so u8 equals decoded float32 bit for bit.
//   * No warp idles at a tail: every warp takes all windows of its bins
//     (quickFullScan: 4 warps of 9 n-tiles each); a block has ceil(n/16)
//     warps.  Two barriers a span.
//   * n is padded to 16 on K (zero table columns; the frame samples past n
//     are real or zero, never undefined) and on M (zero table rows, bins
//     past n not stored), which is exact.  Windows past a chunk's end take
//     the chunk's first start and are not folded.

#include <cuda_bf16.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

// Forensic cut-offs (profiling only: scripts/packed_tc_stages.py compiles
// this source with -DKSPEC_PTC_STOP=1 or 2 into a library of its own; the
// port's library leaves it 0).  1 stops each span after its copy and
// conversion, 2 after the products; the output is then wrong by
// construction.
#ifndef KSPEC_PTC_STOP
#define KSPEC_PTC_STOP 0
#endif

namespace {

constexpr size_t SMEM_LIMIT = 232448;   // a block's shared memory (H100)
constexpr unsigned FULL = 0xffffffffu;

enum Fold { FOLD_SUM = 0, FOLD_MAX = 1, FOLD_MIN = 2 };

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product into a zero accumulator.
__device__ __forceinline__ void mma0(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
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
  lo = 0u;
  if (HIGH) {
    const float h0 = __uint_as_float(hi << 16);
    const float h1 = __uint_as_float(hi & 0xffff0000u);
    lo = pack(__fsub_rn(x0, h0), __fsub_rn(x1, h1));
  }
}

// The pair (high half of a, low half of b): the word one sample on.
__device__ __forceinline__ uint32_t shifted(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5432);
}

__device__ __forceinline__ float decode(float x) { return x; }
__device__ __forceinline__ float decode(uint8_t x) {
  return static_cast<float>(x) - 127.0f;
}

// Four staged samples from 4i (16 bytes of float32, 4 of u8), decoded.
__device__ __forceinline__ void load4(const float* p, int i, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p + 4 * i);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const uint8_t* p, int i,
                                      float (&v)[4]) {
  const uint32_t q = *reinterpret_cast<const uint32_t*>(p + 4 * i);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = static_cast<float>((q >> (8 * k)) & 0xffu) - 127.0f;
}

template <int FOLD>
__device__ __forceinline__ float fold_op(float acc, float v) {
  return FOLD == FOLD_SUM ? __fadd_rn(acc, v)
         : FOLD == FOLD_MAX ? fmaxf(acc, v) : fminf(acc, v);
}

// 32-bit words of one operand plane for a staged row of `stride` samples:
// every pair a fragment can address (16 samples past the row, zero) and a
// pad that puts a P1 plane 16 banks from its P0.
__host__ __device__ constexpr int plane_words(int stride) {
  return (stride / 2 + 8 + 31) / 32 * 32 + 16;
}

// The instantiation for KC k-chunks of 16 (n padded to 16 KC; as many
// m-tiles of bins, one warp each).  HOLD: the table's fragments fit in
// registers (all but n = 128 at HIGH).
template <typename T, bool HIGH, int KC>
struct Shape {
  static constexpr int H = HIGH ? 2 : 1;
  static constexpr int THREADS = 32 * KC;
  static constexpr bool HOLD = KC * H <= 8;
  static constexpr int ALIGN = 16 / static_cast<int>(sizeof(T));
  // The table's fragments: 4 slots (Dr hi, Dr lo, Di hi, Di lo) of KC
  // m-tiles x KC k-chunks x 32 lanes x 16 bytes.
  static constexpr size_t TABLE = static_cast<size_t>(4) * KC * KC * 32 * 16;
  // Shared memory, in this order: the two staging buffers (2 planes of
  // `stride` samples each), the operand planes ([re, im][hi, lo][P0, P1]),
  // the table where it is not held in registers.
  static size_t smem(int stride) {
    return 4 * static_cast<size_t>(stride) * sizeof(T) +
           static_cast<size_t>(16) * H * plane_words(stride) +
           (HOLD ? 0 : TABLE);
  }
};

// Kernel B.  dt holds the table's A fragments [slot][mt][kc][lane] (uint4:
// registers a0..a3), slots (Dr hi, Dr lo, Di hi, Di lo) of Dt^T; starts are
// non-decreasing; FOLD the fold of the cumulate mode (weights are read for
// FOLD_SUM only: MAX/MIN's are ones).
template <typename T, bool HIGH, int KC, int FOLD>
__global__ void __launch_bounds__(32 * KC)
curscan_packed_tc_kernel(const T* __restrict__ re, const T* __restrict__ im,
                         float* __restrict__ out,
                         const int* __restrict__ starts,
                         const float* __restrict__ weights,
                         const uint4* __restrict__ dt, int t, int full,
                         int n, int n_windows, int chunk, int stride) {
  using S = Shape<T, HIGH, KC>;
  constexpr int H = S::H, NTH = S::THREADS, ALIGN = S::ALIGN;
  constexpr bool HOLD = S::HOLD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pw = plane_words(stride);
  T* raw = reinterpret_cast<T*>(smem);
  uint32_t* pl = reinterpret_cast<uint32_t*>(
      smem + 4 * static_cast<size_t>(stride) * sizeof(T));
  uint4* tab = reinterpret_cast<uint4*>(pl + 4 * H * pw);
  const int tid = threadIdx.x, lane = tid & 31, mt = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_chunks = (n_windows + chunk - 1) / chunk;
  const int mine = blockIdx.x < t ? (t - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int items = mine * n_chunks;

  // The table's A fragments of m-tile mt, registers or shared memory.
  uint32_t a[HOLD ? KC : 1][2][H][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const uint4 v = __ldg(dt + (((2 * m + h) * KC + mt) * KC + kc) * 32
                                + lane);
          a[kc][m][h][0] = v.x; a[kc][m][h][1] = v.y;
          a[kc][m][h][2] = v.z; a[kc][m][h][3] = v.w;
        }
  } else {
    for (int i = tid; i < 4 * KC * KC * 32; i += NTH) tab[i] = __ldg(dt + i);
  }

  // Item i: IQ block blockIdx.x + (i / n_chunks) gridDim.x, chunk
  // i % n_chunks: windows [w0, w0 + cw), samples [a0, a0 + span).
  struct Item { int b, c, w0, cw, a0, span; };
  auto item = [&](int i) {
    Item it;
    it.b = blockIdx.x + (i / n_chunks) * gridDim.x;
    it.c = i % n_chunks;
    it.w0 = it.c * chunk;
    it.cw = min(chunk, n_windows - it.w0);
    it.a0 = __ldg(starts + it.w0) / ALIGN * ALIGN;
    it.span = (__ldg(starts + it.w0 + it.cw - 1) + n + ALIGN - 1) / ALIGN
              * ALIGN - it.a0;
    return it;
  };
  // Copy item i's span of both planes into staging buffer i % 2.
  auto stage = [&](int i) {
    if (i < items) {
      const Item it = item(i);
      const int pieces = it.span / ALIGN;
      T* dst = raw + (i & 1) * 2 * stride;
      for (int k = tid; k < 2 * pieces; k += NTH) {
        const int p = k >= pieces, q = k - p * pieces;
        const T* src = (p ? im : re) + static_cast<size_t>(it.b) * full
                       + it.a0 + q * ALIGN;
        __pipeline_memcpy_async(dst + p * stride + q * ALIGN, src, 16);
      }
    }
    __pipeline_commit();
  };

  float acc[2];
  const float init = FOLD == FOLD_MAX ? -CUDART_INF_F
                     : FOLD == FOLD_MIN ? CUDART_INF_F : 0.0f;
  stage(0);
  for (int i = 0; i < items; ++i) {
    stage(i + 1);
    __pipeline_wait_prior(1);
    __syncthreads();
    const Item it = item(i);

    // The span as bf16 operand planes: P0 word m = (x[2m], x[2m+1]), P1
    // word m = (x[2m+1], x[2m+2]), samples past the span zero.  A unit is 4
    // samples: P0 and P1 words 2j and 2j + 1.
    {
      const T* src = raw + (i & 1) * 2 * stride;
      const int units = pw / 2;
      for (int u0 = 0; u0 < 2 * units; u0 += NTH) {   // a uniform trip count
        const int u = u0 + tid;
        const int p = u >= units, j = u - p * units;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (4 * j < it.span) load4(src + p * stride, j, v);
        uint32_t h0, l0, h1, l1, h4, l4;
        operand<HIGH>(v[0], v[1], h0, l0);
        operand<HIGH>(v[2], v[3], h1, l1);
        h4 = __shfl_down_sync(FULL, h0, 1);   // the next unit's first pair
        l4 = __shfl_down_sync(FULL, l0, 1);
        if (lane == 31 || 4 * j + 4 >= it.span) {
          const float x4 = 4 * j + 4 < it.span
                               ? decode(src[p * stride + 4 * j + 4]) : 0.f;
          operand<HIGH>(x4, 0.f, h4, l4);
        }
        if (u < 2 * units) {
          uint32_t* w = pl + p * H * 2 * pw + 2 * j;
          *reinterpret_cast<uint2*>(w) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(w + pw) =
              make_uint2(shifted(h0, h1), shifted(h1, h4));
          if (HIGH) {
            *reinterpret_cast<uint2*>(w + 2 * pw) = make_uint2(l0, l1);
            *reinterpret_cast<uint2*>(w + 3 * pw) =
                make_uint2(shifted(l0, l1), shifted(l1, l4));
          }
        }
      }
    }
    __syncthreads();
    if (it.c == 0) acc[0] = acc[1] = init;

    // Window n-tile nt: lane (g, t) takes B column g (window w0 + 8 nt + g)
    // and folds columns 2t, 2t + 1; TAIL: the chunk's last, partial tile.
    auto tile = [&](int nt, auto tail) {
      constexpr bool TAIL = decltype(tail)::value;
      const int wb = nt * 8 + g;
      const int e0 = __ldg(starts + it.w0 + (!TAIL || wb < it.cw ? wb : 0))
                     - it.a0;
      const uint32_t* pb = pl + (e0 & 1) * pw + (e0 >> 1) + t4;
      float big[4][4], small[4][4];
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t x[2][H][2];               // [re, im][hi, lo][b0, b1]
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const uint32_t* q = pb + (p * H + h) * 2 * pw + 8 * kc;
            x[p][h][0] = q[0];
            x[p][h][1] = q[4];
          }
        uint32_t d[2][H][4];               // [Dr, Di][hi, lo]
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < H; ++h) {
            if constexpr (HOLD) {
#pragma unroll
              for (int r = 0; r < 4; ++r) d[m][h][r] = a[kc][m][h][r];
            } else {
              const uint4 v = tab[(((2 * m + h) * KC + mt) * KC + kc) * 32
                                  + lane];
              d[m][h][0] = v.x; d[m][h][1] = v.y;
              d[m][h][2] = v.z; d[m][h][3] = v.w;
            }
          }
        // Products Dr xr, Di xi, Dr xi, Di xr; at HIGH big = hi hi and
        // small = hi lo + lo hi.
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = q & 1, p = (q == 1 || q == 2);
          if (kc == 0) {
            mma0(big[q], d[m][0], x[p][0][0], x[p][0][1]);
            if (HIGH) mma0(small[q], d[m][0], x[p][H - 1][0],
                           x[p][H - 1][1]);
          } else {
            mma(big[q], d[m][0], x[p][0][0], x[p][0][1]);
            if (HIGH) mma(small[q], d[m][0], x[p][H - 1][0],
                          x[p][H - 1][1]);
          }
          if (HIGH) mma(small[q], d[m][H - 1], x[p][0][0], x[p][0][1]);
        }
      }
      if (KSPEC_PTC_STOP == 2) {         // one value of every product
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[0] = __fadd_rn(acc[0], big[q][0]);
          if (HIGH) acc[0] = __fadd_rn(acc[0], small[q][0]);
        }
        return;
      }
      // c0 (bin g, window 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3.
      float wt[2];
      if (FOLD == FOLD_SUM) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int w = nt * 8 + 2 * t4 + c;
          wt[c] = __ldg(weights + it.w0 + (!TAIL || w < it.cw ? w : 0));
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float xr = __fsub_rn(
            HIGH ? __fadd_rn(big[0][r], small[0][r]) : big[0][r],
            HIGH ? __fadd_rn(big[1][r], small[1][r]) : big[1][r]);
        const float xi = __fadd_rn(
            HIGH ? __fadd_rn(big[2][r], small[2][r]) : big[2][r],
            HIGH ? __fadd_rn(big[3][r], small[3][r]) : big[3][r]);
        if (!TAIL || nt * 8 + 2 * t4 + (r & 1) < it.cw) {
          const float mag = __fsqrt_rn(
              __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi)));
          acc[r >> 1] = fold_op<FOLD>(
              acc[r >> 1],
              FOLD == FOLD_SUM ? __fmul_rn(wt[r & 1], mag) : mag);
        }
      }
    };

    if (KSPEC_PTC_STOP == 1) {
      acc[0] = __fadd_rn(acc[0], __uint_as_float(pl[tid] & 0x7f7fffffu));
    } else {
      int nt = 0;
      for (; (nt + 1) * 8 <= it.cw; ++nt) tile(nt, std::false_type{});
      if (nt * 8 < it.cw) tile(nt, std::true_type{});
    }

    if (it.c == n_chunks - 1) {
      // The 4 lanes of a bin, in one fixed order: (t0 t1)(t2 t3).
#pragma unroll
      for (int s = 1; s <= 2; s <<= 1)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          acc[r] = fold_op<FOLD>(acc[r], __shfl_xor_sync(FULL, acc[r], s));
      if (t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = 16 * mt + g + 8 * r;
          if (k < n)
            out[static_cast<size_t>(it.b) * n + (k + n / 2) % n] = acc[r];
        }
      }
    }
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, float*, const int*,
                          const float*, const uint4*, int, int, int, int,
                          int, int);

// The instantiation for a fold (_FOLD of ops/cuda_curscan), or null.
template <typename T, bool HIGH, int KC>
KernelFn<T> kernel_of(int fold) {
  switch (fold) {
    case FOLD_SUM: return curscan_packed_tc_kernel<T, HIGH, KC, FOLD_SUM>;
    case FOLD_MAX: return curscan_packed_tc_kernel<T, HIGH, KC, FOLD_MAX>;
    case FOLD_MIN: return curscan_packed_tc_kernel<T, HIGH, KC, FOLD_MIN>;
    default: return nullptr;
  }
}

// The kernel for these arguments with its shared memory granted, or null.
template <typename T, bool HIGH, int KC>
KernelFn<T> prepared(int fold, size_t smem) {
  const KernelFn<T> fn = kernel_of<T, HIGH, KC>(fold);
  if (fn == nullptr || smem > SMEM_LIMIT) return nullptr;
  if (smem > 48 * 1024 &&        // above the default only on request
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return nullptr;
  return fn;
}

template <typename T, bool HIGH, int KC>
int launch_one(const void* re, const void* im, void* out, const void* starts,
               const void* weights, const void* dt, int t, int full, int n,
               int n_windows, int fold, int chunk, int stride, int grid,
               cudaStream_t stream) {
  using S = Shape<T, HIGH, KC>;
  if (stride < S::ALIGN || stride % S::ALIGN)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = S::smem(stride);
  const KernelFn<T> fn = prepared<T, HIGH, KC>(fold, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  fn<<<grid, S::THREADS, smem, stream>>>(
      static_cast<const T*>(re), static_cast<const T*>(im),
      static_cast<float*>(out), static_cast<const int*>(starts),
      static_cast<const float*>(weights), static_cast<const uint4*>(dt), t,
      full, n, n_windows, chunk, stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool HIGH, int KC>
long long smem_one(int stride) {
  return static_cast<long long>(Shape<T, HIGH, KC>::smem(stride));
}

template <typename T, bool HIGH, int KC>
int occupancy_one(int fold, int stride) {
  using S = Shape<T, HIGH, KC>;
  const size_t smem = S::smem(stride);
  const KernelFn<T> fn = prepared<T, HIGH, KC>(fold, smem);
  int blocks = 0;
  if (fn == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, fn, S::THREADS, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// CALL(T, HIGH, KC) for the instantiation of (is_u8, precision) and fft n;
// `fail` where n is not one the kernel takes.
#define KSPEC_PTC_DISPATCH(CALL, fail)                                      \
  do {                                                                      \
    int kc_ = 0;                                                            \
    switch (n) {                                                            \
      case 2: case 4: case 8: case 16: kc_ = 1; break;                      \
      case 32: kc_ = 2; break;                                              \
      case 64: kc_ = 4; break;                                              \
      case 128: kc_ = 8; break;                                             \
      default: return fail;                                                 \
    }                                                                       \
    if (is_u8) {                                                            \
      if (precision) {                                                      \
        switch (kc_) { case 1: return CALL(uint8_t, true, 1);               \
                       case 2: return CALL(uint8_t, true, 2);               \
                       case 4: return CALL(uint8_t, true, 4);               \
                       default: return CALL(uint8_t, true, 8); }            \
      }                                                                     \
      switch (kc_) { case 1: return CALL(uint8_t, false, 1);                \
                     case 2: return CALL(uint8_t, false, 2);                \
                     case 4: return CALL(uint8_t, false, 4);                \
                     default: return CALL(uint8_t, false, 8); }             \
    }                                                                       \
    if (precision) {                                                        \
      switch (kc_) { case 1: return CALL(float, true, 1);                   \
                     case 2: return CALL(float, true, 2);                   \
                     case 4: return CALL(float, true, 4);                   \
                     default: return CALL(float, true, 8); }                \
    }                                                                       \
    switch (kc_) { case 1: return CALL(float, false, 1);                    \
                   case 2: return CALL(float, false, 2);                    \
                   case 4: return CALL(float, false, 4);                    \
                   default: return CALL(float, false, 8); }                 \
  } while (0)

}  // namespace

// Plain C entry point (bound with ctypes).  Planes are (t, full) row-major,
// float32 or uint8 (is_u8), 16-byte aligned; out is (t, n) float32; starts
// (n_windows,) int32, non-decreasing; weights (n_windows,) float32 (decay
// weights, ones for MAX/MIN); dt the fragment-ordered table of
// ops/cuda_tc.packed_tc_tables; precision 0 DEFAULT, 1 HIGH; chunk the
// windows a staged span, stride the samples a staging row (a multiple of
// 16 bytes, at least the widest chunk's span) and grid the thread blocks,
// all from ops/cuda_tc.packed_tc_plan.  Returns the CUDA error code of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int kspec_curscan_packed_tc(const void* re, const void* im,
                                       int is_u8, void* out,
                                       const void* starts,
                                       const void* weights, const void* dt,
                                       int t, int full, int n, int n_windows,
                                       int fold, int precision, int chunk,
                                       int stride, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t < 1 || n_windows < 1 || chunk < 1 || grid < 1 || grid > t)
    return static_cast<int>(cudaErrorInvalidValue);
#define KSPEC_PTC_LAUNCH(T, HIGH, KC)                                       \
  launch_one<T, HIGH, KC>(re, im, out, starts, weights, dt, t, full, n,     \
                          n_windows, fold, chunk, stride, grid, s)
  KSPEC_PTC_DISPATCH(KSPEC_PTC_LAUNCH,
                     static_cast<int>(cudaErrorInvalidValue));
#undef KSPEC_PTC_LAUNCH
}

// Kernel B's shared memory a block (bytes) for fft n and a staging row of
// `stride` samples, or -1 for an fft it does not take.
extern "C" long long kspec_curscan_packed_tc_smem(int is_u8, int n,
                                                  int precision,
                                                  int stride) {
#define KSPEC_PTC_SMEM(T, HIGH, KC) smem_one<T, HIGH, KC>(stride)
  KSPEC_PTC_DISPATCH(KSPEC_PTC_SMEM, -1LL);
#undef KSPEC_PTC_SMEM
}

// The blocks an SM holds of the instantiation kspec_curscan_packed_tc
// launches for these arguments (registers and shared memory), or -1.
extern "C" int kspec_curscan_packed_tc_occupancy(int is_u8, int n,
                                                 int precision, int fold,
                                                 int stride) {
#define KSPEC_PTC_OCC(T, HIGH, KC) occupancy_one<T, HIGH, KC>(fold, stride)
  KSPEC_PTC_DISPATCH(KSPEC_PTC_OCC, -1);
#undef KSPEC_PTC_OCC
}
