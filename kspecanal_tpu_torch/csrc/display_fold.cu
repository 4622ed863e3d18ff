// Display fold of the zero-span chain for NVIDIA Hopper (sm_90a): the whole
// display half of K zero-span iterations (models/zerospan.display_updates)
// in two launches.
//
// Replaces no TPU kernel.  In the JAX package this chain
// (kspecanal_tpu/models/zerospan.py::display_updates, over ops/dsp.py) is
// plain jnp code that XLA fuses into a few device programs; the port's
// PyTorch chain (ops/cuda_display.display_fold_plain) ran it as about 45
// launches and three blocking host-to-device copies of decay weights a
// step, which held the host for longer than the card's work.
//
// What it computes, from spec (K, F) float32 linear spectra:
//   d[i][c]  = the display transform of spec[i][c]: each LogNoGain of the
//              chain is 10*log10f(x) - gain in float32, rounded after the
//              product and after the difference as torch rounds them
//              (no contraction into an FMA); Raw passes through
//   max[c]   = max_i d[i][c], folded into the previous curve where its
//              seeded bit is set; NaN propagates as in torch.amax
//   min[c]   = likewise
//   avg[c]   = prev[c]*2^-K + sum_i 2^-(K-i) d[i][c] (the serial fold
//              (old + new)/2 unrolled), prev = d[0][c] on the first copy
//              (cumu_weights' w_0 = 2^-(K-1)); summed in float64 and
//              rounded once; -inf in any row or in a seeded prev gives
//              -inf, as dsp.decay_avg does
//   cur[c]   = d[K-1][c]
//   heatmap  = the last min(K, 128) rows, less adj, edge bins floored to
//              the row's inner minimum, compressed over F / x_res columns
//              (MAX / MIN / AVG; RAW keeps the row), at their ring rows;
//              the other ring rows copied; the ring index, the iteration
//              count and the seeded bits updated on the card.
// The weights are powers of two built from i and K (ldexp), so nothing is
// copied from the host and nothing waits.
//
// What bounds it on the H100: bytes.  Both benchmark cells fold 32 MiB of
// spectra a step (K = 4096 x F = 2048, K = 512 x F = 16384), about 10 us
// at 3.35 TB/s, for about 2 flops a byte; the ring rows re-read at most
// 128 rows (8 MiB at F = 16384), most of which the first launch has just
// brought into the 50 MB L2.
//
// The design:
//   * Launch 1 (display_partials): a block owns a tile of 128 columns
//     (32 lanes x 4 adjacent columns, one 16-byte load a row where F % 4
//     == 0) and a chunk of rows; each of its 8 warps folds a contiguous
//     eighth of the chunk, the next 4 rows' loads in flight while it folds
//     4.  The grid is tiles x chunks with chunks chosen for at most three
//     blocks an SM, one wave (ops/cuda_display.plan): zs2048k50's 2048
//     columns give only 16 tiles, so the rows are split.  Each warp keeps
//     max, min, a float64 Horner sum h = h/2 + d (the serial fold in
//     float64) and a -inf flag in registers; the block combines its 8
//     warps in warp order through shared memory and writes one partial a
//     chunk.
//   * Launch 2 (display_finish): the ring rows, 256 outputs (groups or
//     RAW columns) a block, re-read from spec or copied from the old
//     ring; the other blocks combine the chunks' partials of 256 columns
//     in chunk order.  A fixed order everywhere: a run repeats bit for
//     bit.
//   * The dB rows never reach memory: only the partials (chunks x F x 16
//     bytes, 0.75 MiB in both cells), the curves and the ring are
//     written.
// Measured (H100, both cells): about 0.041 ms a step, 24% of the byte
// bound: the transform and the NaN-aware folds, about 40 instructions an
// element (log10f the most), and launch 2's latency set it, not bytes.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;    // columns of a block in launch 1: 32 lanes x 4
constexpr int kUnroll = 4;    // rows a thread has in flight while it folds
                              // the previous four
constexpr int kMinBlocks = 3; // launch-1 blocks an SM (ops/cuda_display)
constexpr int kRing = 128;    // heatmap ring rows (config.HEATMAP_ROWS)

enum { kRaw = 0, kMax = 1, kMin = 2, kAvg = 3 };   // heatmap compression
enum { kCurveMax = 1, kCurveMin = 2, kCurveAvg = 4 };   // the seeded bits

// torch.maximum / torch.minimum: NaN wins (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// A sum that stays -inf once a -inf enters it, whatever else it meets
// (dsp.decay_avg's mask applied after the sum).
__device__ __forceinline__ double add_keep_neg(double s, double x) {
  return (s == -INFINITY || x == -INFINITY) ? -INFINITY : s + x;
}

// The display transform: n_log LogNoGain steps, each rounded as torch
// rounds 10.0 * torch.log10(x) - gain on float32.
__device__ __forceinline__ float to_db(float x, int n_log, float gain) {
  for (int i = 0; i < n_log; ++i)
    x = __fsub_rn(__fmul_rn(10.0f, log10f(x)), gain);
  return x;
}

template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ row, int col,
                                      int f, float (&v)[4]) {
  if constexpr (kVec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + col));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = col + j < f ? __ldg(row + col + j) : 0.f;
  }
}

// Rows [r, min(r + kUnroll, end)) of the thread's 4 columns.
template <bool kVec>
__device__ __forceinline__ void load_rows(const float* __restrict__ spec,
                                          int r, int end, int col, int f,
                                          float (&v)[kUnroll][4]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (r + u < end) load4<kVec>(spec + (size_t)(r + u) * f, col, f, v[u]);
}

// Launch 1: grid (tiles, chunks).  Chunk y covers rows [y*rows, min(k,
// (y+1)*rows)); its partial sum is sum_i 2^-(b-1-i) d[i] over them (b the
// chunk's end), or -inf.  Writes cur from the warp that folds row k-1.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
display_partials(const float* __restrict__ spec, int k, int f, int rows,
                 int n_log, float gain, float* __restrict__ pmax,
                 float* __restrict__ pmin, double* __restrict__ psum,
                 float* __restrict__ cur) {
  __shared__ float s_max[kWarps][kTile];
  __shared__ float s_min[kWarps][kTile];
  __shared__ double s_sum[kWarps][kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kTile + lane * 4;
  const int a = blockIdx.y * rows;
  const int b = min(k, a + rows);
  const int wa = a + (warp * (b - a)) / kWarps;
  const int wb = a + ((warp + 1) * (b - a)) / kWarps;
  float mx[4], mn[4], last[4];
  double h[4];
  bool neg[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[j] = -INFINITY;
    mn[j] = INFINITY;
    last[j] = 0.f;
    h[j] = 0.0;
    neg[j] = false;
  }
  if (col < f) {
    // The next four rows are in flight while these four are folded.
    float v[kUnroll][4], nx[kUnroll][4];
    load_rows<kVec>(spec, wa, wb, col, f, v);
    for (int r = wa; r < wb; r += kUnroll) {
      if (r + kUnroll < wb) load_rows<kVec>(spec, r + kUnroll, wb, col, f, nx);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u < wb) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d = to_db(v[u][j], n_log, gain);
            mx[j] = nan_max(mx[j], d);
            mn[j] = nan_min(mn[j], d);
            h[j] = fma(h[j], 0.5, (double)d);
            neg[j] |= d == -INFINITY;
            last[j] = d;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = nx[u][j];
    }
    if (wb == k && wb > wa) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < f) cur[col + j] = last[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s_max[warp][lane * 4 + j] = mx[j];
    s_min[warp][lane * 4 + j] = mn[j];
    // This warp's rows end at wb; scaled to the chunk's end b (exact: a
    // power of two).
    s_sum[warp][lane * 4 + j] = neg[j] ? -INFINITY : ldexp(h[j], wb - b);
  }
  __syncthreads();
  const int t = threadIdx.x, c = blockIdx.x * kTile + t;
  if (t < kTile && c < f) {
    float m = s_max[0][t], q = s_min[0][t];
    double s = s_sum[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      m = nan_max(m, s_max[w][t]);
      q = nan_min(q, s_min[w][t]);
      s = add_keep_neg(s, s_sum[w][t]);
    }
    const size_t o = (size_t)blockIdx.y * f + c;
    pmax[o] = m;
    pmin[o] = q;
    psum[o] = s;
  }
}

__device__ float block_min(float v) {
  __shared__ float s[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  v = s[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = nan_min(v, s[w]);
  return v;
}

struct Ring {
  const float* spec;
  const float* adj;      // null: no baseline
  const float* heat_in;
  float* heat_out;
  const int* hm_in;
  const int* it_in;
  const int* seeded_in;
  int* scalars_out;      // hm_index, iteration, seeded
  int k, f, n_log, skip, mode, x_res, width, curves;
  float gain;
};

// The heatmap value of column i of a row: dB, less adj.
__device__ __forceinline__ float disp(const Ring& p, const float* row, int i) {
  const float d = to_db(__ldg(row + i), p.n_log, p.gain);
  return p.adj ? __fsub_rn(d, __ldg(p.adj + i)) : d;
}

// Outputs [seg*256, seg*256 + 256) of ring row r: rewritten from spec row
// k - kw + j where r is the j-th of the kw = min(k, 128) last rows' ring
// positions, else copied.  An output is a group of cols = f / x_res
// columns, or a column (RAW).  With an edge skip every segment of a row
// takes the row's inner minimum itself.
__device__ void ring_row(const Ring& p, int r, int seg) {
  const int hm = *p.hm_in;
  const int kw = min(p.k, kRing);
  const int off = (p.k - kw) % kRing;
  const int j = ((r - hm - off) % kRing + 2 * kRing) % kRing;
  const int o = seg * kThreads + threadIdx.x;
  float* dst = p.heat_out + (size_t)r * p.width;
  if (r == 0 && seg == 0 && threadIdx.x == 0) {
    p.scalars_out[0] = (int)(((long long)hm + p.k) % kRing);
    p.scalars_out[1] = (int)((unsigned)*p.it_in + (unsigned)p.k);
    p.scalars_out[2] = *p.seeded_in | p.curves;
  }
  if (j >= kw) {
    if (o < p.width) dst[o] = p.heat_in[(size_t)r * p.width + o];
    return;
  }
  const float* row = p.spec + (size_t)(p.k - kw + j) * p.f;
  const int lo = p.skip, hi = p.f - p.skip;
  float inner = 0.f;
  if (p.skip > 0) {
    float m = INFINITY;
    for (int i = lo + threadIdx.x; i < hi; i += kThreads)
      m = nan_min(m, disp(p, row, i));
    inner = block_min(m);
  }
  if (o >= p.width) return;
  const int cols = p.mode == kRaw ? 0 : p.f / p.x_res;
  if (cols == 0) {
    dst[o] = (o < lo || o >= hi) ? inner : disp(p, row, o);
    return;
  }
  const int c0 = o * cols;
  float acc = (c0 < lo || c0 >= hi) ? inner : disp(p, row, c0);
#pragma unroll 8
  for (int c = c0 + 1; c < c0 + cols; ++c) {
    const float v = (c < lo || c >= hi) ? inner : disp(p, row, c);
    acc = p.mode == kMax ? nan_max(acc, v)
        : p.mode == kMin ? nan_min(acc, v) : __fadd_rn(acc, v);
  }
  dst[o] = p.mode == kAvg ? __fmul_rn(acc, 1.0f / (float)cols) : acc;
}

struct Curves {
  const float* spec;
  const float* pmax;
  const float* pmin;
  const double* psum;
  const float* prev_max;
  const float* prev_min;
  const float* prev_avg;
  const int* seeded_in;
  float* out_max;
  float* out_min;
  float* out_avg;
  int k, f, chunks, rows, n_log, curves;
  float gain;
};

// Column c of the curves: the chunks' partials combined in chunk order.
__device__ void combine(const Curves& p, int c) {
  const int seeded = *p.seeded_in;
  if (p.curves & kCurveMax) {
    float m = p.pmax[c];
    for (int y = 1; y < p.chunks; ++y)
      m = nan_max(m, p.pmax[(size_t)y * p.f + c]);
    p.out_max[c] = (seeded & kCurveMax) ? nan_max(p.prev_max[c], m) : m;
  }
  if (p.curves & kCurveMin) {
    float m = p.pmin[c];
    for (int y = 1; y < p.chunks; ++y)
      m = nan_min(m, p.pmin[(size_t)y * p.f + c]);
    p.out_min[c] = (seeded & kCurveMin) ? nan_min(p.prev_min[c], m) : m;
  }
  if (p.curves & kCurveAvg) {
    double s = 0.0;
#pragma unroll 4
    for (int y = 0; y < p.chunks; ++y) {
      const int end = min(p.k, (y + 1) * p.rows);
      s = add_keep_neg(s, ldexp(p.psum[(size_t)y * p.f + c], end - p.k - 1));
    }
    const float prev = (seeded & kCurveAvg) ? p.prev_avg[c]
                                            : to_db(p.spec[c], p.n_log, p.gain);
    p.out_avg[c] = (float)add_keep_neg(ldexp((double)prev, -p.k), s);
  }
}

// Launch 2: blocks 0 to 128*segs - 1 the ring rows (segs blocks a row),
// the rest 256 columns of the curves each.
__global__ void __launch_bounds__(kThreads)
display_finish(Ring ring, Curves curves, int segs) {
  const int ring_blocks = kRing * segs;
  if ((int)blockIdx.x < ring_blocks) {
    ring_row(ring, blockIdx.x / segs, blockIdx.x % segs);
    return;
  }
  const int c = (blockIdx.x - ring_blocks) * kThreads + threadIdx.x;
  if (c < curves.f) combine(curves, c);
}

}  // namespace

// The C entry: both launches on `stream`; returns the first launch error
// (0: none).  Scratch: pmax, pmin (chunks x f float32) and psum (chunks x
// f float64).  `vec`: f % 4 == 0 and spec 16-byte aligned.
extern "C" int kspec_display_fold(
    const void* spec, int k, int f, int n_log, float gain, const void* adj,
    int skip, int mode, int x_res, int width, int curves,
    const void* prev_max, const void* prev_min, const void* prev_avg,
    const void* seeded_in, const void* hm_in, const void* it_in,
    const void* heat_in, void* out_max, void* out_min, void* out_avg,
    void* out_cur, void* heat_out, void* scalars_out, void* pmax, void* pmin,
    void* psum, int chunks, int rows, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(spec);
  const dim3 grid1((f + kTile - 1) / kTile, chunks);
  if (vec)
    display_partials<true><<<grid1, kThreads, 0, s>>>(
        sp, k, f, rows, n_log, gain, static_cast<float*>(pmax),
        static_cast<float*>(pmin), static_cast<double*>(psum),
        static_cast<float*>(out_cur));
  else
    display_partials<false><<<grid1, kThreads, 0, s>>>(
        sp, k, f, rows, n_log, gain, static_cast<float*>(pmax),
        static_cast<float*>(pmin), static_cast<double*>(psum),
        static_cast<float*>(out_cur));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Ring ring{sp, static_cast<const float*>(adj),
            static_cast<const float*>(heat_in), static_cast<float*>(heat_out),
            static_cast<const int*>(hm_in), static_cast<const int*>(it_in),
            static_cast<const int*>(seeded_in), static_cast<int*>(scalars_out),
            k, f, n_log, skip, mode, x_res, width, curves, gain};
  Curves cv{sp, static_cast<const float*>(pmax),
            static_cast<const float*>(pmin), static_cast<const double*>(psum),
            static_cast<const float*>(prev_max),
            static_cast<const float*>(prev_min),
            static_cast<const float*>(prev_avg),
            static_cast<const int*>(seeded_in), static_cast<float*>(out_max),
            static_cast<float*>(out_min), static_cast<float*>(out_avg),
            k, f, chunks, rows, n_log, curves, gain};
  const int segs = (width + kThreads - 1) / kThreads;
  display_finish<<<kRing * segs + (f + kThreads - 1) / kThreads, kThreads, 0,
                   s>>>(ring, cv, segs);
  return static_cast<int>(cudaGetLastError());
}
