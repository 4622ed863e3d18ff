// Packed tiny-FFT curscan kernel (K2 at HIGHEST) for NVIDIA Hopper (sm_90a).
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel_packed (:872, the
// Pallas kernel for fft_size <= 128 dividing 128, built at :939, called at
// :988, entry curscan_fused_packed), the kernel of the quickFullScan preset
// (fft 64, 512-sample blocks, 71 windows at 90% overlap, 1226 bands a
// sweep), the offline analyzer's fft 128 and the band-sharded scan.
//
// What it computes, per IQ block b of full_size samples:
//   for every window start s = starts[w] (any offset, non-decreasing):
//     X_w = DFT_N(x[s : s+N] * ws),   ws[j] = win[j] * winAdj*2/N
//           (ws and the roots in float64; u8 planes decode as x - 127)
//     acc[k] = fold(acc[k], |X_w[k]|)   AVG/RAW: sum of weights[w] * |X_w|
//                                       (closed-form decay weights),
//                                       MAX/MIN: extrema
//   out[b][(k + N/2) % N] = acc[k]       natural order, fftshifted
// The data path is float64 from the decode to |X|^2; |X| is sqrtf of |X|^2
// rounded to float32 and the folds are float32: a float32 FFT reached 1.10
// of the per-bin bound (5e-5 of the bin plus 1e-6 of the peak) on a MIN
// fold over 951 windows at fft 64.
//
// The Pallas body packs 128/N frames side by side in 128-lane rows, builds
// one lane-shifted view of the block per start residue and runs a
// block-diagonal DFT dot on the MXU.  That is Mosaic's layout, not math:
// here a misaligned start is an offset into shared memory.
//
// What bounds it on the H100: operations.  quickFullScan at T=19616 needs
// 19616 * 71 windows of 5 N log2 N + 4 N = 2,176 flops: 3.03 GFLOP, 0.045
// ms at 67 TFLOP/s (float64 runs at half that rate: 0.09 ms), against 85
// MB of float32 planes read once, 0.025 ms at 3.35 TB/s.
//
// What the first design (the parent form, -DKSPEC_PACKED_PARENT=1) spent
// its time on, by its stage table (scripts/packed_stages.py --parent,
// quickFullScan T=19616 f32 on the card alone, NVIDIA H100 80GB HBM3 at
// 700 W): input 0.087 ms, the P-point FFT in registers and the lane
// twiddle +0.143, the cross-lane passes +0.146, |X| and the fold +0.024;
// 0.400 in all.  Both middle stages ran at 2-3 times their float64 work:
// each window reloaded its lane's 7 twiddles (16-byte shared loads, 2- to
// 4-way bank conflicts) and the pass twiddles, and the cross-lane passes
// spent 48 shuffles, 96 selects and 96 float64 operations a lane.
//
// The design:
//   * An FFT in registers, N = P * L: a window's L lanes hold P points each
//     (P = N, L = 1 up to 16; 8 x 4 at 32, 8 x 8 at 64, 16 x 8 at 128).
//     Lane j1 holds x[j1 + L*j2], j2 < P: the four-step FFT, P-point DFTs
//     in each lane, the twiddle W_N^(j1*k1), L-point DFTs across lanes.
//     With C = P / L = 2 the P-point DFT starts with one radix-2 pass and
//     goes on as two L-point DFTs (k1 even and odd).  The butterflies'
//     twiddles are constants in the code.
//   * The exchange across lanes without selects.  Each lane's L-point DFTs
//     are rotated by its lane index: their inputs are multiplied by
//     W_L^(j*lane), so register q ends holding k1 = C*((bitrev(q) + lane)
//     mod L) + e.  Then in round q every lane sends register q and lane k
//     takes it from lane k - bitrev(q): lane k ends with Y[j1][C*k + e] for
//     every j1, in rotated order, having sent C*(L-1) complex values (28
//     shuffles at fft 64 against the parent's 48, and no select).  Its
//     L-point DFT over them (exponent +, bit-reversed input) gives X at
//     bins C*k + e + P*p up to a factor W_L^(k*p) of modulus 1, which |X|
//     drops.  At C = 1 the rotation rides on the window: one complex
//     constant a point.  A transpose through shared memory, the other way
//     to cross lanes, moves 2 KB of shared memory a window at fft 64 (16
//     bytes a value, stored and loaded), more than the parent's shuffles
//     and twiddle loads together; the stage table showed shared loads as a
//     cost already, so the exchange stays in shuffles.
//   * Per-lane constants once a thread block: the window (times the
//     rotation at C = 1), the rotation (C = 2) and the lane twiddles are
//     built from the float64 tables into shared memory laid out [r][lane],
//     16 bytes a lane, so a group's 8 lanes read 128 consecutive bytes: no
//     bank conflict.  Registers cannot hold them: at P <= 8 four blocks of
//     256 threads an SM leave 64 registers a thread, 32 of them the window.
//   * One unit a thread block, its chunks in flight.  A unit is `blocks`
//     IQ blocks (G lane groups each, group g taking windows g, g + G, ...
//     in window order).  Its windows are staged whole in one buffer where
//     they fit (40 KiB at P <= 8, 80 at P = 16, where two blocks an SM
//     hold), else in chunks of a multiple of G windows, each
//     copied by cp.async (both planes of the unit's IQ blocks, 16 bytes a
//     copy, and the chunk's starts and weights) into one of two buffers
//     while the chunk before is computed.  G is the parent form's (the
//     fewest groups that give two waves of 2048 threads an SM at T), so the
//     groups fold the windows the parent's way (ops/cuda_packed).  A
//     persistent grid (the resident thread blocks walking units a grid
//     apart, the next unit in flight) ran slower at quickFullScan T=19616
//     (0.318 against 0.295 ms f32, 0.326 against 0.284 u8; the C2 cell
//     0.221 against 0.212): its static walk left 10 units on some thread
//     blocks against 9.29 on average, where the block scheduler balances,
//     and four resident blocks an SM already overlap each other's copies.
//   * u8 decodes by the exponent trick (2^52 + x, then - (2^52 + 127)), one
//     float64 add and no conversion; float32 planes convert once a sample
//     a window.
//   * The fold in registers, in the parent form's order: each group folds
//     its windows in window order; at a unit's end the groups' partial
//     folds meet in shared memory and are combined in group order.  No
//     atomics: two runs give identical bits, and u8 gives the bits of its
//     decoded float32 planes.  Where the magnitudes round alike, the folds
//     are the parent's bit for bit: the worst shares of the per-bin bound
//     sit near 0.003 (a few float32 ulps), where another order of the same
//     additions moved them by up to 19% (a NumPy model of both orders at 4
//     against 8 groups) and a compensated combine still lost to the
//     parent's order at one case on the card (0.0030 against 0.0027).
//   * A warp's lanes stay together: every group of a thread block runs the
//     chunk's ceil(windows / G) rounds, a group past its windows computing a
//     dummy window it does not fold, so the shuffles take the full warp.
//     With a mask per group the compiler wrapped each shuffle in
//     divergence handling (WARPSYNC, BSSY/BSYNC in the SASS).

// Forensic builds of this file alone (ops/cuda_packed.stage_library,
// scripts/packed_stages.py): -DKSPEC_PACKED_STOP=1..3 stop each window
// after its input (the staged span, decode and the window), after the
// P-point FFT in registers and the lane twiddle, or after the exchange and
// the L-point DFT, and fold |re + im| of each value in place of its
// magnitude, at the slot of the value's position
// (cuda_packed.curscan_packed_stage_plain defines the values); 4 is the
// production kernel.  -DKSPEC_PACKED_PARENT=1 builds the parent form in
// place of the production one, under the entries
// kspec_curscan_packed_parent and kspec_curscan_packed_parent_attrs; the
// cut-offs apply to it too.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#ifndef KSPEC_PACKED_STOP
#define KSPEC_PACKED_STOP 4
#endif
#ifndef KSPEC_PACKED_PARENT
#define KSPEC_PACKED_PARENT 0
#endif

namespace {

constexpr int THREADS = 256;   // threads of one thread block

enum Fold { FOLD_SUM = 0, FOLD_MAX = 1, FOLD_MIN = 2 };
enum Stop { STOP_INPUT = 1, STOP_REGS = 2, STOP_LANES = 3, STOP_FULL = 4 };
constexpr int STOP = KSPEC_PACKED_STOP;
static_assert(STOP >= STOP_INPUT && STOP <= STOP_FULL, "KSPEC_PACKED_STOP");

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

__host__ __device__ constexpr int bitrev(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((x >> i) & 1);
  return r;
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float fold1(int fold, float acc, float x) {
  return fold == FOLD_SUM ? acc + x
       : fold == FOLD_MAX ? fmaxf(acc, x) : fminf(acc, x);
}

#if KSPEC_PACKED_PARENT
// ---------------------------------------------------------------------------
// The parent form (the first design), kept as the yardstick of the
// production form: a thread block of blocks = 256/L/G IQ blocks, each
// staged whole (or in chunks, double-buffered) and waited for; the lane
// twiddles and pass twiddles loaded each window; the L-point DFT as log2(L)
// radix-2 passes exchanging half of the registers by __shfl_xor_sync.

__device__ __forceinline__ double decode(float x) { return x; }

__device__ __forceinline__ double decode(uint8_t x) {
  return static_cast<double>(x) - 127.0;
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

// The output slot of register r of lane `lane` at the build's cut-off:
// position lane + L*r of the window after its input, lane + L*k1 of the
// four-step intermediate (k1 = bitrev(r)) after the registers' FFT and the
// lane twiddle, the bin after the cross-lane passes.
template <int P, int L>
__device__ __forceinline__ int slot_of(int r, int lane) {
  if constexpr (STOP == STOP_INPUT) return lane + L * r;
  if constexpr (STOP == STOP_REGS) return lane + L * bitrev(r, ilog2(P));
  return bin_of<P, L>(r, lane);
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
        if constexpr (STOP > STOP_INPUT) {
          fft_regs<P, L>(v, tws);
          if (L > 1) {                    // W_N^(lane * k1)
#pragma unroll
            for (int r = 1; r < P; ++r)
              v[r] = cmul(v[r], tws[(lane * bitrev(r, LP)) % N]);
          }
        }
        if constexpr (STOP > STOP_REGS) cross_lanes<P, L>(v, tws, lane, mask);
        const float wt = weights[w];
#pragma unroll
        for (int r = 0; r < P; ++r) {
          const float mag = STOP == STOP_FULL
              ? sqrtf(__double2float_rn(v[r].x * v[r].x + v[r].y * v[r].y))
              : __double2float_rn(fabs(v[r].x + v[r].y));
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
    comb[gi * N + slot_of<P, L>(r, lane)] = acc[r];
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

// Shared memory of a thread block: the tables, the staged chunks, the
// partial folds.
template <typename T, int P, int L>
size_t smem_bytes(int groups, int n_chunks, int stride) {
  const int blocks = THREADS / L / groups;
  return static_cast<size_t>(P) * L * (sizeof(double2) + sizeof(double)) +
         (n_chunks > 1 ? 2 : 1) * static_cast<size_t>(blocks) * 2 * stride *
             sizeof(T) +
         static_cast<size_t>(THREADS) * P * sizeof(float);
}

template <typename T, int P, int L>
int launch(const void* re, const void* im, void* out, const void* starts,
           const void* weights, const void* wscale, const void* tw, int t,
           int full_size, int n_windows, int fold, int groups, int chunk,
           int n_chunks, int stride, cudaStream_t stream) {
  const int blocks = THREADS / L / groups;
  const size_t smem = smem_bytes<T, P, L>(groups, n_chunks, stride);
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

// Registers, local memory, shared memory and resident blocks an SM of the
// instantiation for (n, T) at a plan: attrs[0..3].
template <typename T, int P, int L>
int attrs_of(int groups, int n_chunks, int stride, int* attrs) {
  // The attribute stays at least the default 48 KiB: a launch sets it only
  // above that, so a query must not leave it below a later launch's need.
  const size_t smem = smem_bytes<T, P, L>(groups, n_chunks, stride);
  cudaError_t err = cudaFuncSetAttribute(
      curscan_packed_kernel<T, P, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem > 48 * 1024 ? smem : 48 * 1024));
  cudaFuncAttributes fa;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, curscan_packed_kernel<T, P, L>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, curscan_packed_kernel<T, P, L>, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes + smem);
  attrs[3] = blocks;
  return 0;
}

template <typename T>
int attrs_for(int n, int groups, int n_chunks, int stride, int* attrs) {
  switch (n) {
    case 2: return attrs_of<T, 2, 1>(groups, n_chunks, stride, attrs);
    case 4: return attrs_of<T, 4, 1>(groups, n_chunks, stride, attrs);
    case 8: return attrs_of<T, 8, 1>(groups, n_chunks, stride, attrs);
    case 16: return attrs_of<T, 16, 1>(groups, n_chunks, stride, attrs);
    case 32: return attrs_of<T, 8, 4>(groups, n_chunks, stride, attrs);
    case 64: return attrs_of<T, 8, 8>(groups, n_chunks, stride, attrs);
    case 128: return attrs_of<T, 16, 8>(groups, n_chunks, stride, attrs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

#else
// ---------------------------------------------------------------------------
// The production form.

// A window's values are double2 (re, im).  Roots of unity W_16^k = exp(-2 pi
// i k / 16), correctly rounded; 1, -1, i and -i exact.
constexpr double COS1 = 0x1.d906bcf328d46p-1;   // cos(pi/8)
constexpr double SIN1 = 0x1.87de2a6aea963p-2;   // sin(pi/8)
constexpr double HALF = 0x1.6a09e667f3bcdp-1;   // sqrt(1/2)

// v * W_16^k (conj: v * W_16^-k), k a constant after unrolling: the
// branches fold away; +-1 and +-i cost no operation, +-sqrt(1/2) (1 +- i)
// two adds and two multiplies, the rest a complex multiply.
__device__ __forceinline__ double2 rot16(double2 v, int k, bool conj) {
  k &= 15;
  if (conj) k = (16 - k) & 15;
  switch (k) {
    case 0: return v;
    case 4: return make_double2(v.y, -v.x);
    case 8: return make_double2(-v.x, -v.y);
    case 12: return make_double2(-v.y, v.x);
    case 2: return make_double2(HALF * (v.x + v.y), HALF * (v.y - v.x));
    case 6: return make_double2(HALF * (v.y - v.x), -HALF * (v.x + v.y));
    case 10: return make_double2(-HALF * (v.x + v.y), HALF * (v.x - v.y));
    case 14: return make_double2(HALF * (v.x - v.y), HALF * (v.x + v.y));
    default: {     // odd k: (cos, -sin)(pi k / 8)
      const bool near = k % 8 == 1 || k % 8 == 7;
      const double cr = (near ? COS1 : SIN1) * (k < 4 || k > 12 ? 1 : -1);
      const double ci = (near ? SIN1 : COS1) * (k < 8 ? -1 : 1);
      return cmul(v, make_double2(cr, ci));
    }
  }
}

// Radix-2 decimation-in-frequency M-point DFT (exponent -) of v[B..B+M):
// v[B + q] ends as output bitrev(q).  Twiddles are constants; each pass is
// its own instantiation (HALF = M/2, M/4, ..., 1), so every index is a
// constant and v stays in registers.
template <int M, int B, int HALF, int P>
__device__ __forceinline__ void dif_pass(double2 (&v)[P]) {
  if constexpr (HALF >= 1) {
#pragma unroll
    for (int blk = 0; blk < M; blk += 2 * HALF) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const double2 a = v[B + blk + i], b = v[B + blk + i + HALF];
        v[B + blk + i] = make_double2(a.x + b.x, a.y + b.y);
        v[B + blk + i + HALF] = rot16(make_double2(a.x - b.x, a.y - b.y),
                                      i * (8 / HALF), false);
      }
    }
    dif_pass<M, B, HALF / 2, P>(v);
  }
}

template <int M, int B, int P>
__device__ __forceinline__ void dif(double2 (&v)[P]) {
  dif_pass<M, B, M / 2, P>(v);
}

// Radix-2 decimation-in-time M-point DFT with exponent + of v[B..B+M)
// holding input bitrev(q) in v[B + q]: v[B + p] ends as output p.
template <int M, int B, int HALF, int P>
__device__ __forceinline__ void dit_conj_pass(double2 (&v)[P]) {
  if constexpr (HALF < M) {
#pragma unroll
    for (int blk = 0; blk < M; blk += 2 * HALF) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const double2 a = v[B + blk + i];
        const double2 b = rot16(v[B + blk + i + HALF], i * (8 / HALF), true);
        v[B + blk + i] = make_double2(a.x + b.x, a.y + b.y);
        v[B + blk + i + HALF] = make_double2(a.x - b.x, a.y - b.y);
      }
    }
    dit_conj_pass<M, B, 2 * HALF, P>(v);
  }
}

template <int M, int B, int P>
__device__ __forceinline__ void dit_conj(double2 (&v)[P]) {
  dit_conj_pass<M, B, 1, P>(v);
}

// u8 samples decode as x - 127 by the exponent trick: the double with high
// word 0x43300000 and low word x is 2^52 + x exactly, so one subtraction
// gives x - 127 with no integer-to-double conversion.
__device__ __forceinline__ double decode64(float x) { return x; }

__device__ __forceinline__ double decode64(uint8_t x) {
  return __hiloint2double(0x43300000, x) - 4503599627370623.0;  // 2^52+127
}

// Where each part of a thread block's shared memory starts (bytes): the
// lane constants wsc ([r][lane], P*L double2: the window times winAdj*2/N,
// at C = 1 also times the rotation W_L^(r*lane)), um ([j][lane], L*L
// double2: W_L^(j*lane), C = 2 only) and twl ([r][lane], P*L double2: the
// lane twiddle of register r, L > 1); the chunk buffers (two where the
// unit has more than one chunk), each the unit's planes (2 * stride
// samples an IQ block) and the chunk's starts and weights; the partial
// folds.  The library reports the total
// (kspec_curscan_packed_attrs); ops/cuda_packed sizes the chunks to a
// budget below it and holds no copy of it.
struct Layout {
  size_t um, twl, buf, buf_bytes, st, wt, comb, total;
};

__host__ __device__ constexpr size_t up16(size_t x) {
  return (x + 15) / 16 * 16;
}

template <typename T, int P, int L>
__host__ __device__ Layout layout(int groups, int chunk, int n_chunks,
                                  int stride) {
  constexpr int C = L > 1 ? P / L : 1;
  const int blocks = THREADS / L / groups;
  Layout o;
  o.um = static_cast<size_t>(P) * L * sizeof(double2);
  o.twl = o.um + (C == 2 ? static_cast<size_t>(L) * L * sizeof(double2) : 0);
  o.buf = o.twl + (L > 1 ? static_cast<size_t>(P) * L * sizeof(double2) : 0);
  o.st = up16(static_cast<size_t>(blocks) * 2 * stride * sizeof(T));
  o.wt = o.st + up16(static_cast<size_t>(chunk) * sizeof(int));
  o.buf_bytes = o.wt + up16(static_cast<size_t>(chunk) * sizeof(float));
  o.comb = o.buf + (n_chunks > 1 ? 2 : 1) * o.buf_bytes;
  o.total = o.comb + static_cast<size_t>(THREADS) * P * sizeof(float);
  return o;
}

// What a value folds: |X| = sqrtf of |X|^2 rounded to float32, below the
// 'full' cut-off |re + im|.
__device__ __forceinline__ float magnitude(double2 v) {
  return STOP == STOP_FULL ? sqrtf(__double2float_rn(v.x * v.x + v.y * v.y))
                           : __double2float_rn(fabs(v.x + v.y));
}

// The output slot of register r of lane `lane` at the build's cut-off
// (cuda_packed.curscan_packed_stage_plain): window position lane + L*r
// after the input; lane + L*k1 of the four-step intermediate after the
// registers' FFT and the lane twiddle (register r = e*L + q holds k1 =
// C*((bitrev(q) + lane) mod L) + e; with L = 1, k1 = bitrev(r)); after the
// exchange and the L-point DFT, bin C*lane + e + P*p of register e*L + p.
template <int P, int L>
__device__ __forceinline__ int slot(int r, int lane) {
  constexpr int C = L > 1 ? P / L : 1;
  if (STOP == STOP_INPUT) return lane + L * r;
  if (L == 1) return bitrev(r, ilog2(P));
  const int e = r / L, q = r % L;
  if (STOP == STOP_REGS)
    return lane + L * (C * ((bitrev(q, ilog2(L)) + lane) % L) + e);
  return C * lane + e + P * q;
}

// A lane constant from shared memory, read where it is used: a volatile
// load the compiler may not hoist out of the window loop (builds cut off
// before the fold hoisted the constants into registers and spilled them).
__device__ __forceinline__ double2 lane_const(const double2* p) {
  double2 v;
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];"
               : "=d"(v.x), "=d"(v.y)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// One window in the registers of its L lanes: lane `lane` loads samples
// off + L*j (j < P) of the staged planes.  See the source note.
template <typename T, int P, int L>
__device__ __forceinline__ void window(double2 (&v)[P],
                                       const T* __restrict__ xr,
                                       const T* __restrict__ xi, int off,
                                       const double2* wsc, const double2* um,
                                       const double2* twl, int lane) {
  constexpr int C = L > 1 ? P / L : 1;
  constexpr int LL = ilog2(L);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const double x = decode64(xr[off + L * j]);
    const double y = decode64(xi[off + L * j]);
    const double2 c = lane_const(wsc + j * L + lane);
    v[j] = C == 1 && L > 1 ? make_double2(x * c.x - y * c.y, x * c.y + y * c.x)
                           : make_double2(x * c.x, y * c.x);
  }
  if constexpr (STOP == STOP_INPUT) return;
  if constexpr (L == 1) {
    dif<P, 0>(v);
    return;
  } else {
    if constexpr (C == 2) {       // the first radix-2 pass of the P points
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const double2 a = v[j], b = v[j + L];
        v[j] = make_double2(a.x + b.x, a.y + b.y);
        v[j + L] = rot16(make_double2(a.x - b.x, a.y - b.y), j * 16 / P,
                         false);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 1; j < L; ++j)
          v[e * L + j] = cmul(v[e * L + j], lane_const(um + j * L + lane));
    }
    dif<L, 0>(v);
    if constexpr (C == 2) dif<L, L>(v);
#pragma unroll
    for (int r = 0; r < P; ++r)
      v[r] = cmul(v[r], lane_const(twl + r * L + lane));
    if constexpr (STOP == STOP_REGS) return;
    // The exchange: in round q every lane sends its register q of each
    // sub-FFT, and lane k takes it from lane k - bitrev(q).
#pragma unroll
    for (int e = 0; e < C; ++e)
#pragma unroll
      for (int q = 1; q < L; ++q) {
        const int src = (lane - bitrev(q, LL)) & (L - 1);
        v[e * L + q].x = __shfl_sync(0xffffffffu, v[e * L + q].x, src, L);
        v[e * L + q].y = __shfl_sync(0xffffffffu, v[e * L + q].y, src, L);
      }
    dit_conj<L, 0>(v);
    if constexpr (C == 2) dit_conj<L, L>(v);
  }
}

// The production kernel: thread block k serves unit k, IQ blocks k*blocks
// onward, its chunks in order, the next chunk staged while one is computed.
template <typename T, int P, int L>
__global__ void __launch_bounds__(THREADS, P <= 8 ? 4 : 2)
curscan_packed_kernel(const T* __restrict__ re, const T* __restrict__ im,
                      float* __restrict__ out,
                      const int* __restrict__ starts,
                      const float* __restrict__ weights,
                      const double* __restrict__ wscale,
                      const double2* __restrict__ tw,
                      int t, int full_size, int n_windows, int fold,
                      int groups, int chunk, int n_chunks, int stride) {
  constexpr int N = P * L;
  constexpr int C = L > 1 ? P / L : 1;
  constexpr int LL = ilog2(L);
  constexpr int ALIGN = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout<T, P, L>(groups, chunk, n_chunks, stride);
  double2* wsc = reinterpret_cast<double2*>(smem);
  double2* um = reinterpret_cast<double2*>(smem + lay.um);
  double2* twl = reinterpret_cast<double2*>(smem + lay.twl);
  float* comb = reinterpret_cast<float*>(smem + lay.comb);

  const int blocks = THREADS / L / groups;     // IQ blocks of a unit
  const int lane = threadIdx.x % L;            // lane within the group
  const int gi = threadIdx.x / L;              // group within the block
  const int lb = gi / groups;                  // its IQ block in the unit
  const int g = gi % groups;                   // its share of the windows

  // The lane constants, from the float64 tables, once a thread block.
  for (int i = threadIdx.x; i < P * L; i += THREADS) {
    const int r = i / L, j1 = i % L;
    const double ws = wscale[j1 + L * r];
    if (C == 1 && L > 1) {
      const double2 m = tw[(r * j1 % L) * (N / L)];
      wsc[i] = make_double2(ws * m.x, ws * m.y);
    } else {
      wsc[i] = make_double2(ws, 0.0);
    }
    if (L > 1) {
      const int k1 = C * ((bitrev(r % L, LL) + j1) % L) + r / L;
      twl[i] = tw[(j1 * k1) % N];
    }
  }
  if (C == 2)
    for (int i = threadIdx.x; i < L * L; i += THREADS)
      um[i] = tw[((i / L) * (i % L) % L) * (N / L)];

  const int b0 = blockIdx.x * blocks;          // the unit's first IQ block

  // Copy chunk c of the unit into buffer c % 2: both planes of its IQ
  // blocks, 16 bytes a copy, and the chunk's starts and weights.
  auto stage = [&](int c) {
    if (c < n_chunks) {
      const int w0 = c * chunk;
      const int cw = min(chunk, n_windows - w0);
      unsigned char* buf = smem + lay.buf + (c & 1) * lay.buf_bytes;
      T* dst = reinterpret_cast<T*>(buf);
      const int a0 = __ldg(starts + w0) / ALIGN * ALIGN;
      const int pieces = ((__ldg(starts + w0 + cw - 1) + N + ALIGN - 1)
                          / ALIGN * ALIGN - a0) / ALIGN;
      for (int k = threadIdx.x; k < blocks * 2 * pieces; k += THREADS) {
        const int q = k % pieces, row = k / pieces;   // row = 2 * lb + plane
        const int b = b0 + row / 2;
        if (b >= t) continue;
        const T* src = (row % 2 ? im : re) + static_cast<size_t>(b) * full_size
                       + a0 + q * ALIGN;
        __pipeline_memcpy_async(dst + row * stride + q * ALIGN, src, 16);
      }
      for (int k = threadIdx.x; k < cw; k += THREADS) {
        __pipeline_memcpy_async(buf + lay.st + 4 * k, starts + w0 + k, 4);
        __pipeline_memcpy_async(buf + lay.wt + 4 * k, weights + w0 + k, 4);
      }
    }
    __pipeline_commit();
  };

  float acc[P];
  const float init = fold == FOLD_MAX ? -CUDART_INF_F
                     : fold == FOLD_MIN ? CUDART_INF_F : 0.0f;
#pragma unroll
  for (int r = 0; r < P; ++r) acc[r] = init;

  const bool live = b0 + lb < t;
  stage(0);
  for (int c = 0; c < n_chunks; ++c) {
    __pipeline_wait_prior(0);
    __syncthreads();              // chunk c and the constants are visible
    stage(c + 1);                 // into the buffer chunk c - 1 used
    const int cw = min(chunk, n_windows - c * chunk);
    const unsigned char* buf = smem + lay.buf + (c & 1) * lay.buf_bytes;
    const T* xr = reinterpret_cast<const T*>(buf) + lb * 2 * stride;
    const T* xi = xr + stride;
    const int* st = reinterpret_cast<const int*>(buf + lay.st);
    const float* wt = reinterpret_cast<const float*>(buf + lay.wt);
    const int a0 = st[0] / ALIGN * ALIGN;
    // Every group runs the chunk's rounds, so a warp's lanes stay together
    // through the exchange; a group past its windows (or past T) computes
    // the chunk's first window and folds nothing.
    const int rounds = (cw + groups - 1) / groups;
#pragma unroll 1
    for (int k = 0; k < rounds; ++k) {
      const int w = g + k * groups;
      const bool on = live && w < cw;
      double2 v[P];
      window<T, P, L>(v, xr, xi, st[on ? w : 0] - a0 + lane, wsc, um, twl,
                      lane);
      if (on) {
        const float wgt = wt[w];
#pragma unroll
        for (int r = 0; r < P; ++r)
          acc[r] = fold == FOLD_SUM ? fmaf(wgt, magnitude(v[r]), acc[r])
                 : fold == FOLD_MAX ? fmaxf(acc[r], magnitude(v[r]))
                                    : fminf(acc[r], magnitude(v[r]));
      }
    }
    __syncthreads();              // the buffer is refilled next
  }

  // The unit's partial folds, combined in group order.
#pragma unroll
  for (int r = 0; r < P; ++r) comb[gi * N + slot<P, L>(r, lane)] = acc[r];
  __syncthreads();
  for (int k = threadIdx.x; k < blocks * N; k += THREADS) {
    const int bb = k / N, bin = k % N;
    const int b = b0 + bb;
    if (b >= t) continue;
    const float* part = comb + bb * groups * N + bin;
    float a = part[0];
    for (int q = 1; q < groups; ++q) a = fold1(fold, a, part[q * N]);
    out[static_cast<size_t>(b) * N + (bin + N / 2) % N] = a;
  }
}

template <typename T, int P, int L>
int launch(const void* re, const void* im, void* out, const void* starts,
           const void* weights, const void* wscale, const void* tw, int t,
           int full_size, int n_windows, int fold, int groups, int chunk,
           int n_chunks, int stride, cudaStream_t stream) {
  const int blocks = THREADS / L / groups;
  const size_t smem = layout<T, P, L>(groups, chunk, n_chunks, stride).total;
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
      static_cast<const float*>(weights), static_cast<const double*>(wscale),
      static_cast<const double2*>(tw), t, full_size, n_windows, fold, groups,
      chunk, n_chunks, stride);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local memory, shared memory (dynamic and static) and resident
// blocks an SM of the instantiation for (T, P, L) at a plan: attrs[0..3].
template <typename T, int P, int L>
int attrs_of(int groups, int chunk, int n_chunks, int stride, int* attrs) {
  // The attribute stays at least the default 48 KiB: a launch sets it only
  // above that, so a query must not leave it below a later launch's need.
  const size_t smem = layout<T, P, L>(groups, chunk, n_chunks, stride).total;
  cudaError_t err = cudaFuncSetAttribute(
      curscan_packed_kernel<T, P, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem > 48 * 1024 ? smem : 48 * 1024));
  cudaFuncAttributes fa;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, curscan_packed_kernel<T, P, L>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, curscan_packed_kernel<T, P, L>, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes + smem);
  attrs[3] = blocks;
  return 0;
}

#define KSPEC_BY_SIZE(n, CALL)                                              \
  switch (n) {                                                              \
    case 2: return CALL(2, 1);                                              \
    case 4: return CALL(4, 1);                                              \
    case 8: return CALL(8, 1);                                              \
    case 16: return CALL(16, 1);                                            \
    case 32: return CALL(8, 4);                                             \
    case 64: return CALL(8, 8);                                             \
    case 128: return CALL(16, 8);                                           \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }
#endif

}  // namespace

#if KSPEC_PACKED_PARENT
// The parent form's entry (bound with ctypes): planes are (t, full_size)
// row-major, float32 or uint8 (is_u8), 16-byte aligned; out is (t, n)
// float32; wscale is the (n,) float64 window times winAdj*2/n, tw the (n,)
// complex128 table W_n^m; groups, chunk, n_chunks and stride come from
// ops/cuda_packed.parent_plan.  Returns the CUDA error code of the launch.
extern "C" int kspec_curscan_packed_parent(
    const void* re, const void* im, int is_u8, void* out, const void* starts,
    const void* weights, const void* wscale, const void* tw, int t,
    int full_size, int n, int n_windows, int fold, int groups, int chunk,
    int n_chunks, int stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8)
    return dispatch<uint8_t>(n, re, im, out, starts, weights, wscale, tw, t,
                             full_size, n_windows, fold, groups, chunk,
                             n_chunks, stride, s);
  return dispatch<float>(n, re, im, out, starts, weights, wscale, tw, t,
                         full_size, n_windows, fold, groups, chunk, n_chunks,
                         stride, s);
}

// The parent form's instantiation for fft n on uint8 (is_u8) or float32
// planes at a plan: attrs[0..3] = its registers a thread, local memory a
// thread (spills and stack), shared memory a block (dynamic and static)
// and resident blocks an SM.  Returns the CUDA error code.
extern "C" int kspec_curscan_packed_parent_attrs(int n, int is_u8, int groups,
                                                 int n_chunks, int stride,
                                                 int* attrs) {
  return is_u8 ? attrs_for<uint8_t>(n, groups, n_chunks, stride, attrs)
               : attrs_for<float>(n, groups, n_chunks, stride, attrs);
}
#else
// Plain C entry point (bound with ctypes).  Planes are (t, full_size)
// row-major, float32 or uint8 (is_u8), 16-byte aligned; out is (t, n)
// float32; starts (int32) and weights (float32) have n_windows entries;
// wscale is the (n,) float64 window times winAdj*2/n, tw the (n,)
// complex128 table W_n^m; groups, chunk, n_chunks and stride come from
// ops/cuda_packed.launch_plan; a thread block serves a unit of 256/L/groups
// IQ blocks.  Returns the CUDA error code of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int kspec_curscan_packed(const void* re, const void* im, int is_u8,
                                    void* out, const void* starts,
                                    const void* weights, const void* wscale,
                                    const void* tw, int t, int full_size,
                                    int n, int n_windows, int fold,
                                    int groups, int chunk, int n_chunks,
                                    int stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KSPEC_LAUNCH_U8(P, L)                                               \
  launch<uint8_t, P, L>(re, im, out, starts, weights, wscale, tw, t,        \
                        full_size, n_windows, fold, groups, chunk, n_chunks, \
                        stride, s)
#define KSPEC_LAUNCH_F32(P, L)                                              \
  launch<float, P, L>(re, im, out, starts, weights, wscale, tw, t,          \
                      full_size, n_windows, fold, groups, chunk, n_chunks,  \
                      stride, s)
  if (is_u8) {
    KSPEC_BY_SIZE(n, KSPEC_LAUNCH_U8)
  }
  KSPEC_BY_SIZE(n, KSPEC_LAUNCH_F32)
#undef KSPEC_LAUNCH_U8
#undef KSPEC_LAUNCH_F32
}

// The instantiation serving fft n on uint8 (is_u8) or float32 planes at a
// plan (groups, chunk, n_chunks, stride): attrs[0..3] = its registers a
// thread, local memory a thread (spills and stack), shared memory a block
// (dynamic and static) and resident blocks an SM.  Returns the CUDA error
// code.
extern "C" int kspec_curscan_packed_attrs(int n, int is_u8, int groups,
                                          int chunk, int n_chunks, int stride,
                                          int* attrs) {
#define KSPEC_ATTRS_U8(P, L) \
  attrs_of<uint8_t, P, L>(groups, chunk, n_chunks, stride, attrs)
#define KSPEC_ATTRS_F32(P, L) \
  attrs_of<float, P, L>(groups, chunk, n_chunks, stride, attrs)
  if (is_u8) {
    KSPEC_BY_SIZE(n, KSPEC_ATTRS_U8)
  }
  KSPEC_BY_SIZE(n, KSPEC_ATTRS_F32)
#undef KSPEC_ATTRS_U8
#undef KSPEC_ATTRS_F32
}
#endif
