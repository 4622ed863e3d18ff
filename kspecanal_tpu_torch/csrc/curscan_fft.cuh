// Shared device code of the FFT curscan kernels (curscan_fft.cu: the
// powers of two up to 131072; curscan_mixed.cuh: every other size), and the
// mixed-radix route's entry.  See curscan_fft.cu for the contract and the
// precision design.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int RADIX = 16;         // radix of the passes after the first;
                                  // complex values per thread
constexpr int LOG2_BLOCK_N = 14;  // one thread block holds up to 16384 points
constexpr int MAX_CLUSTER = 8;    // portable cluster size: fft <= 131072
constexpr int COMBINE_THREADS = 256;

enum Fold { FOLD_SUM = 0, FOLD_MAX = 1, FOLD_MIN = 2 };

// Shared-memory index: one float2 of padding per 16.
__device__ __forceinline__ int pad(int a) { return a + (a >> 4); }

__device__ __forceinline__ float sample(const float* p, size_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float sample(const uint8_t* p, size_t i) {
  return static_cast<float>(__ldg(p + i)) - 127.0f;
}

__device__ __forceinline__ double2 widen(float2 a) {
  return make_double2(a.x, a.y);
}

__device__ __forceinline__ float2 narrow(double2 a) {
  return make_float2(static_cast<float>(a.x), static_cast<float>(a.y));
}

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// -i * a
__device__ __forceinline__ double2 mul_mi(double2 a) {
  return make_double2(a.y, -a.x);
}

// a * exp(-2 pi i e / 16); e is a constant once the callers are unrolled.
__device__ __forceinline__ double2 twiddle16(double2 a, int e) {
  constexpr double C1 = 0.92387953251128675613;  // cos(pi/8)
  constexpr double S1 = 0.38268343236508977173;  // sin(pi/8)
  constexpr double H = 0.70710678118654752440;   // sqrt(1/2)
  switch (e & 15) {
    case 0: return a;
    case 1: return cmul(a, make_double2(C1, -S1));
    case 2: return cmul(a, make_double2(H, -H));
    case 3: return cmul(a, make_double2(S1, -C1));
    case 4: return mul_mi(a);
    case 5: return cmul(a, make_double2(-S1, -C1));
    case 6: return cmul(a, make_double2(-H, -H));
    case 7: return cmul(a, make_double2(-C1, -S1));
    case 8: return make_double2(-a.x, -a.y);
    case 9: return cmul(a, make_double2(-C1, S1));
    case 10: return cmul(a, make_double2(-H, H));
    case 11: return cmul(a, make_double2(-S1, C1));
    case 12: return make_double2(-a.y, a.x);
    case 13: return cmul(a, make_double2(S1, C1));
    case 14: return cmul(a, make_double2(H, H));
    default: return cmul(a, make_double2(C1, S1));
  }
}

__device__ __forceinline__ void dft2(double2& a, double2& b) {
  const double2 s = cadd(a, b);
  b = csub(a, b);
  a = s;
}

__device__ __forceinline__ void dft4(double2& a, double2& b, double2& c,
                                     double2& d) {
  const double2 s0 = cadd(a, c), d0 = csub(a, c);
  const double2 s1 = cadd(b, d), d1 = csub(b, d);
  const double2 mi = mul_mi(d1);
  a = cadd(s0, s1);
  b = cadd(d0, mi);
  c = csub(s0, s1);
  d = csub(d0, mi);
}

// Element r widened, times roots[r * tws] (the pass twiddle; tws = 0 in
// pass 1, where every twiddle is 1).
__device__ __forceinline__ double2 load_tw(float2 x, int r,
                                           const float2* __restrict__ roots,
                                           int tws) {
  const double2 d = widen(x);
  return r ? cmul(d, widen(__ldg(roots + r * tws))) : d;
}

// Natural-order DFT of the R float32 values x, each first multiplied by its
// pass twiddle roots[r * tws], computed in float64 and rounded to float32
// once at the end and, for R = 8 and 16, once between the inner and the
// outer stage: 16 = 4 x 4 and 8 = 4 x 2 (inner DFT-4 over stride-R/4 values,
// twiddle W16^(n2 k1 16/R), outer DFT, transpose by renaming).
template <int R>
__device__ __forceinline__ void dft(float2 (&x)[R],
                                    const float2* __restrict__ roots,
                                    int tws) {
  if constexpr (R <= 4) {
    double2 d[R];
#pragma unroll
    for (int r = 0; r < R; ++r) d[r] = load_tw(x[r], r, roots, tws);
    if constexpr (R == 2) {
      dft2(d[0], d[1]);
    } else {
      dft4(d[0], d[1], d[2], d[3]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = narrow(d[r]);
  } else {
    constexpr int N2S = R / 4;
#pragma unroll
    for (int n2 = 0; n2 < N2S; ++n2) {
      double2 d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d[i] = load_tw(x[n2 + N2S * i], n2 + N2S * i, roots, tws);
      dft4(d[0], d[1], d[2], d[3]);
      // x[n2 + N2S*k1] = y[n2][k1] * W16^(n2 k1 16/R)
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1)
        x[n2 + N2S * k1] = narrow(twiddle16(d[k1], n2 * k1 * (16 / R)));
    }
    float2 y[R];
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      double2 d[N2S];
#pragma unroll
      for (int n2 = 0; n2 < N2S; ++n2) d[n2] = widen(x[N2S * k1 + n2]);
      if constexpr (N2S == 4) {
        dft4(d[0], d[1], d[2], d[3]);
      } else {
        dft2(d[0], d[1]);
      }
#pragma unroll
      for (int k2 = 0; k2 < N2S; ++k2) y[k1 + 4 * k2] = narrow(d[k2]);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = y[k];
  }
}

__device__ __forceinline__ float fold_in(float acc, float mag, int fold) {
  return fold == FOLD_SUM ? acc + mag
       : fold == FOLD_MAX ? fmaxf(acc, mag) : fminf(acc, mag);
}

}  // namespace

namespace kspec_fft {

// The mixed-radix kernel (curscan_mixed.cuh) on (t, full_size) planes: with
// `scratch` null, n not a power of two up to 131072 (c = 1, or a cluster of
// a power of two c <= 8 blocks); else any n, c blocks through `scratch`,
// `chunk` IQ blocks at a time.  pass_roots holds the odd passes' float64
// tables.  dst is out (groups == 1) or the (t, groups, n) partials.  stop
// cuts the kernel off for its stage table (0: in full; see Stop).
// Returns the CUDA error code of the launches.
int launch_mixed_route(const void* re, const void* im, int is_u8,
                       void* scratch, float* dst, const void* starts,
                       const void* weights, const void* window,
                       const void* roots, const void* pass_roots, int t,
                       int full_size, int n, int c, int chunk, int n_windows,
                       int groups, int fold, int stop, cudaStream_t stream);

}  // namespace kspec_fft
