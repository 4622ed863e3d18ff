// Device helpers shared by the tensor-core curscan kernels: Kernel A
// (curscan_tc.cuh) and Kernel C (curscan_tc_split.cuh).  The bf16 tensor-core
// product (mma.sync m16n8k16, float32 sums), the rounding of float32 operand
// pairs for a class into S bf16 parts (S = 1 DEFAULT; 2 HIGH, the bf16x3
// split's hi and lo; 3 HIGHEST, hi, mid and lo), the ldmatrix loads of bf16
// fragments from shared memory, the per-tile products of the 3M and 4M
// complex forms, the u8/float32 sample loads and the cumulate folds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kspec_tc {

enum Fold { FOLD_SUM = 0, FOLD_MAX = 1, FOLD_MIN = 2 };

// The ablate builds (forensics only: Kernel A with -DKSPEC_TC_ABLATE=1,
// Kernel C with -DKSPEC_TCS_ABLATE=1) remove stages at run time, one bit a
// stage, the keys of ops/cuda_curscan.ABLATE_KEYS.  Their C entry points
// hand the mask to the kernel in the bits of `fold` from AB_SHIFT up, so the
// production kernels' arguments and code stay as they are.
enum Ablate {
  AB_WIN = 1, AB_STAGE1 = 2, AB_TWIDDLE = 4, AB_STAGE2 = 8, AB_SQRT = 16,
  AB_CUMULATE = 32
};
constexpr int AB_SHIFT = 2;

// The six-pass HIGHEST class (S = 3) is compiled only in the forensic builds
// (-DKSPEC_TC_HIGHEST=1, ops/cuda_tc.highest_variants): there the HIGH
// translation units (curscan_tc_high.cu, curscan_tc_split_high.cu)
// instantiate S = 3 in place of S = 2, the DEFAULT ones none, and the entry
// points take precision 2 only.  The port's library leaves it 0.
#ifndef KSPEC_TC_HIGHEST
#define KSPEC_TC_HIGHEST 0
#endif
// The parts an operand of the class that the HIGH translation units
// instantiate.
constexpr int HIGH_PARTS = KSPEC_TC_HIGHEST ? 3 : 2;

// The parts of a bf16 operand that the arrays of fragments hold: 2 (hi, lo;
// lo unused at DEFAULT) up to HIGH, 3 at HIGHEST.  The wrappers' tables hold
// as many slots a matrix (ops/cuda_tc.tc_tables).
__host__ __device__ constexpr int parts(int s) { return s > 2 ? 3 : 2; }

// The fold of an ablate build's mask: a plain sum of the magnitudes under
// 'cumulate', whatever the mode (the window groups' partials too).
__host__ __device__ inline int ablated_fold(int fold, int ablate) {
  return (ablate & AB_CUMULATE) ? FOLD_SUM : fold;
}

// The value of the bf16 operand at element o of plane p: hi, plus at HIGH
// its lo, `half` elements on.
template <bool HIGH>
__device__ __forceinline__ float operand_value(const uint16_t* p, int half,
                                               int o) {
  const float hi = __uint_as_float(static_cast<uint32_t>(p[o]) << 16);
  return HIGH ? __fadd_rn(hi, __uint_as_float(
                                  static_cast<uint32_t>(p[half + o]) << 16))
              : hi;
}

// The same at a class of S parts an operand: at HIGHEST (hi + mid) + lo,
// mid and lo one and two planes on.
template <int S>
__device__ __forceinline__ float part_value(const uint16_t* p, int half,
                                            int o) {
  if constexpr (S == 3) {
    return __fadd_rn(operand_value<true>(p, half, o),
                     __uint_as_float(static_cast<uint32_t>(p[2 * half + o])
                                     << 16));
  } else {
    return operand_value<S == 2>(p, half, o);
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  Plain: lane i gets row i/4, columns 2(i%4)..
// of each; .trans: rows 2(i%4).., column i/4.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm2t(uint32_t& r0, uint32_t& r1,
                                       uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1) : "r"(addr));
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

// An operand pair in HIGHEST's three parts: hi = bf16(x), mid = bf16(x -
// hi), lo = bf16(x - hi - mid), each difference in float32 (exact: the part
// taken off is x's leading bits).
__device__ __forceinline__ void operand3(float x0, float x1, uint32_t& hi,
                                         uint32_t& mid, uint32_t& lo) {
  hi = pack(x0, x1);
  const float r0 = __fsub_rn(x0, __uint_as_float(hi << 16));
  const float r1 = __fsub_rn(x1, __uint_as_float(hi & 0xffff0000u));
  mid = pack(r0, r1);
  lo = pack(__fsub_rn(r0, __uint_as_float(mid << 16)),
            __fsub_rn(r1, __uint_as_float(mid & 0xffff0000u)));
}

// HIGHEST's three parts of a form's pair (x0, x1) stored at word o of the
// planes at words 0, ps and 2 ps.
__device__ __forceinline__ void put_parts3(uint32_t* pl, int ps, int o,
                                           float x0, float x1) {
  uint32_t hi, mid, lo;
  operand3(x0, x1, hi, mid, lo);
  pl[o] = hi;
  pl[ps + o] = mid;
  pl[2 * ps + o] = lo;
}

// Inside a kernel templated on S (the class's bf16 parts an operand): the
// real products of one complex product into the accumulators a,
// Acc::products up to HIGH and Acc::products6 at HIGHEST.
#define KSPEC_CLASS_PRODUCTS(a, f, x)                                       \
  do {                                                                       \
    if constexpr (S == 3) (a).products6(f, x);                               \
    else (a).template products<S == 2>(f, x);                                \
  } while (0)

// Products kept per tile: 3M T1, T2, T3; 4M rr, ii, ri, ir.  Each is
// a_hi b_hi, and at HIGH also a_hi b_lo and a_lo b_hi, three independent
// float32 sums (three mma chains) added as hh + (hl + lh), as dot3 adds them.
// At HIGHEST (six passes: the products of parts whose orders sum to at most
// 2) hl sums the first-order terms a_hi b_mid and a_mid b_hi in one chain
// and lh the second-order a_hi b_lo, a_mid b_mid and a_lo b_hi in another,
// added as hh + (hl + lh), the smaller terms first.
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
  // The complex product's real products from operand forms a[f][half] and
  // b[f][half] (f: re, im, re + im).  3M: T1 = re re, T2 = im im, T3 = sum
  // sum; 4M: rr, ii, ri (A re, B im), ir (A im, B re).
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
  // mid, lo): hl the first-order terms, lh the second-order ones.
  __device__ __forceinline__ void product6(int p, const uint32_t (&a)[3][4],
                                           const uint32_t (&b)[3][2]) {
    mma(hh[p], a[0], b[0][0], b[0][1]);
    mma(hl[p], a[0], b[1][0], b[1][1]);
    mma(hl[p], a[1], b[0][0], b[0][1]);
    mma(lh[p], a[0], b[2][0], b[2][1]);
    mma(lh[p], a[1], b[1][0], b[1][1]);
    mma(lh[p], a[2], b[0][0], b[0][1]);
  }
  // products() at HIGHEST, the forms' three parts each.
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
  // A product's value: hh, or hh + (hl + lh) at HIGH and HIGHEST.
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

}  // namespace kspec_tc
