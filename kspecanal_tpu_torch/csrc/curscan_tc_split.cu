// Tensor-core two-stage DFT curscan for any split n = n1 * n2 (Kernel C),
// DEFAULT instantiations, the combine kernel of its window groups and the C
// entry points; the kernel is in curscan_tc_split.cuh, the HIGH
// instantiations in curscan_tc_split_high.cu.  A -DKSPEC_TC_HIGHEST=1 build
// (forensics) instantiates no DEFAULT kernel here and HIGHEST there.
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel (:116) and
// ::_kernel_sublane (:423) at tpuPrecision HIGH and DEFAULT where Kernel A
// does not take the config (see curscan_tc_split.cuh).

#include "curscan_tc_split.cuh"

namespace kspec_tcs {

int launch_default(int is_u8, int three_mult, const void* re, const void* im,
                   void* out, void* part, const void* starts,
                   const void* weights, const void* window, const void* f1,
                   const void* f2, const void* tw, int t, int full, int n,
                   int n1, int n2, int n_windows, int groups, int fold,
                   cudaStream_t stream) {
#if KSPEC_TC_HIGHEST
  return static_cast<int>(cudaErrorInvalidValue);
#else
  return launch_class<1>(is_u8, three_mult, re, im, out, part, starts,
                         weights, window, f1, f2, tw, t, full, n, n1, n2,
                         n_windows, groups, fold, stream);
#endif
}

int occupancy_default(int is_u8, int three_mult, int n1, int n2) {
#if KSPEC_TC_HIGHEST
  return -1;
#else
  return occupancy_class<1>(is_u8, three_mult, n1, n2);
#endif
}

// out[b][o] = the fold of part[b][0..G-1][o], in group order.
__global__ void combine_groups(const float* __restrict__ part,
                               float* __restrict__ out, int t, int n,
                               int groups, int fold) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= static_cast<long long>(t) * n) return;
  const long long b = i / n, o = i % n;
  const float* p = part + b * groups * n + o;
  float acc = p[0];
  for (int g = 1; g < groups; ++g) acc = fold_op(fold, acc, p[g * n]);
  out[i] = acc;
}

}  // namespace kspec_tcs

namespace {

// Whether this build serves `precision` (0 DEFAULT, 1 HIGH, 2 HIGHEST): the
// port's library DEFAULT and HIGH, a -DKSPEC_TC_HIGHEST=1 build HIGHEST.
bool serves(int precision) {
  return KSPEC_TC_HIGHEST ? precision == 2 : precision == 0 || precision == 1;
}

// kspec_curscan_tc_split's launches; the combine folds the groups by
// `combine_fold` (`fold` may carry an ablate build's mask).
int run(const void* re, const void* im, int is_u8, void* out, void* part,
        const void* starts, const void* weights, const void* window,
        const void* f1, const void* f2, const void* tw, int t, int full,
        int n, int n1, int n2, int n_windows, int groups, int fold,
        int precision, int three_mult, int combine_fold, cudaStream_t s) {
  if (groups < 1 || groups > n_windows || (groups > 1 && part == nullptr) ||
      !serves(precision))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto launch =
      precision ? kspec_tcs::launch_high : kspec_tcs::launch_default;
  const int err = launch(is_u8, three_mult, re, im, out, part, starts,
                         weights, window, f1, f2, tw, t, full, n, n1, n2,
                         n_windows, groups, fold, s);
  if (err || groups == 1) return err;
  const long long total = static_cast<long long>(t) * n;
  kspec_tcs::combine_groups<<<static_cast<unsigned>((total + 255) / 256),
                              256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), t, n,
      groups, KSPEC_TCS_STOP ? kspec_tc::FOLD_SUM : combine_fold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  Planes are (t, full) row-major,
// float32 or uint8 (is_u8); out is (t, n) float32, part (t, groups, n)
// float32 scratch when groups > 1; starts (n_windows,) int32, weights
// (n_windows,) float32 (the decay weights times winAdj*2/n; the scale alone
// for MAX/MIN), window (n,) float32; f1, f2, tw the fragment-ordered tables
// of ops/cuda_tc.tc_split_tables for the split n = n1 * n2; groups the
// window groups (1..n_windows); precision 0 DEFAULT, 1 HIGH (the port's
// library), 2 HIGHEST (a -DKSPEC_TC_HIGHEST=1 build only); three_mult picks
// the 3M complex form.  Returns the CUDA error code of the launches
// (0 on success; cudaErrorInvalidValue where kspec_curscan_tc_split_mt is
// 0); the kernels run asynchronously on `stream`.
extern "C" int kspec_curscan_tc_split(const void* re, const void* im,
                                      int is_u8, void* out, void* part,
                                      const void* starts,
                                      const void* weights,
                                      const void* window, const void* f1,
                                      const void* f2, const void* tw, int t,
                                      int full, int n, int n1, int n2,
                                      int n_windows, int groups, int fold,
                                      int precision, int three_mult,
                                      void* stream) {
  return run(re, im, is_u8, out, part, starts, weights, window, f1, f2, tw,
             t, full, n, n1, n2, n_windows, groups, fold, precision,
             three_mult, fold, static_cast<cudaStream_t>(stream));
}

// The ablate build's entry point (-DKSPEC_TCS_ABLATE=1, forensics): the
// arguments of kspec_curscan_tc_split and `ablate`, a mask of
// kspec_tc::Ablate bits (0 runs the production kernel's operations).  Any
// other build refuses it (cudaErrorInvalidValue), as the ablate build
// refuses a split whose frame it cannot stage.
extern "C" int kspec_curscan_tc_split_ablate(
    const void* re, const void* im, int is_u8, void* out, void* part,
    const void* starts, const void* weights, const void* window,
    const void* f1, const void* f2, const void* tw, int t, int full, int n,
    int n1, int n2, int n_windows, int groups, int fold, int precision,
    int three_mult, int ablate, void* stream) {
  using namespace kspec_tc;
  if (!KSPEC_TCS_ABLATE || ablate < 0 || ablate >= 2 * AB_CUMULATE ||
      fold < 0 || fold >= (1 << AB_SHIFT))
    return static_cast<int>(cudaErrorInvalidValue);
  return run(re, im, is_u8, out, part, starts, weights, window, f1, f2, tw,
             t, full, n, n1, n2, n_windows, groups, fold | ablate << AB_SHIFT,
             precision, three_mult, ablated_fold(fold, ablate),
             static_cast<cudaStream_t>(stream));
}

// Kernel C's m-tiles a block for the split n1 x n2 at the class (precision
// 0-2, any build) and form (pick), or 0 where 16 rows of C do not fit a
// block's shared memory.
extern "C" int kspec_curscan_tc_split_mt(int n1, int n2, int precision,
                                         int three_mult) {
  if (precision < 0 || precision > 2) return 0;
  return kspec_tcs::pick(n1, n2, precision + 1, three_mult != 0);
}

// Kernel C's shared memory a block (bytes, layout()) for the split n1 x n2
// at the class and form, or 0 where kspec_curscan_tc_split_mt is 0.
extern "C" long long kspec_curscan_tc_split_smem(int n1, int n2,
                                                 int precision,
                                                 int three_mult) {
  if (precision < 0 || precision > 2) return 0;
  const int mt = kspec_tcs::pick(n1, n2, precision + 1, three_mult != 0);
  return mt ? static_cast<long long>(kspec_tcs::layout(
                  n1, n2, precision + 1, three_mult != 0, mt).total())
            : 0;
}

// The blocks an SM holds of the instantiation kspec_curscan_tc_split
// launches for these arguments (registers and shared memory), or -1 (also
// for a class the build does not serve).
extern "C" int kspec_curscan_tc_split_occupancy(int is_u8, int n1, int n2,
                                                int precision,
                                                int three_mult) {
  if (!serves(precision)) return -1;
  return precision
             ? kspec_tcs::occupancy_high(is_u8, three_mult, n1, n2)
             : kspec_tcs::occupancy_default(is_u8, three_mult, n1, n2);
}
