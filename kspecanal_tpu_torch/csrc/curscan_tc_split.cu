// Tensor-core two-stage DFT curscan for any split n = n1 * n2 (Kernel C),
// DEFAULT instantiations and the C entry points; the kernel is in
// curscan_tc_split.cuh, the HIGH instantiations in curscan_tc_split_high.cu.
//
// Replaces: kspecanal_tpu/ops/pallas_curscan.py::_kernel (:116) and
// ::_kernel_sublane (:423) at tpuPrecision HIGH and DEFAULT where Kernel A
// does not take the config (see curscan_tc_split.cuh).

#include "curscan_tc_split.cuh"

namespace kspec_tcs {

int launch_default(int is_u8, int three_mult, const void* re, const void* im,
                   void* out, const void* starts, const void* weights,
                   const void* window, const void* f1, const void* f2,
                   const void* tw, int t, int full, int n, int n1, int n2,
                   int n_windows, int fold, cudaStream_t stream) {
  return launch_class<false>(is_u8, three_mult, re, im, out, starts, weights,
                            window, f1, f2, tw, t, full, n, n1, n2,
                            n_windows, fold, stream);
}

}  // namespace kspec_tcs

// Plain C entry point (bound with ctypes).  Planes are (t, full) row-major,
// float32 or uint8 (is_u8); out is (t, n) float32; starts (n_windows,)
// int32, weights (n_windows,) float32 (the decay weights times winAdj*2/n;
// the scale alone for MAX/MIN), window (n,) float32; f1, f2, tw the
// fragment-ordered tables of ops/cuda_tc.tc_split_tables for the split
// n = n1 * n2; precision 0 DEFAULT, 1 HIGH; three_mult picks the 3M
// complex form.  Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue where kspec_curscan_tc_split_mt is 0); the kernel
// runs asynchronously on `stream`.
extern "C" int kspec_curscan_tc_split(const void* re, const void* im,
                                      int is_u8, void* out,
                                      const void* starts,
                                      const void* weights,
                                      const void* window, const void* f1,
                                      const void* f2, const void* tw, int t,
                                      int full, int n, int n1, int n2,
                                      int n_windows, int fold, int precision,
                                      int three_mult, void* stream) {
  const auto launch =
      precision ? kspec_tcs::launch_high : kspec_tcs::launch_default;
  return launch(is_u8, three_mult, re, im, out, starts, weights, window, f1,
                f2, tw, t, full, n, n1, n2, n_windows, fold,
                static_cast<cudaStream_t>(stream));
}

// Kernel C's m-tiles a block for the split n1 x n2 at the class and form
// (pick_mt), or 0 where 16 rows of C do not fit a block's shared memory.
extern "C" int kspec_curscan_tc_split_mt(int n1, int n2, int precision,
                                         int three_mult) {
  return n1 < 1 || n2 < 1
             ? 0
             : kspec_tcs::pick_mt(n1, n2, precision != 0, three_mult != 0);
}
