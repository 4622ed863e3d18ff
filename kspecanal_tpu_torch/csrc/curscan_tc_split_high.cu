// Tensor-core two-stage DFT curscan for any split (Kernel C), HIGH
// instantiations (the bf16x3 split; in a -DKSPEC_TC_HIGHEST=1 build,
// forensics only, the six-pass HIGHEST class in their place); a translation
// unit of its own so that nvcc builds it beside curscan_tc_split.cu.  The
// kernel is in curscan_tc_split.cuh.

#include "curscan_tc_split.cuh"

namespace kspec_tcs {

int launch_high(int is_u8, int three_mult, const void* re, const void* im,
                void* out, void* part, const void* starts,
                const void* weights, const void* window, const void* f1,
                const void* f2, const void* tw, int t, int full, int n,
                int n1, int n2, int n_windows, int groups, int fold,
                cudaStream_t stream) {
  return launch_class<kspec_tc::HIGH_PARTS>(
      is_u8, three_mult, re, im, out, part, starts, weights, window, f1, f2,
      tw, t, full, n, n1, n2, n_windows, groups, fold, stream);
}

int occupancy_high(int is_u8, int three_mult, int n1, int n2) {
  return occupancy_class<kspec_tc::HIGH_PARTS>(is_u8, three_mult, n1, n2);
}

}  // namespace kspec_tcs
