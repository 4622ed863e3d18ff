// Tensor-core two-stage DFT curscan (Kernel A), HIGH instantiations (the
// bf16x3 split; in a -DKSPEC_TC_HIGHEST=1 build, forensics only, the six-pass
// HIGHEST class in their place); a translation unit of its own so that nvcc
// builds it beside curscan_tc.cu.  The kernel is in curscan_tc.cuh.

#include "curscan_tc.cuh"

namespace kspec_tc {

int launch_high(int is_u8, int three_mult, const void* re, const void* im,
                void* out, void* part, const void* starts,
                const void* weights, const void* window, const void* f1,
                const void* f2, const void* tw, int t, int full, int n,
                int n1, int n_windows, int groups, int fold, int wb,
                cudaStream_t stream) {
  return launch_class<HIGH_PARTS>(is_u8, three_mult, re, im, out, part,
                                  starts, weights, window, f1, f2, tw, t,
                                  full, n, n1, n_windows, groups, fold, wb,
                                  stream);
}

int occupancy_high(int is_u8, int three_mult, int n1, int wb) {
  return occupancy_class<HIGH_PARTS>(is_u8, three_mult, n1, wb);
}

}  // namespace kspec_tc
