// The mixed-radix FFT curscan kernel's route (see curscan_mixed.cuh for the
// kernel): the scratch route and the clusters are instantiated here, one
// block per window in curscan_mixed_planes.cu.

#include "curscan_mixed.cuh"

int kspec_fft::launch_mixed_route(const void* re, const void* im, int is_u8,
                                  void* scratch, float* dst,
                                  const void* starts, const void* weights,
                                  const void* window, const void* roots,
                                  const void* pass_roots, int t,
                                  int full_size, int n, int c, int chunk,
                                  int n_windows, int groups, int fold,
                                  int stop, cudaStream_t stream) {
  if (scratch != nullptr)
    return is_u8 ? launch_hbm<uint8_t>(re, im, scratch, dst, starts, weights,
                                       window, roots, pass_roots, t,
                                       full_size, n, c, chunk, n_windows,
                                       groups, fold, stop, stream)
                 : launch_hbm<float>(re, im, scratch, dst, starts, weights,
                                     window, roots, pass_roots, t, full_size,
                                     n, c, chunk, n_windows, groups, fold,
                                     stop, stream);
  if (c > 1)
    return is_u8 ? launch_mixed<uint8_t, FROM_CLUSTER>(
                       re, im, nullptr, dst, starts, weights, window, roots,
                       pass_roots, t, full_size, n, c, n_windows, groups,
                       fold, stop, stream)
                 : launch_mixed<float, FROM_CLUSTER>(
                       re, im, nullptr, dst, starts, weights, window, roots,
                       pass_roots, t, full_size, n, c, n_windows, groups,
                       fold, stop, stream);
  return kspec_fft::launch_mixed_planes(re, im, is_u8, dst, starts, weights,
                                       window, roots, pass_roots, t,
                                       full_size, n, n_windows, groups, fold,
                                       stop, stream);
}
