// The mixed-radix FFT curscan kernel with one thread block per window
// (FROM_PLANES: fft <= 16384 and not a power of two), instantiated apart
// from curscan_mixed.cu so that nvcc builds the two in parallel.

#include "curscan_mixed.cuh"

int kspec_fft::launch_mixed_planes(const void* re, const void* im, int is_u8,
                                   float* dst, const void* starts,
                                   const void* weights, const void* window,
                                   const void* roots, const void* pass_roots,
                                   int t, int full_size, int n,
                                   int n_windows, int groups, int fold,
                                   int stop, cudaStream_t stream) {
  return is_u8 ? launch_mixed<uint8_t, FROM_PLANES>(
                     re, im, nullptr, dst, starts, weights, window, roots,
                     pass_roots, t, full_size, n, 1, n_windows, groups, fold,
                     stop, stream)
               : launch_mixed<float, FROM_PLANES>(
                     re, im, nullptr, dst, starts, weights, window, roots,
                     pass_roots, t, full_size, n, 1, n_windows, groups, fold,
                     stop, stream);
}
