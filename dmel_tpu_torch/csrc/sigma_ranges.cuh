// Per-sigma bin ranges of a mel filterbank, computed on the card; included
// by specband_fwd.cu (K1) inside its anonymous namespace.  K2
// (specband_bwd.cu) finds the same ranges, and each bin's bands, with its
// own kernel, a warp a bin over many blocks.
//
// A multi-sigma specband call computes mel band m from the spectrum of tap
// vector band_map[m].  Sigma s needs its power only on the bins under its
// bands: [lo, hi), the smallest range that holds every
// nonzero fb[k, m] with band_map[m] == s ([0, 0) for a sigma without a
// nonzero).  The ranges follow from the filterbank operand the kernels are
// given, so they are found here rather than passed in.  One block reads the
// (n_bins, n_mels) filterbank once, coalesced, and keeps the running
// minimum and maximum with integer atomics in shared memory: the result
// does not depend on the order the threads run in.  Outside [lo, hi) the
// sigma's products with the filterbank are exact zeros, so leaving those
// bins out changes no sum, bit for bit (k_sig = 1 included).

constexpr int MAX_SIGMA = 8;          // the JAX package's k_sig * 128 <= 1024
constexpr int RANGE_THREADS = 1024;

__global__ void __launch_bounds__(RANGE_THREADS)
sigma_range_kernel(const float* __restrict__ fb,
                   const int* __restrict__ band_map, int n_bins, int n_mels,
                   int k_sig, int* __restrict__ sig_range) {
  __shared__ int lo[MAX_SIGMA];
  __shared__ int hi[MAX_SIGMA];
  if (threadIdx.x < k_sig) {
    lo[threadIdx.x] = n_bins;
    hi[threadIdx.x] = 0;
  }
  __syncthreads();
  const int n = n_bins * n_mels;
  #pragma unroll 4
  for (int i = threadIdx.x; i < n; i += RANGE_THREADS) {
    if (__ldg(fb + i) != 0.f) {
      const int k = i / n_mels;
      const int s = band_map == nullptr ? 0 : __ldg(band_map + i - k * n_mels);
      atomicMin(&lo[s], k);
      atomicMax(&hi[s], k + 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < k_sig) {
    const int h = hi[threadIdx.x];
    sig_range[2 * threadIdx.x] = h == 0 ? 0 : lo[threadIdx.x];
    sig_range[2 * threadIdx.x + 1] = h;
  }
}
