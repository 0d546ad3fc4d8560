// Specband mel power, backward into the window taps, for Hopper (sm_90a).
//
// Replaces the TPU kernel dmel_tpu/ops/pallas/specband_dmel.py:_bwd_kernel,
// launched by _specband_bwd, at k_sig = 1 and at k_sig = K > 1 (the
// multi-sigma function: K tap vectors, mel band m taken from tap vector
// band_map[m]).  Given the extended-bin spectra X' that the forward kernel
// (specband_fwd.cu) left in global memory, the taps rho (K, 2J+1), the
// dense (n_bins, n_mels) filterbank fb and the cotangent of the mel output,
// it computes for every frame row t (all batch*n_frames rows)
//
//   g[t, m]     = dmel[t, m]   (or dlog[t, m] * exp(-logmel[t, m]) when the
//                               forward emitted log(mel + 1e-10))
//   dP_s[t, k]  = sum_{m: band_map[m] = s} g[t, m] * fb[k, m]
//   S_s[t, k]   = sum_i rho[s, i] * X'[t, k + 2J - i]   (both planes, as
//                                                        band_mel_kernel)
//   drho[s, i]  = sum_t sum_k 2 dP_s[t, k] * (S_s,re[t, k] X'_re[t, k+2J-i]
//                                          + S_s,im[t, k] X'_im[t, k+2J-i])
//
// This is the gradient in the taps.  The TPU kernel returned it as the
// gradient of the banded Toeplitz matrix band_matrix(rho) (width x 128),
// whose entries are these same 2J+1 numbers; summing that matrix's
// gradient over each band diagonal gives drho, so the two agree.
//
// What bounds it on this card: operations.  Per frame row the function
// needs the recomputed S (~(6J+2) flops a bin), the tap products
// (4 (2J+1) a bin) and dP over the filterbank's nonzeros, ~0.18 MFLOP at
// n_fft 1024 and J = 24, against 2 k_ext floats of X' read once (4.5 KB):
// ~40 flops a byte, above the fp32 FMA units' ~20 flops a byte.  The design
// keeps X' off device memory after one read and does all arithmetic in
// fp32 FMAs:
//
// 0. sigma_range_kernel (sigma_ranges.cuh): each sigma's bin range from
//    the filterbank and band_map.
// 1. band_grad_kernel: one block owns FR frame rows.  It stages their X'
//    rows (cos and sin planes) and g in shared memory once.  Then, one
//    sigma at a time and only over that sigma's bins, it forms dP_s with
//    one warp per bin (a coalesced read of the dense filterbank row serves
//    all FR rows; the bands of other sigmas are masked, so a bin whose two
//    mel bands belong to two sigmas gives each its own share), the
//    recomputed S_s and the products w = 2 dP_s S_s in shared memory, and
//    each warp takes taps i = warp, warp + 8, ... and reduces
//    sum_t,k w * X' over the block's rows with a fixed lane order and a
//    shuffle tree; lane 0 writes the block's partial sum to
//    partials[s, i, block].  X' is read from device memory once for all
//    K sigmas.
// 2. tap_sum_kernel: one block per (sigma, tap) sums its partials in a
//    fixed order and a shared-memory tree.  No float atomics anywhere, so
//    two runs give bit-identical drho (the TPU package likewise sums its
//    per-block parts outside the kernel).
//
// What the TPU design needed and this one drops: bf16 residuals and the
// bf16 casts of dS and T (fp32 throughout), the stacked-adjoint concat
// (GEMM shapes for the MXU), the phase-major frame_io row order and the
// Nyquist split (128-lane tiling).  Bin n_bins-1 is an ordinary bin here.
// Reusing X' across taps in registers and the tensor cores are later work.
//
// C interface: specband_bwd() launches the three kernels on the given
// stream and returns cudaGetLastError(); it does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FR = 4;            // frame rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TAPS = 128;    // taps a sigma: 2J + 1 with 2J < 128
constexpr int SUM_THREADS = 256;

#include "sigma_ranges.cuh"

__global__ void __launch_bounds__(THREADS)
band_grad_kernel(const float* __restrict__ xext, const float* __restrict__ rho,
                 const float* __restrict__ fb, const float* __restrict__ dmel,
                 const float* __restrict__ logmel,
                 const int* __restrict__ band_map,
                 const int* __restrict__ sig_range,
                 float* __restrict__ partials, int rows, int nfr, int kp,
                 int k_ext, int n_bins, int n_taps, int n_mels, int k_sig) {
  extern __shared__ __align__(16) float smem[];
  float* xr = smem;                    // FR x k_ext, cos plane
  float* xi = xr + FR * k_ext;         // FR x k_ext, sin plane
  float* wr = xi + FR * k_ext;         // FR x n_bins, dP, then 2 dP S_re
  float* wi = wr + FR * n_bins;        // FR x n_bins, 2 dP S_im
  float* g = wi + FR * n_bins;         // FR x n_mels, mel-power cotangent
  float* taps = g + FR * n_mels;       // k_sig x n_taps
  int* map = reinterpret_cast<int*>(taps + k_sig * n_taps);   // n_mels

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * FR;
  const int ncol = 2 * kp;
  const int two_j = n_taps - 1;

  for (int i = tid; i < k_sig * n_taps; i += THREADS) taps[i] = rho[i];
  for (int m = tid; m < n_mels; m += THREADS)
    map[m] = band_map == nullptr ? 0 : band_map[m];
  for (int i = tid; i < FR * k_ext; i += THREADS) {
    const int f = i / k_ext;
    const int j = i - f * k_ext;
    const int r = row0 + f;
    float re = 0.f, im = 0.f;
    if (r < rows) {
      const float* src = xext + (size_t)r * ncol;
      re = src[j];
      im = src[kp + j];
    }
    xr[i] = re;
    xi[i] = im;
  }
  // (mel m, frame f) pairs with f fastest: neighbouring threads read
  // neighbouring frames of one mel band of the (B, n_mels, n_frames) input.
  for (int i = tid; i < FR * n_mels; i += THREADS) {
    const int m = i / FR;
    const int f = i - m * FR;
    const int r = row0 + f;
    float v = 0.f;
    if (r < rows) {
      const int b = r / nfr;
      const int t = r - b * nfr;
      const size_t at = ((size_t)b * n_mels + m) * nfr + t;
      v = dmel[at];
      if (logmel != nullptr) v *= expf(-logmel[at]);
    }
    g[f * n_mels + m] = v;
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int s = 0; s < k_sig; ++s) {
    // The bins [lo32, hi) with lo32 = lo rounded down to a multiple of 32:
    // dP_s is zero outside [lo, hi), and lane l still takes the bins
    // k = l (mod 32) below, so the sums keep their order (k_sig = 1 gives
    // the result of a pass over every bin, bit for bit).
    const int lo = __ldg(sig_range + 2 * s) & ~31;
    const int hi = __ldg(sig_range + 2 * s + 1);
    const float* ts = taps + s * n_taps;
    // the staged operands, and the previous sigma's w read by its tap sums
    __syncthreads();

    // dP_s: one warp per bin, lanes over the mel bands, so each warp reads
    // a filterbank row once, coalesced, for all FR rows; the bands of
    // other sigmas are masked out, which splits a bin whose two bands
    // belong to two sigmas.  dP_s goes to wr.
    for (int k = lo + warp; k < hi; k += WARPS) {
      const float* fbk = fb + (size_t)k * n_mels;
      float acc[FR];
      #pragma unroll
      for (int f = 0; f < FR; ++f) acc[f] = 0.f;
      for (int m = lane; m < n_mels; m += 32) {
        const float v = map[m] == s ? __ldg(fbk + m) : 0.f;
        #pragma unroll
        for (int f = 0; f < FR; ++f)
          acc[f] = fmaf(g[f * n_mels + m], v, acc[f]);
      }
      #pragma unroll
      for (int f = 0; f < FR; ++f) {
        #pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], off);
      }
      if (lane == 0) {
        #pragma unroll
        for (int f = 0; f < FR; ++f) wr[f * n_bins + k] = acc[f];
      }
    }
    __syncthreads();

    // S_s recomputed from the taps; w = 2 dP_s S_s in place of dP_s.
    const int width = hi - lo;
    for (int i = tid; i < FR * width; i += THREADS) {
      const int f = i / width;
      const int k = lo + i - f * width;
      const int at = f * n_bins + k;
      const float dp2 = 2.f * wr[at];
      const float* ar = xr + f * k_ext + k + two_j;
      const float* ai = xi + f * k_ext + k + two_j;
      float sr = 0.f, si = 0.f;
      for (int d = 0; d < n_taps; ++d) {
        const float w = ts[d];
        sr = fmaf(w, ar[-d], sr);
        si = fmaf(w, ai[-d], si);
      }
      wr[at] = dp2 * sr;
      wi[at] = dp2 * si;
    }
    __syncthreads();

    for (int d = warp; d < n_taps; d += WARPS) {
      const int shift = two_j - d;
      float acc = 0.f;
      for (int f = 0; f < FR; ++f) {
        const float* wrf = wr + f * n_bins;
        const float* wif = wi + f * n_bins;
        const float* xrf = xr + f * k_ext + shift;
        const float* xif = xi + f * k_ext + shift;
        for (int k = lo + lane; k < hi; k += 32) {
          acc = fmaf(wrf[k], xrf[k], acc);
          acc = fmaf(wif[k], xif[k], acc);
        }
      }
      #pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0)
        partials[((size_t)s * n_taps + d) * gridDim.x + blockIdx.x] = acc;
    }
  }
}

__global__ void __launch_bounds__(SUM_THREADS)
tap_sum_kernel(const float* __restrict__ partials, float* __restrict__ drho,
               int n_blocks) {
  __shared__ float red[SUM_THREADS];
  const float* src = partials + (size_t)blockIdx.x * n_blocks;
  float acc = 0.f;
  for (int j = threadIdx.x; j < n_blocks; j += SUM_THREADS) acc += src[j];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = SUM_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) drho[blockIdx.x] = red[0];
}

}  // namespace

extern "C" {

const char* specband_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Frame rows per block of band_grad_kernel: the caller sizes partials as
// (n_taps, ceil(rows / specband_bwd_rows_per_block())).
int specband_bwd_rows_per_block() { return FR; }

// xext (rows, 2*kp) as specband_fwd wrote it; rho (k_sig, n_taps); fb
// (n_bins, n_mels); dmel and logmel (batch, n_mels, nfr), logmel null
// without the log epilogue; band_map (n_mels) int32, each mel band's sigma
// in [0, k_sig), or null for k_sig = 1; sig_range scratch (k_sig, 2) int32;
// partials scratch (k_sig * n_taps, n_blocks); drho (k_sig, n_taps).  All
// fp32 unless stated, contiguous, on the current device.
int specband_bwd(const float* xext, const float* rho, const float* fb,
                 const float* dmel, const float* logmel, const int* band_map,
                 int* sig_range, float* partials, float* drho, int rows,
                 int nfr, int kp, int k_ext, int n_bins, int n_taps,
                 int n_mels, int k_sig, void* stream) {
  if (rows <= 0 || nfr <= 0 || rows % nfr != 0 || k_ext > kp ||
      n_taps <= 0 || n_taps > MAX_TAPS || n_bins + n_taps - 1 != k_ext ||
      n_mels <= 0 || k_sig < 1 || k_sig > MAX_SIGMA ||
      (k_sig > 1 && band_map == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sigma_range_kernel<<<1, RANGE_THREADS, 0, s>>>(fb, band_map, n_bins,
                                                 n_mels, k_sig, sig_range);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_blocks = (rows + FR - 1) / FR;
  const size_t smem =
      sizeof(float) * ((size_t)FR * (2 * k_ext + 2 * n_bins + n_mels) +
                       (size_t)k_sig * n_taps + n_mels);
  err = cudaFuncSetAttribute(
      band_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_grad_kernel<<<n_blocks, THREADS, smem, s>>>(
      xext, rho, fb, dmel, logmel, band_map, sig_range, partials, rows, nfr,
      kp, k_ext, n_bins, n_taps, n_mels, k_sig);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tap_sum_kernel<<<k_sig * n_taps, SUM_THREADS, 0, s>>>(partials, drho,
                                                         n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
