// Specband mel power, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel dmel_tpu/ops/pallas/specband_dmel.py:_fwd_kernel
// (+ _fwd_rest), launched by _specband_fwd.  For each batch row b and frame
// t of the signal zero-padded by n_fft/2 on both sides it computes
//
//   X'[t, j] = sum_m x[t*hop + m - n_fft/2] * (-1)^k e^{-2 pi i m k / N},
//              k = j - J, j = 0 .. k_ext-1   (bins -J .. n_bins-1+J)
//   S[t, k]  = sum_{i=0}^{2J} rho[i] * X'[t, k + 2J - i]
//   P[t, k]  = Re(S)^2 + Im(S)^2,            k = 0 .. n_bins-1
//   mel[t]   = P[t, :] @ fb                  (n_bins x n_mels)
//   out[b, m, t] = mel (or log(mel + 1e-10))
//
// in two launches:
//
// 1. ext_dft_kernel: X' as one fp32 GEMM, frames (rows = B*n_frames, n_fft)
//    times the phase-flipped bases (n_fft, 2*kp), cos plane then sin plane.
//    The frames are never materialised: each block reads its rows straight
//    from x, masking the centre padding.  This is 4*rows*n_fft*k_ext flops,
//    ~93% of what this kernel computes, so the kernel is limited by fp32
//    FMA throughput, not by memory (it reads ~25 MB and writes ~16 MB at
//    the bench shape).  The function itself needs ~20x fewer operations
//    (an FFT per frame instead of a direct DFT), and those set its least
//    time on the card (chip_smoke.py:k1_bound); replacing the direct DFT
//    is a later optimisation.  The design answer here is a register-blocked
//    SIMT GEMM:
//    128x128 block tiles, 8x8 outputs per thread, a 16-deep contraction
//    step staged through shared memory with the next step's global loads
//    in flight in registers.  The bases (2.3 MB per plane at n_fft 1024)
//    do not fit a block's shared memory as the TPU kept them in VMEM; they
//    are streamed tile by tile and stay resident in the 50 MB L2.
// 2. band_mel_kernel: one block owns FR frames, stages their X' rows in
//    shared memory, convolves with the 2J+1 taps, squares, projects onto
//    the mel bands and writes the (B, n_mels, n_frames) output directly.
//
// What the TPU design needed and this one drops: the sliding-DFT
// recurrence and hop-delta GEMMs (fewer operations; a later optimisation
// here), the bf16 hi/lo operand splits (fp32 FMAs need none), the
// phase-major row layout and Nyquist split (128-lane tiling), and spectra
// carried between sequential grid steps (blocks here run in any order and
// own their output).
//
// C interface: specband_fwd() launches both kernels on the given stream
// and returns cudaGetLastError(); it does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // GEMM rows (frames) per block
constexpr int BN = 128;          // GEMM columns (extended bins) per block
constexpr int BK = 16;           // contraction step
constexpr int GEMM_THREADS = 256;
constexpr int A_PAD = 4;         // keeps the transposed A stores conflict-free

constexpr int FR = 4;            // frames per block in band_mel_kernel
constexpr int BAND_THREADS = 256;
constexpr int MAX_TAPS = 128;

__global__ void __launch_bounds__(GEMM_THREADS)
ext_dft_kernel(const float* __restrict__ x, const float* __restrict__ basis,
               float* __restrict__ xext, int rows, int sig_len, int nfr,
               int hop, int n_fft, int ncol) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int pad = n_fft / 2;

  // A loader: 8 elements a thread.  Element e is (row m, depth k) with
  // k = tid % 16 and m = tid / 16 + 16 e: 16 neighbouring threads read 16
  // neighbouring samples of one frame.
  const int a_k = tid & (BK - 1);
  const int a_m = tid >> 4;
  const float* a_src[8];
  int a_pos[8];
  #pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = row0 + a_m + 16 * e;
    if (r < rows) {
      const int b = r / nfr;
      const int t = r - b * nfr;
      a_src[e] = x + (size_t)b * sig_len;
      a_pos[e] = t * hop - pad + a_k;
    } else {
      a_src[e] = x;
      a_pos[e] = -0x40000000;      // never inside [0, sig_len)
    }
  }
  // B loader: two float4 a thread, rows b_k and b_k + 8.
  const int b_k = tid >> 5;
  const int b_n = (tid & 31) * 4;
  const float* b_src = basis + (size_t)b_k * ncol + col0 + b_n;

  // Output micro-tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
  // tx*4 + {0..3} and 64 + tx*4 + {0..3}; float4 shared-memory reads.
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[8][8];
  #pragma unroll
  for (int i = 0; i < 8; ++i)
    #pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float a_reg[8];
  float4 b_reg0, b_reg1;

  auto load_tiles = [&](int k0) {
    #pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int p = a_pos[e] + k0;
      a_reg[e] = (p >= 0 && p < sig_len) ? __ldg(a_src[e] + p) : 0.f;
    }
    b_reg0 = __ldg(reinterpret_cast<const float4*>(b_src + (size_t)k0 * ncol));
    b_reg1 = __ldg(reinterpret_cast<const float4*>(
        b_src + (size_t)(k0 + 8) * ncol));
  };

  load_tiles(0);
  for (int k0 = 0; k0 < n_fft; k0 += BK) {
    #pragma unroll
    for (int e = 0; e < 8; ++e) As[a_k][a_m + 16 * e] = a_reg[e];
    *reinterpret_cast<float4*>(&Bs[b_k][b_n]) = b_reg0;
    *reinterpret_cast<float4*>(&Bs[b_k + 8][b_n]) = b_reg1;
    __syncthreads();
    if (k0 + BK < n_fft) load_tiles(k0 + BK);
    #pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 c0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 c1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      #pragma unroll
      for (int i = 0; i < 8; ++i)
        #pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }

  #pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= rows) continue;
    float* dst = xext + (size_t)r * ncol + col0;
    *reinterpret_cast<float4*>(dst + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

__global__ void __launch_bounds__(BAND_THREADS)
band_mel_kernel(const float* __restrict__ xext, const float* __restrict__ rho,
                const float* __restrict__ fb, float* __restrict__ out,
                int rows, int nfr, int kp, int k_ext, int n_bins, int n_taps,
                int n_mels, int log_out) {
  extern __shared__ __align__(16) float smem[];
  float* xr = smem;                    // FR x k_ext, cos plane
  float* xi = xr + FR * k_ext;         // FR x k_ext, sin plane
  float* p = xi + FR * k_ext;          // FR x n_bins, power
  __shared__ float taps[MAX_TAPS];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * FR;
  const int ncol = 2 * kp;

  if (tid < n_taps) taps[tid] = rho[tid];
  for (int i = tid; i < FR * k_ext; i += BAND_THREADS) {
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
  __syncthreads();

  const int two_j = n_taps - 1;
  for (int i = tid; i < FR * n_bins; i += BAND_THREADS) {
    const int f = i / n_bins;
    const int k = i - f * n_bins;
    const float* ar = xr + f * k_ext + k + two_j;
    const float* ai = xi + f * k_ext + k + two_j;
    float sr = 0.f, si = 0.f;
    for (int d = 0; d < n_taps; ++d) {
      const float w = taps[d];
      sr = fmaf(w, ar[-d], sr);
      si = fmaf(w, ai[-d], si);
    }
    p[i] = sr * sr + si * si;
  }
  __syncthreads();

  // (mel m, frame f) pairs with f fastest: neighbouring threads write
  // neighbouring frames of one mel band.
  for (int i = tid; i < FR * n_mels; i += BAND_THREADS) {
    const int m = i / FR;
    const int f = i - m * FR;
    const int r = row0 + f;
    if (r >= rows) continue;
    const float* pf = p + f * n_bins;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k)
      acc = fmaf(pf[k], __ldg(fb + (size_t)k * n_mels + m), acc);
    if (log_out) acc = logf(acc + 1e-10f);
    const int b = r / nfr;
    const int t = r - b * nfr;
    out[((size_t)b * n_mels + m) * nfr + t] = acc;
  }
}

}  // namespace

extern "C" {

const char* specband_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (batch, sig_len); basis (n_fft, 2*kp); rho (n_taps); fb (n_bins, n_mels);
// xext scratch (batch*nfr, 2*kp); out (batch, n_mels, nfr).  All fp32,
// contiguous, on the current device.
int specband_fwd(const float* x, const float* basis, const float* rho,
                 const float* fb, float* xext, float* out, int batch,
                 int sig_len, int nfr, int hop, int n_fft, int kp, int k_ext,
                 int n_bins, int n_taps, int n_mels, int log_out,
                 void* stream) {
  const int rows = batch * nfr;
  if (batch <= 0 || nfr <= 0 || rows / nfr != batch || n_fft % BK != 0 ||
      (2 * kp) % BN != 0 || k_ext > kp || n_taps > MAX_TAPS ||
      n_bins + n_taps - 1 != k_ext || n_mels <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  dim3 grid1((rows + BM - 1) / BM, (2 * kp) / BN);
  ext_dft_kernel<<<grid1, GEMM_THREADS, 0, s>>>(x, basis, xext, rows, sig_len,
                                                nfr, hop, n_fft, 2 * kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = sizeof(float) * (size_t)FR * (2 * k_ext + n_bins);
  err = cudaFuncSetAttribute(band_mel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_mel_kernel<<<(rows + FR - 1) / FR, BAND_THREADS, smem, s>>>(
      xext, rho, fb, out, rows, nfr, kp, k_ext, n_bins, n_taps, n_mels,
      log_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
