// Specband mel power, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel dmel_tpu/ops/pallas/specband_dmel.py:_fwd_kernel
// (+ _fwd_rest), launched by _specband_fwd, at k_sig = 1 (specband_mel_power)
// and at k_sig = K > 1 (specband_mel_power_multi: K windows, one per group
// of mel bands).  For each batch row b and frame t of the signal
// zero-padded by n_fft/2 on both sides it computes
//
//   X'[t, j]    = sum_m x[t*hop + m - n_fft/2] * (-1)^k e^{-2 pi i m k / N},
//                 k = j - J, j = 0 .. k_ext-1   (bins -J .. n_bins-1+J)
//   S_s[t, k]   = sum_{i=0}^{2J} rho[s, i] * X'[t, k + 2J - i]
//   P_s[t, k]   = Re(S_s)^2 + Im(S_s)^2,        k = 0 .. n_bins-1
//   mel[t, m]   = sum_k P_{band_map[m]}[t, k] fb[k, m]
//   out[b, m, t] = mel (or log(mel + 1e-10))
//
// The spectra X' do not depend on the window, so all K sigmas share one
// pass of the expensive part, as on the TPU ("marginal cost per sigma: one
// banded GEMM per output tile"); each sigma adds only its band convolution
// on the bins under its own mel bands.  X' is written to the xext buffer
// (rows, 2 kp), cos plane then sin plane, exact zeros from k_ext on; the
// band stage and K2 (specband_bwd.cu) read it.  In three launches:
//
// 0. sigma_range_kernel (sigma_ranges.cuh): each sigma's bin range [lo, hi)
//    from the filterbank and band_map.
// 1. the spectra stage, one of two, chosen on the host from n_fft alone
//    (dmel_tpu_torch/ops/fft_plan.py) and passed as the radices of its
//    plan:
//    - ext_fft_kernel, for every n_fft whose half has no prime factor
//      above 5 (all but 896 of the n_fft K1 takes: every power of two,
//      384, 640, 768).  A block owns max(1, 4096 / n_fft) frames, loads
//      them straight from x (centre padding masked), runs the
//      shared-memory FFT of frame_fft.cuh and writes each extended bin
//      from its FFT bin through a map kept on the host beside the plan
//      (fft_plan.ext_bin_map): bin k for 0 <= k <= N/2, the conjugate of
//      bin -k below and of N - k above, times (-1)^k.  The direct DFT was
//      ~93 % of K1's operations; with the FFT the function needs
//      2.5 N log2 N a frame for its spectra and (6J + 5) a bin for the
//      band convolution and power, and what bounds it on this card is
//      operations or bytes as chip_smoke.py:k1_bound finds: operations
//      at 1024 and 2048, bytes at 4096, where the xext write (2 k_ext
//      floats a frame, 266 MB at B = 32) sets the bound.  The design keeps
//      that buffer, written once and read once more by the band stage,
//      because K2 reads it as its residual.
//    - ext_dft_kernel, the direct DFT, for any other n_fft (896): X' as
//      one fp32 GEMM, frames (rows = B*n_frames, n_fft) times the
//      phase-flipped bases (n_fft, 2*kp), cos plane then sin plane.  The
//      frames are never materialised: each block reads its rows straight
//      from x, masking the centre padding.  This is 4*rows*n_fft*k_ext
//      flops, limited by fp32 FMA throughput: a register-blocked SIMT
//      GEMM, 128x128 block tiles, 8x8 outputs per thread, a 16-deep
//      contraction step staged through shared memory with the next step's
//      global loads in flight in registers; the bases are streamed tile by
//      tile and stay resident in the 50 MB L2.
// 2. band_mel_kernel: one block owns FR frames and stages their X' rows in
//    shared memory.  Then, one sigma at a time, it convolves the bins of
//    [lo, hi) with that sigma's 2J+1 taps, squares them into one power
//    buffer, projects them onto that sigma's mel bands and writes those
//    rows of the (B, n_mels, n_frames) output directly.  One power buffer
//    serves every sigma in turn: K buffers would need K x n_bins floats a
//    frame (64 KB a frame at n_fft 4096 and K = 8), past a block's shared
//    memory.  Any band_map works, contiguous or not: a sigma's range
//    covers all of its bands.  At k_sig = 1 the range is the filterbank's
//    nonzero bins and the result is bit for bit the one of a pass over
//    every bin (the products left out are exact zeros).
//
// What the TPU design needed and this one drops: the sliding-DFT
// recurrence and hop-delta GEMMs (the FFT needs fewer operations still),
// the bf16 hi/lo operand splits (fp32 needs none), the phase-major row
// layout and Nyquist split (128-lane tiling), and spectra carried between
// sequential grid steps (blocks here run in any order and own their
// output).
//
// C interface: specband_fwd() launches the three kernels on the given
// stream and returns cudaGetLastError(); it does not synchronise.

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
constexpr int MAX_TAPS = 128;    // taps a sigma: 2J + 1 with 2J < 128

#include "sigma_ranges.cuh"
#include "frame_fft.cuh"

// X' by the FFT stage: fr unwindowed frames a block through the
// shared-memory FFT; column j of each plane is FFT bin bins[j] times
// signs[plane, j] (zero where bins[j] < 0).
__global__ void __launch_bounds__(FFT_THREADS)
ext_fft_kernel(const float* __restrict__ x, const float* __restrict__ table,
               const int* __restrict__ bins, const float* __restrict__ signs,
               float* __restrict__ xext, int rows, int sig_len, int nfr,
               int hop, int n_fft, int kp, int fr, FftPlan plan) {
  extern __shared__ __align__(16) float2 fft_buf[];   // 2 x fr x n_fft/2
  const int m = n_fft / 2;
  const int row0 = blockIdx.x * fr;
  float2* a = fft_buf;
  float2* b = fft_buf + fr * m;
  fft_load_frames(a, x, nullptr, row0, fr, rows, sig_len, nfr, hop, n_fft);
  const float2* z = fft_frames(a, b, fr, n_fft, plan, table);
  for_frame_columns(fr, kp, [&](int f, int j) {
    const int r = row0 + f;
    if (r >= rows) return;
    const int k = __ldg(bins + j);
    float re = 0.f, im = 0.f;
    if (k >= 0) {
      const float2 v = rfft_bin(z + f * m, n_fft, k, table);
      re = __ldg(signs + j) * v.x;
      im = __ldg(signs + kp + j) * v.y;
    }
    float* dst = xext + (size_t)r * 2 * kp;
    dst[j] = re;
    dst[kp + j] = im;
  });
}

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
                const float* __restrict__ fb,
                const int* __restrict__ band_map,
                const int* __restrict__ sig_range, float* __restrict__ out,
                int rows, int nfr, int kp, int k_ext, int n_bins, int n_taps,
                int n_mels, int k_sig, int log_out) {
  extern __shared__ __align__(16) float smem[];
  float* xr = smem;                    // FR x k_ext, cos plane
  float* xi = xr + FR * k_ext;         // FR x k_ext, sin plane
  float* p = xi + FR * k_ext;          // FR x n_bins, one sigma's power
  float* taps = p + FR * n_bins;       // k_sig x n_taps
  int* map = reinterpret_cast<int*>(taps + k_sig * n_taps);   // n_mels

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * FR;
  const int ncol = 2 * kp;
  // trial blockIdx.y of a pack: its spectra rows, taps and output rows
  // (rows is one trial's)
  const size_t trial = blockIdx.y;
  xext += trial * (size_t)rows * ncol;
  rho += trial * (size_t)k_sig * n_taps;
  out += trial * (size_t)rows * n_mels;

  for (int i = tid; i < k_sig * n_taps; i += BAND_THREADS) taps[i] = rho[i];
  for (int m = tid; m < n_mels; m += BAND_THREADS)
    map[m] = band_map == nullptr ? 0 : band_map[m];
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

  const int two_j = n_taps - 1;
  for (int s = 0; s < k_sig; ++s) {
    // the spectra, and the previous sigma's power read by its mel pass
    __syncthreads();
    const int lo = __ldg(sig_range + 2 * s);
    const int hi = __ldg(sig_range + 2 * s + 1);
    const int width = hi - lo;
    const float* ts = taps + s * n_taps;
    for (int i = tid; i < FR * width; i += BAND_THREADS) {
      const int f = i / width;
      const int k = lo + i - f * width;
      const float* ar = xr + f * k_ext + k + two_j;
      const float* ai = xi + f * k_ext + k + two_j;
      float sr = 0.f, si = 0.f;
      for (int d = 0; d < n_taps; ++d) {
        const float w = ts[d];
        sr = fmaf(w, ar[-d], sr);
        si = fmaf(w, ai[-d], si);
      }
      p[f * n_bins + k] = sr * sr + si * si;
    }
    __syncthreads();

    // (mel m, frame f) pairs of this sigma's bands with f fastest:
    // neighbouring threads write neighbouring frames of one mel band.  The
    // filterbank is zero outside [lo, hi) for these bands.
    for (int i = tid; i < FR * n_mels; i += BAND_THREADS) {
      const int m = i / FR;
      const int f = i - m * FR;
      const int r = row0 + f;
      if (r >= rows || map[m] != s) continue;
      const float* pf = p + f * n_bins;
      float acc = 0.f;
      for (int k = lo; k < hi; ++k)
        acc = fmaf(pf[k], __ldg(fb + (size_t)k * n_mels + m), acc);
      if (log_out) acc = logf(acc + 1e-10f);
      const int b = r / nfr;
      const int t = r - b * nfr;
      out[((size_t)b * n_mels + m) * nfr + t] = acc;
    }
  }
}

}  // namespace

extern "C" {

const char* specband_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A pack of `trials` trials, each of `batch` signal rows: x (trials*batch,
// sig_len); rho (trials, k_sig, n_taps), one tap vector a (trial, sigma);
// fb (n_bins, n_mels); band_map (n_mels) int32, each mel band's sigma in
// [0, k_sig), or null for k_sig = 1; sig_range scratch (k_sig, 2) int32;
// xext scratch (trials*batch*nfr, 2*kp); out (trials*batch, n_mels, nfr).
// The spectra do not depend on the taps: one pass serves every trial's
// rows.  The band stage takes the trial as a grid dimension, so trial k's
// outputs are bit for bit those of a launch with trials = 1 on its rows
// and taps.  The filterbank, the spectra stage's constants and the sigma
// ranges are shared.  The spectra
// stage: radices (n_stages ints, host memory), the FFT's plan, with table
// (2, n_fft), cos then -sin of 2 pi i / n_fft, bins (kp) int32 and signs
// (2, kp), the extended-bin map; or radices null and n_stages = -1 for
// the direct DFT with basis (n_fft, 2*kp).  Operands the stage does not
// read may be null.  All fp32 unless stated, contiguous, on the current
// device.
int specband_fwd(const float* x, const float* basis, const float* table,
                 const int* bins, const float* signs, const float* rho,
                 const float* fb, const int* band_map, int* sig_range,
                 float* xext, float* out, int batch, int trials, int sig_len,
                 int nfr, int hop, int n_fft, int kp, int k_ext, int n_bins,
                 int n_taps, int n_mels, int k_sig, int log_out,
                 const int* radices, int n_stages, void* stream) {
  const int rows = batch * nfr;
  if (batch <= 0 || trials <= 0 || trials > 65535 || nfr <= 0 ||
      rows / nfr != batch || (trials * rows) / trials != rows ||
      (2 * kp) % BN != 0 || k_ext > kp || n_taps > MAX_TAPS ||
      n_bins != n_fft / 2 + 1 || n_bins + n_taps - 1 != k_ext ||
      n_mels <= 0 || k_sig < 1 || k_sig > MAX_SIGMA ||
      (k_sig > 1 && band_map == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FftPlan plan;
  const bool fft = n_stages >= 0;
  if (fft ? !fft_plan_from(radices, n_stages, n_fft, &plan) ||
                table == nullptr || bins == nullptr || signs == nullptr
          : n_fft % BK != 0 || basis == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  sigma_range_kernel<<<1, RANGE_THREADS, 0, s>>>(fb, band_map, n_bins,
                                                 n_mels, k_sig, sig_range);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // the spectra of every trial's rows in one grid
  const int all_rows = trials * rows;
  if (fft) {
    const int fr = fft_frames_per_block(n_fft);
    const size_t smem = fft_smem_bytes(n_fft);
    err = cudaFuncSetAttribute(ext_fft_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ext_fft_kernel<<<(all_rows + fr - 1) / fr, FFT_THREADS, smem, s>>>(
        x, table, bins, signs, xext, all_rows, sig_len, nfr, hop, n_fft, kp,
        fr, plan);
  } else {
    dim3 grid1((all_rows + BM - 1) / BM, (2 * kp) / BN);
    ext_dft_kernel<<<grid1, GEMM_THREADS, 0, s>>>(
        x, basis, xext, all_rows, sig_len, nfr, hop, n_fft, 2 * kp);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = sizeof(float) * ((size_t)FR * (2 * k_ext + n_bins) +
                                       (size_t)k_sig * n_taps + n_mels);
  err = cudaFuncSetAttribute(band_mel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_mel_kernel<<<dim3((rows + FR - 1) / FR, trials), BAND_THREADS, smem,
                    s>>>(
      xext, rho, fb, band_map, sig_range, out, rows, nfr, kp, k_ext, n_bins,
      n_taps, n_mels, k_sig, log_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
