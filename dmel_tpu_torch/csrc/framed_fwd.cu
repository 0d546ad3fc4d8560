// Framed mel power, forward, for Hopper (sm_90a): windowed frames, real
// DFT, power and mel projection, keeping Re/Im for the backward.
//
// Replaces two TPU kernels that compute the same function:
//   dmel_tpu/ops/pallas/framed_dmel.py:_fwd_kernel (K3, launched by _fwd),
//     which builds the frames in the kernel from lane-aligned group rows;
//   dmel_tpu/ops/pallas/fused_dmel.py:_kernel_core (K5, launched by
//     _forward), which takes frames built by XLA and covers n_fft <= 4096.
// Both differ only in TPU-specific ways (Mosaic cannot load from an
// unaligned HBM offset; the bf16 hi/lo operand splits and the lowbin /
// hiprec variants are precision workarounds of the TPU's matrix unit).  A
// thread block here reads a frame at any offset of the signal, and every
// product runs in fp32 FMAs, so one kernel serves both: framed_fwd() is
// K3's entry point and fused_fwd() K5's.
//
// For each batch row b and frame t of the signal zero-padded by n_fft/2 on
// both sides (row r = b * n_frames + t):
//
//   fw[r, m]  = x[b, t*hop + m - n_fft/2] * w[m],          m < n_fft
//   Re[r, k]  = sum_m fw[r, m] cos(2 pi ((m k) mod N) / N),  k < n_bins
//   Im[r, k]  = -sum_m fw[r, m] sin(2 pi ((m k) mod N) / N)
//   mel[r, j] = sum_k (Re^2 + Im^2)[r, k] fb[k, j]  over fb's nonzeros
//   out[b, j, t] = mel[r, j]
//
// The phase is the exact integer (m k) mod N, indexed into an N-entry
// cos / -sin table built in float64 and rounded once to fp32: a float
// angle 2 pi m k / N loses several bits at N = 4096.
//
// Two launches:
//
// 1. frame_dft_kernel: Re|Im as one fp32 GEMM, windowed frames (rows,
//    n_fft) times the bases (n_fft, 2 kp), cos plane in columns [0, kp),
//    -sin plane in [kp, 2 kp), both zero past n_bins.  The frames are never
//    materialised: each block reads its rows straight from x, masking the
//    centre padding, and multiplies by the window as it loads.  The bases
//    are never materialised either: each B element is a table entry at a
//    running phase index.  This is 4 rows n_fft kp flops, so the kernel is
//    limited by fp32 FMA throughput.  The function itself needs an FFT per
//    frame, ~n_fft / (1.25 log2 n_fft) times fewer operations, and those
//    set its least time (chip_smoke.py:framed_bound); an FFT and the tensor
//    cores are later work.  The design answer here is K1's register-blocked
//    SIMT GEMM: 128x128 block tiles, 8x8 outputs a thread, a 16-deep
//    contraction step staged through shared memory with the next step's
//    loads in flight in registers.  Re|Im is written in fp32 as the
//    backward's residual (the TPU kept bf16 to save VMEM).
// 2. power_mel_kernel: one block owns FR frame rows, stages their power in
//    shared memory and projects it onto each mel band over the band's
//    contiguous range of nonzero filterbank rows (a triangular filter has
//    at most two nonzeros a bin), writing (B, n_mels, n_frames) directly.
//
// C interface: framed_fwd() and fused_fwd() launch both kernels on the
// given stream and return cudaGetLastError(); they do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // GEMM rows (frames) per block
constexpr int BN = 128;          // GEMM columns (bins, cos then -sin)
constexpr int BK = 16;           // contraction step
constexpr int GEMM_THREADS = 256;
constexpr int A_PAD = 4;         // keeps the transposed A stores conflict-free

constexpr int FR = 8;            // frame rows per block in power_mel_kernel
constexpr int MEL_THREADS = 256;

__global__ void __launch_bounds__(GEMM_THREADS)
frame_dft_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ table, float* __restrict__ reim,
                 int rows, int sig_len, int nfr, int hop, int n_fft, int kp,
                 int n_bins) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int ncol = 2 * kp;
  const int pad = n_fft / 2;

  // A loader: 8 elements a thread, (row a_m + 16 e, depth a_k): 16
  // neighbouring threads read 16 neighbouring samples of one frame.
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
  // B loader: 4 neighbouring columns a thread, depth rows b_k and b_k + 8.
  // Column j is bin k of the cos plane (j < kp) or the -sin plane; its
  // phase index (m k) mod N advances by (BK k) mod N each step.
  const int b_k = tid >> 5;
  const int b_n = (tid & 31) * 4;
  const float* b_tab[4];
  bool b_ok[4];
  int b_i0[4], b_i1[4], b_step[4];
  #pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = col0 + b_n + q;
    const bool sin_plane = j >= kp;
    const int k = sin_plane ? j - kp : j;
    b_ok[q] = k < n_bins;
    const int kk = b_ok[q] ? k : 0;
    b_tab[q] = table + (sin_plane ? n_fft : 0);
    b_i0[q] = (b_k * kk) % n_fft;
    b_i1[q] = ((b_k + 8) * kk) % n_fft;
    b_step[q] = (BK * kk) % n_fft;
  }

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
  float b_reg0[4], b_reg1[4];

  auto load_tiles = [&](int k0) {
    const int m = k0 + a_k;
    const float wm = m < n_fft ? __ldg(w + m) : 0.f;
    #pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int p = a_pos[e] + k0;
      a_reg[e] = (p >= 0 && p < sig_len) ? __ldg(a_src[e] + p) * wm : 0.f;
    }
    const bool m0_ok = k0 + b_k < n_fft;
    const bool m1_ok = k0 + b_k + 8 < n_fft;
    #pragma unroll
    for (int q = 0; q < 4; ++q) {
      b_reg0[q] = (b_ok[q] && m0_ok) ? __ldg(b_tab[q] + b_i0[q]) : 0.f;
      b_reg1[q] = (b_ok[q] && m1_ok) ? __ldg(b_tab[q] + b_i1[q]) : 0.f;
      b_i0[q] += b_step[q];
      if (b_i0[q] >= n_fft) b_i0[q] -= n_fft;
      b_i1[q] += b_step[q];
      if (b_i1[q] >= n_fft) b_i1[q] -= n_fft;
    }
  };

  load_tiles(0);
  for (int k0 = 0; k0 < n_fft; k0 += BK) {
    #pragma unroll
    for (int e = 0; e < 8; ++e) As[a_k][a_m + 16 * e] = a_reg[e];
    *reinterpret_cast<float4*>(&Bs[b_k][b_n]) =
        make_float4(b_reg0[0], b_reg0[1], b_reg0[2], b_reg0[3]);
    *reinterpret_cast<float4*>(&Bs[b_k + 8][b_n]) =
        make_float4(b_reg1[0], b_reg1[1], b_reg1[2], b_reg1[3]);
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
    float* dst = reim + (size_t)r * ncol + col0;
    *reinterpret_cast<float4*>(dst + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

__global__ void __launch_bounds__(MEL_THREADS)
power_mel_kernel(const float* __restrict__ reim, const float* __restrict__ fb,
                 const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
                 float* __restrict__ out, int rows, int nfr, int kp,
                 int n_bins, int n_mels) {
  extern __shared__ __align__(16) float p[];     // FR x n_bins, power

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * FR;
  const int ncol = 2 * kp;

  for (int i = tid; i < FR * n_bins; i += MEL_THREADS) {
    const int f = i / n_bins;
    const int k = i - f * n_bins;
    const int r = row0 + f;
    float v = 0.f;
    if (r < rows) {
      const float* src = reim + (size_t)r * ncol;
      const float re = src[k];
      const float im = src[kp + k];
      v = re * re + im * im;
    }
    p[i] = v;
  }
  __syncthreads();

  // (mel j, frame f) pairs with f fastest: neighbouring threads write
  // neighbouring frames of one mel band.
  for (int i = tid; i < FR * n_mels; i += MEL_THREADS) {
    const int j = i / FR;
    const int f = i - j * FR;
    const int r = row0 + f;
    if (r >= rows) continue;
    const float* pf = p + f * n_bins;
    float acc = 0.f;
    const int hi = __ldg(mel_hi + j);
    for (int k = __ldg(mel_lo + j); k < hi; ++k)
      acc = fmaf(pf[k], __ldg(fb + (size_t)k * n_mels + j), acc);
    const int b = r / nfr;
    const int t = r - b * nfr;
    out[((size_t)b * n_mels + j) * nfr + t] = acc;
  }
}

int launch(const float* x, const float* w, const float* table,
           const float* fb, const int* mel_lo, const int* mel_hi,
           float* reim, float* out, int batch, int sig_len, int nfr, int hop,
           int n_fft, int kp, int n_bins, int n_mels, cudaStream_t s) {
  const int rows = batch * nfr;
  dim3 grid1((rows + BM - 1) / BM, (2 * kp) / BN);
  frame_dft_kernel<<<grid1, GEMM_THREADS, 0, s>>>(
      x, w, table, reim, rows, sig_len, nfr, hop, n_fft, kp, n_bins);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = sizeof(float) * (size_t)FR * n_bins;
  err = cudaFuncSetAttribute(power_mel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  power_mel_kernel<<<(rows + FR - 1) / FR, MEL_THREADS, smem, s>>>(
      reim, fb, mel_lo, mel_hi, out, rows, nfr, kp, n_bins, n_mels);
  return static_cast<int>(cudaGetLastError());
}

bool bad_geometry(int batch, int nfr, int hop, int n_fft, int kp, int n_bins,
                  int n_mels) {
  return batch <= 0 || nfr <= 0 || (batch * nfr) / nfr != batch ||
         hop <= 0 || n_fft < 2 || n_fft % 2 != 0 || n_bins != n_fft / 2 + 1 ||
         kp < n_bins || (2 * kp) % BN != 0 || n_mels <= 0;
}

}  // namespace

extern "C" {

const char* framed_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (batch, sig_len); w (n_fft); table (2, n_fft): cos then -sin of
// 2 pi i / n_fft; fb (n_bins, n_mels) dense; mel_lo / mel_hi (n_mels) int32,
// each band's nonzero bin range; reim (batch*nfr, 2*kp); out (batch, n_mels,
// nfr).  All fp32 unless stated, contiguous, on the current device.

// K3: n_fft a multiple of 128, at most 1024 (the framed route's geometry).
int framed_fwd(const float* x, const float* w, const float* table,
               const float* fb, const int* mel_lo, const int* mel_hi,
               float* reim, float* out, int batch, int sig_len, int nfr,
               int hop, int n_fft, int kp, int n_bins, int n_mels,
               void* stream) {
  if (bad_geometry(batch, nfr, hop, n_fft, kp, n_bins, n_mels) ||
      n_fft % 128 != 0 || n_fft > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(x, w, table, fb, mel_lo, mel_hi, reim, out, batch, sig_len,
                nfr, hop, n_fft, kp, n_bins, n_mels,
                static_cast<cudaStream_t>(stream));
}

// K5: any even n_fft up to 4096; w is the window centred in n_fft.
int fused_fwd(const float* x, const float* w, const float* table,
              const float* fb, const int* mel_lo, const int* mel_hi,
              float* reim, float* out, int batch, int sig_len, int nfr,
              int hop, int n_fft, int kp, int n_bins, int n_mels,
              void* stream) {
  if (bad_geometry(batch, nfr, hop, n_fft, kp, n_bins, n_mels) ||
      n_fft > 4096) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(x, w, table, fb, mel_lo, mel_hi, reim, out, batch, sig_len,
                nfr, hop, n_fft, kp, n_bins, n_mels,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
