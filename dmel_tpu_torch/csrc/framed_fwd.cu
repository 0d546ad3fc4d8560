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
// thread block here reads a frame at any offset of the signal and every
// product runs in fp32, so framed_fwd() (K3) and fused_fwd() (K5) compute
// one function:
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
// Re|Im is written in fp32 as the backward's residual, (rows, 2 kp): Re in
// columns [0, kp), Im in [kp, 2 kp), exact zeros past n_bins in each (the
// TPU kept bf16 to save VMEM).  Every cos / -sin is an entry of an N-entry
// table built in float64 and rounded once to fp32, at an exact integer
// phase: a float angle 2 pi m k / N loses several bits at N = 4096.
//
// Both entries take one of three spectra stages, chosen on the host from
// n_fft alone (dmel_tpu_torch/ops/fft_plan.py) and passed as the stage's
// radices (and, for Bluestein's, its padded length and two tables):
//
// - the FFT stage, one launch of fused_fft_kernel, for every even
//   n_fft up to 4096 whose half has no prime factor above 5: every bucket
//   the fused route takes and faithful 3000 (K5), every n_fft of the
//   framed route but 896 = 2^7 7 (K3: 128 to 1024).  A block owns
//   max(1, 4096 / n_fft) frames.  It loads them windowed straight from x,
//   masking the centre padding, runs the shared-memory FFT of
//   frame_fft.cuh, writes Re|Im with the zero pad columns, stages the
//   power in the FFT's free buffer and projects it onto the mel bands.
//   The FFT needs ~n_fft / (1.25 log2 n_fft) times fewer operations than
//   the direct DFT (555 GFLOP at 4096 and B = 32 become ~2), so what
//   bounds the function on this card is the bytes it must move, most of
//   them the Re|Im residual written once (262 MB at 4096 and B = 32;
//   chip_smoke.py:framed_bound).  The design writes that residual once,
//   coalesced, and reads nothing back: the power goes from shared memory
//   to the mel output in the same block, where the direct stage reads the
//   residual again.
// - Bluestein's stage, one launch of fused_bluestein_kernel (K5 only), at
//   every other even n_fft up to 4096: faithful mode's n_fft = 2 T (1400,
//   and 1494 of the 1536 T in (512, 2048]).  Each frame's M = n_fft / 2
//   points go through frame_fft.cuh's chirp-z (bluestein_frames): two
//   power-of-two FFTs of P >= 2 M - 1 points (P = 2048 at faithful T
//   513-1024, 4096 above) as register-resident passes, max(1, 4096 / P)
//   frames a block in 34 KB of shared memory.  The DFT lands at the
//   planned stage's frame stride, so the post-pass and the residual are
//   the planned kernel's code.  What bounded the first design of the
//   stage (2.75 ms at faithful B 512 x 2039 against a 0.0673 ms bytes
//   bound): the two FFTs' ~15 passes through shared memory and twiddle
//   gathers from L2 (65 % and a quarter of the time), then the mel
//   projection (17 %: 64 threads each walking a band down fb's columns,
//   a line a bin).  Here the FFTs take 4 exchanges a frame and read their
//   twiddles by stage, and the mel projection reads fb_t, band by band,
//   8 bins ahead (mel_project_t): 0.68 ms, 4.0x less, against
//   torch.stft + mel's 1.40 (tools/bluestein_split.py and PERF.md;
//   NVIDIA H100 80GB HBM3, 700 W).  Built for 3 blocks an SM (80
//   registers; 4 blocks, at 64, spilled and ran up to 1.04x slower).
// - the direct stage, two launches, wherever the caller passes no stage
//   (K3 at 896; chip_smoke.py times it at every shape as direct_ms):
//   frame_dft_kernel then power_mel_kernel.
//
// fused_fft_kernel takes 256 threads, at most 64 registers (no spills)
// and 32 KB of shared memory a block (frame_fft.cuh), fused_bluestein_kernel
// 256 threads, at most 85 registers and 34 KB (chip_smoke.py's build phase
// prints ptxas's counts).  The direct stage:
//
// 1. frame_dft_kernel: Re|Im as one fp32 GEMM, windowed frames (rows,
//    n_fft) times the bases (n_fft, 2 kp), cos plane in columns [0, kp),
//    -sin plane in [kp, 2 kp), both zero past n_bins.  The frames are never
//    materialised: each block reads its rows straight from x, masking the
//    centre padding, and multiplies by the window as it loads.  The bases
//    are never materialised either: each B element is a table entry at a
//    running phase index.  This is 4 rows n_fft kp flops, so the kernel is
//    limited by fp32 FMA throughput.  The design answer is K1's
//    register-blocked SIMT GEMM: 128x128 block tiles, 8x8 outputs a
//    thread, a 16-deep contraction step staged through shared memory with
//    the next step's loads in flight in registers.
// 2. power_mel_kernel: one block owns FR frame rows, stages their power in
//    shared memory and projects it onto each mel band over the band's
//    contiguous range of nonzero filterbank rows (a triangular filter has
//    at most two nonzeros a bin), writing (B, n_mels, n_frames) directly.
//
// C interface: framed_fwd() and fused_fwd() launch their kernels on the
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

#include "frame_fft.cuh"

// Projects the power p (nf frame rows of n_bins, rows row0 ..) onto each
// mel band over its nonzero bin range [mel_lo, mel_hi), writing (B,
// n_mels, nfr).  (mel j, frame f) pairs with f fastest: neighbouring
// threads write neighbouring frames of one mel band.  NT threads.
template <int NT>
__device__ __forceinline__ void mel_project(
    const float* p, const float* __restrict__ fb,
    const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
    float* __restrict__ out, int row0, int nf, int rows, int nfr,
    int n_bins, int n_mels) {
  for (int i = threadIdx.x; i < nf * n_mels; i += NT) {
    const int j = i / nf;
    const int f = i - j * nf;
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
  // trial blockIdx.z of a pack: its rows / nfr signal rows, its window,
  // its Re|Im rows (rows is one trial's)
  const size_t trial = blockIdx.z;
  x += trial * (size_t)(rows / nfr) * sig_len;
  w += trial * n_fft;
  reim += trial * (size_t)rows * ncol;

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
  // trial blockIdx.y of a pack (rows is one trial's)
  reim += (size_t)blockIdx.y * rows * ncol;
  out += (size_t)blockIdx.y * rows * n_mels;

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
  mel_project<MEL_THREADS>(p, fb, mel_lo, mel_hi, out, row0, FR, rows, nfr,
                           n_bins, n_mels);
}

// mel_project over the transposed filterbank fb_t (n_mels, n_bins), for
// Bluestein's kernel: band j's weights lie side by side (~16 KB of lines
// in all at n_fft 4096, which stay in L1, where fb's column j is a line a
// bin), and each chain of fmas takes its powers and weights 8 at a time,
// loaded ahead of their fmas, where mel_project waits on a load a bin.
// The same sum, weight for weight and in the same order.  (A warp a band,
// its lanes 32 bins apart and a butterfly of shuffles, measured slower:
// PERF.md.)
template <int NT>
__device__ __forceinline__ void mel_project_t(
    const float* p, const float* __restrict__ fb_t,
    const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
    float* __restrict__ out, int row0, int nf, int rows, int nfr,
    int n_bins, int n_mels) {
  for (int i = threadIdx.x; i < nf * n_mels; i += NT) {
    const int j = i / nf;
    const int f = i - j * nf;
    const int r = row0 + f;
    if (r >= rows) continue;
    const float* pf = p + f * n_bins;
    const float* wj = fb_t + (size_t)j * n_bins;
    float acc = 0.f;
    int k = __ldg(mel_lo + j);
    const int hi = __ldg(mel_hi + j);
    for (; k + 8 <= hi; k += 8) {
      float pk[8], wk[8];
      #pragma unroll
      for (int e = 0; e < 8; ++e) {
        pk[e] = pf[k + e];
        wk[e] = __ldg(wj + k + e);
      }
      #pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(pk[e], wk[e], acc);
    }
    for (; k < hi; ++k) acc = fmaf(pf[k], __ldg(wj + k), acc);
    const int b = r / nfr;
    const int t = r - b * nfr;
    out[((size_t)b * n_mels + j) * nfr + t] = acc;
  }
}

// K5's FFT stage: fr frames a block, windowed, through the plan's
// shared-memory FFT; Re|Im with its zero pad columns to the residual, the
// power to the buffer the FFT left free, then the mel projection.
__global__ void __launch_bounds__(FFT_THREADS)
fused_fft_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ table,
                 const float* __restrict__ fb, const int* __restrict__ mel_lo,
                 const int* __restrict__ mel_hi, float* __restrict__ reim,
                 float* __restrict__ out, int rows, int sig_len, int nfr,
                 int hop, int n_fft, int kp, int n_bins, int n_mels, int fr,
                 FftStage stage) {
  // 2 x fr x n_fft / 2 points
  extern __shared__ __align__(16) float2 fft_buf[];
  const int m = n_fft / 2;
  const int row0 = blockIdx.x * fr;
  // trial blockIdx.y of a pack: its signal rows, window and outputs (rows
  // is one trial's)
  const size_t trial = blockIdx.y;
  x += trial * (size_t)(rows / nfr) * sig_len;
  w += trial * n_fft;
  reim += trial * (size_t)rows * 2 * kp;
  out += trial * (size_t)rows * n_mels;
  float2* a = fft_buf;
  float2* b = fft_buf + fr * m;
  fft_load_frames(a, x, w, row0, fr, rows, sig_len, nfr, hop, n_fft);
  const float2* z = fft_frames(a, b, fr, n_fft, stage.plan, table);
  // fr x n_bins power in the buffer the FFT left free (fr n_fft floats)
  float* p = reinterpret_cast<float*>(z == a ? b : a);
  for_frame_columns(fr, kp, [&](int f, int k) {
    const int r = row0 + f;
    if (r >= rows) return;
    float2 v = make_float2(0.f, 0.f);
    if (k < n_bins) {
      v = rfft_bin(z + f * m, n_fft, k, table);
      p[f * n_bins + k] = v.x * v.x + v.y * v.y;
    }
    float* dst = reim + (size_t)r * 2 * kp;
    dst[k] = v.x;
    dst[kp + k] = v.y;
  });
  __syncthreads();
  mel_project<FFT_THREADS>(p, fb, mel_lo, mel_hi, out, row0, fr, rows, nfr,
                           n_bins, n_mels);
}

// K5's Bluestein stage: fused_fft_kernel with frame_fft.cuh's
// bluestein_frames for the FFT (max(1, 4096 / m_pad) frames a block, 34 KB
// of shared memory, built for BLUESTEIN_FWD_BLOCKS blocks an SM), the power
// in the room the DFT leaves, the mel projection over fb_t.
__global__ void __launch_bounds__(FFT_THREADS, BLUESTEIN_FWD_BLOCKS)
fused_bluestein_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ table,
                       const float* __restrict__ fb_t,
                       const int* __restrict__ mel_lo,
                       const int* __restrict__ mel_hi,
                       float* __restrict__ reim, float* __restrict__ out,
                       int rows, int sig_len, int nfr, int hop, int n_fft,
                       int kp, int n_bins, int n_mels, int fr,
                       FftStage stage) {
  // fr x (m_pad + m_pad / 16) points
  extern __shared__ __align__(16) float2 fft_buf[];
  const int m = n_fft / 2;
  const int row0 = blockIdx.x * fr;
  // trial blockIdx.y of a pack: its signal rows, window and outputs (rows
  // is one trial's)
  const size_t trial = blockIdx.y;
  x += trial * (size_t)(rows / nfr) * sig_len;
  w += trial * n_fft;
  reim += trial * (size_t)rows * 2 * kp;
  out += trial * (size_t)rows * n_mels;
  // this thread's frame's samples in pairs z[n] = x[2n] + i x[2n+1],
  // windowed (w in pairs: n_fft is even)
  const float2* w2 = reinterpret_cast<const float2*>(w);
  const int r = row0 + bl_frame(stage.m_pad);
  const bool row_ok = r < rows;
  const float* src = x;
  int start = 0;
  if (row_ok) {
    const int b = r / nfr;
    src = x + (size_t)b * sig_len;
    start = (r - b * nfr) * hop - m;
  }
  auto load = [&](int, int n) {
    float2 v = make_float2(0.f, 0.f);
    if (row_ok) {
      const int p = start + 2 * n;
      const float2 wn = __ldg(w2 + n);
      if (p >= 0 && p < sig_len) v.x = __ldg(src + p) * wn.x;
      if (p + 1 >= 0 && p + 1 < sig_len) v.y = __ldg(src + p + 1) * wn.y;
    }
    return v;
  };
  const float2* z = bluestein_frames(fft_buf, n_fft, stage, load);
  // fr x n_bins power past the DFT's fr m points
  float* p = reinterpret_cast<float*>(fft_buf + fr * m);
  for_frame_columns(fr, kp, [&](int f, int k) {
    const int r = row0 + f;
    if (r >= rows) return;
    float2 v = make_float2(0.f, 0.f);
    if (k < n_bins) {
      v = rfft_bin(z + f * m, n_fft, k, table);
      p[f * n_bins + k] = v.x * v.x + v.y * v.y;
    }
    float* dst = reim + (size_t)r * 2 * kp;
    dst[k] = v.x;
    dst[kp + k] = v.y;
  });
  __syncthreads();
  mel_project_t<FFT_THREADS>(p, fb_t, mel_lo, mel_hi, out, row0, fr, rows,
                             nfr, n_bins, n_mels);
}

// The direct stage: frame_dft_kernel, then power_mel_kernel.
int launch_direct(const float* x, const float* w, const float* table,
                  const float* fb, const int* mel_lo, const int* mel_hi,
                  float* reim, float* out, int batch, int trials,
                  int sig_len, int nfr, int hop, int n_fft, int kp,
                  int n_bins, int n_mels, cudaStream_t s) {
  const int rows = batch * nfr;
  dim3 grid1((rows + BM - 1) / BM, (2 * kp) / BN, trials);
  frame_dft_kernel<<<grid1, GEMM_THREADS, 0, s>>>(
      x, w, table, reim, rows, sig_len, nfr, hop, n_fft, kp, n_bins);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = sizeof(float) * (size_t)FR * n_bins;
  err = cudaFuncSetAttribute(power_mel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  power_mel_kernel<<<dim3((rows + FR - 1) / FR, trials), MEL_THREADS, smem,
                     s>>>(
      reim, fb, mel_lo, mel_hi, out, rows, nfr, kp, n_bins, n_mels);
  return static_cast<int>(cudaGetLastError());
}

// The FFT stage: one launch of fused_fft_kernel.
int launch_fft(const float* x, const float* w, const float* table,
               const float* fb, const float* fb_t, const int* mel_lo,
               const int* mel_hi, float* reim, float* out, int batch,
               int trials, int sig_len, int nfr, int hop, int n_fft, int kp,
               int n_bins, int n_mels, const FftStage& stage,
               cudaStream_t s) {
  const int rows = batch * nfr;
  const int fr = fft_stage_frames(n_fft, stage);
  const size_t smem = fft_stage_smem(n_fft, stage);
  const dim3 grid((rows + fr - 1) / fr, trials);
  cudaError_t err;
  if (stage.m_pad) {
    err = cudaFuncSetAttribute(fused_bluestein_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_bluestein_kernel<<<grid, FFT_THREADS, smem, s>>>(
        x, w, table, fb_t, mel_lo, mel_hi, reim, out, rows, sig_len, nfr,
        hop, n_fft, kp, n_bins, n_mels, fr, stage);
  } else {
    err = cudaFuncSetAttribute(fused_fft_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_fft_kernel<<<grid, FFT_THREADS, smem, s>>>(
        x, w, table, fb, mel_lo, mel_hi, reim, out, rows, sig_len, nfr, hop,
        n_fft, kp, n_bins, n_mels, fr, stage);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_geometry(int batch, int trials, int nfr, int hop, int n_fft, int kp,
                  int n_bins, int n_mels) {
  return batch <= 0 || trials <= 0 || trials > 65535 || nfr <= 0 ||
         (batch * nfr) / nfr != batch ||
         hop <= 0 || n_fft < 2 || n_fft % 2 != 0 || n_bins != n_fft / 2 + 1 ||
         kp < n_bins || (2 * kp) % BN != 0 || n_mels <= 0;
}

// Any stage, from the host's arguments (fft_stage_from; n_stages < 0 with
// m_pad = 0: the direct stage); a stage that is not one of n_fft is
// refused.
int launch_stage(const float* x, const float* w, const float* table,
                 const float* fb, const float* fb_t, const int* mel_lo,
                 const int* mel_hi, float* reim, float* out, int batch,
                 int trials, int sig_len, int nfr, int hop, int n_fft,
                 int kp, int n_bins, int n_mels, const int* radices,
                 int n_stages, int m_pad,
                 const float* bl_table, const float* bl_hat, cudaStream_t s) {
  if (bad_geometry(batch, trials, nfr, hop, n_fft, kp, n_bins, n_mels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_stages < 0 && m_pad == 0) {
    return launch_direct(x, w, table, fb, mel_lo, mel_hi, reim, out, batch,
                         trials, sig_len, nfr, hop, n_fft, kp, n_bins, n_mels,
                         s);
  }
  FftStage stage;
  if (!fft_stage_from(radices, n_stages, n_fft, m_pad, bl_table, bl_hat,
                      &stage)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_fft(x, w, table, fb, fb_t, mel_lo, mel_hi, reim, out, batch,
                    trials, sig_len, nfr, hop, n_fft, kp, n_bins, n_mels,
                    stage, s);
}

}  // namespace

extern "C" {

const char* framed_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A pack of `trials` trials, each of `batch` signal rows: x (trials*batch,
// sig_len), trial k's rows k*batch ..; w (trials, n_fft), one window a
// trial; table (2, n_fft): cos then -sin of 2 pi i / n_fft; fb (n_bins,
// n_mels) dense and fb_t, its transpose (n_mels, n_bins), read by
// Bluestein's stage only; mel_lo / mel_hi (n_mels) int32, each band's
// nonzero bin range; reim (trials*batch*nfr, 2*kp); out (trials*batch,
// n_mels, nfr).
// Each kernel takes the trial as a grid dimension, so trial k's outputs are
// bit for bit those of a launch with trials = 1 on its rows and window.
// All fp32 unless stated, contiguous, on the current device.

// The spectra stage is (radices, n_stages, m_pad, bl_table, bl_hat), as
// ops/framed.py:_stage_args passes it: radices (n_stages ints, host
// memory) the plan of the complex FFT of length n_fft / 2 with m_pad = 0
// and both tables null; or, with m_pad > 0, Bluestein's (fused_fwd only):
// the plan of the m_pad-point FFT (radix 4, then at most one radix 2;
// m_pad at least 16), bl_table (m_pad + n_fft / 2, 2): its twiddles by
// stage, then the chirp (fft_plan.py:bluestein_table_np), and bl_hat
// (m_pad, 2) FFT(b) / m_pad of the conjugate chirp
// (fft_plan.py:bluestein_kernel_np), on the device; or the direct stage,
// radices null, n_stages = -1, m_pad = 0.  Anything else is refused.

// K3: n_fft a multiple of 128, at most 1024 (the framed route's geometry);
// no Bluestein stage.
int framed_fwd(const float* x, const float* w, const float* table,
               const float* fb, const float* fb_t, const int* mel_lo,
               const int* mel_hi, float* reim, float* out, int batch,
               int trials, int sig_len, int nfr, int hop, int n_fft, int kp,
               int n_bins, int n_mels, const int* radices, int n_stages,
               int m_pad,
               const float* bl_table, const float* bl_hat, void* stream) {
  if (n_fft % 128 != 0 || n_fft > 1024 || m_pad != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_stage(x, w, table, fb, fb_t, mel_lo, mel_hi, reim, out,
                      batch, trials, sig_len, nfr, hop, n_fft, kp, n_bins,
                      n_mels, radices, n_stages, m_pad, bl_table, bl_hat,
                      static_cast<cudaStream_t>(stream));
}

// K5: any even n_fft up to 4096; w is the window centred in n_fft.
int fused_fwd(const float* x, const float* w, const float* table,
              const float* fb, const float* fb_t, const int* mel_lo,
              const int* mel_hi, float* reim, float* out, int batch,
              int trials, int sig_len, int nfr, int hop, int n_fft, int kp,
              int n_bins, int n_mels, const int* radices, int n_stages,
              int m_pad,
              const float* bl_table, const float* bl_hat, void* stream) {
  if (n_fft > 4096) return static_cast<int>(cudaErrorInvalidValue);
  return launch_stage(x, w, table, fb, fb_t, mel_lo, mel_hi, reim, out,
                      batch, trials, sig_len, nfr, hop, n_fft, kp, n_bins,
                      n_mels, radices, n_stages, m_pad, bl_table, bl_hat,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
