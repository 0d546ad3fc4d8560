// Framed and fused mel power, backward into the window, for Hopper (sm_90a).
//
// Replaces two TPU kernels through two entry points of the same kernels:
// framed_bwd() dmel_tpu/ops/pallas/framed_dmel.py:_bwd_kernel (K4), launched
// by _bwd, for the framed route's n_fft (a multiple of 128 up to 1024); and
// fused_bwd() dmel_tpu/ops/pallas/fused_dmel.py:_bwd_kernel (K6), launched
// by _bwd_dw_fused, for any even n_fft up to 4096 with the window centred
// in n_fft (faithful mode's n_fft = 2 T included), on the residual that the
// fused forward (framed_fwd.cu:fused_fwd, K5) leaves.  K6 computes the same
// function as K4; the TPU needed a second kernel for its VMEM tiling of
// large n_fft, and here the loaders and the epilogue mask every ragged
// tail (the last 128-sample column block, bins past n_bins) instead.
//
// Given the Re|Im residual that the forward kernel (framed_fwd.cu) left in
// global memory, the signal, the filterbank and the cotangent g of the (B, n_mels, n_frames) mel power, it computes for every
// frame row r = b * n_frames + t
//
//   dP[r, k]   = sum_j g[b, j, t] fb[k, j]        over fb's nonzeros
//   dRe[r, k]  = 2 Re[r, k] dP[r, k],   dIm[r, k] = 2 Im[r, k] dP[r, k]
//   dfw[r, m]  = sum_k dRe[r, k] cos(2 pi (m k mod N) / N)
//                    - dIm[r, k] sin(2 pi (m k mod N) / N)
//   dw[m]      = sum_r frame[r, m] dfw[r, m]
//
// with frame[r, m] = x[b, t*hop + m - n_fft/2] (zero in the centre
// padding).  This is the gradient in the window; lambda's follows by
// autograd through gaussian_window, as in XLA there.
//
// Three stages compute dfw, chosen on the host from n_fft alone
// (dmel_tpu_torch/ops/fft_plan.py) and passed as framed_fwd.cu's entries
// take them: both entries take the FFT stage wherever n_fft has a plan
// (framed_bwd, K4: every framed n_fft but 896 = 2^7 7; fused_bwd, K6:
// 2048, 4096, faithful 3000); fused_bwd takes Bluestein's stage at every
// other even n_fft (faithful 1400 = 2^3 5^2 7 and the rest of faithful
// mode's 2 T), and framed_bwd the direct stage at 896.  At the framed
// n_fft of 128 to 1024 a block holds 32 to 4 frames (4096 samples), and
// K3 leaves the same Re|Im layout (kp_of(n_fft) columns a plane) that K5
// leaves for K6.
//
// Bluestein's stage is adjoint_fft_dw_kernel<true>: Y at the start of
// frame_fft.cuh's one buffer, the pre-pass (times the chirp) read from it
// by the first pass of bluestein_frames (two P-point FFTs in
// register-resident passes), whose output lands at the planned stage's
// frame stride, so the dw products below are the same code.  What bounded
// the stage's first design (2.82 ms at faithful B 512 x 2039): the two
// FFTs (58 % of the time), then dP and Y (17 %: each thread's bins one
// after another, each waiting on its residual load).  Here a group is
// max(1, 4096 / P) frames in 34 KB, Y's loads are issued together, level
// by level (bluestein_half_spectrum), and the 16 dw sums a thread sit in
// shared memory past the buffer (16 KB), so that its registers hold the
// FFT's points: 1.00 ms, 2.8x less, against the exact backward's 2.78
// (tools/bluestein_split.py and PERF.md; NVIDIA H100 80GB HBM3, 700 W).
// Built for 2 blocks an SM (__launch_bounds__(256, 2): 128 registers, 76
// bytes of spills; 3 blocks, at 85 registers, ran 1.28-1.31x slower, 4
// 1.50-1.60x), and the grid is DW_BLOCKS_BLUESTEIN = 2 x 132 blocks.
//
// The FFT stage: one launch of adjoint_fft_dw_kernel<false>, then
// dw_sum_kernel.
// dfw is the inverse real FFT of each frame's dRe|dIm (frame_fft.cuh: the
// real pre-pass, then the Stockham stages on conjugated data), ~2.5 N
// log2 N flops a frame where the direct adjoint takes 4 kp N, so what
// bounds the function on this card is the bytes it must move, most of
// them the Re|Im residual read once (263 MB at 4096 and batch 32;
// chip_smoke.py:k4_bound).  A block of 256 threads owns
// max(1, 4096 / n_fft) frames at a time, as K5's forward does.  For each
// it reads the residual and the cotangent, forms dP over each bin's
// nonzero mel bands (the filterbank read transposed, so that neighbouring
// bins read neighbouring floats) and the half spectrum Y = dP (Re + i Im)
// in shared memory (dRe|dIm never reaches device memory), runs the
// pre-pass and the stages, and multiplies each dfw sample by its frame
// sample into one of 16 running sums a thread.  The grid is fixed,
// DW_BLOCKS blocks (a constant, not read from the device, so dw does not
// depend on the card) that each walk the frame groups blockIdx.x,
// blockIdx.x + DW_BLOCKS, ... in order: one partial of n_fft floats a
// block, 8.7 MB at 4096 where one a frame group would write as many bytes
// as the residual.  __launch_bounds__(256, 4) caps the planned stage's
// registers at 64, so the 4 x 132 blocks of the H100 are all resident at
// once: ptxas gives
// 64 registers with 168 bytes of spills, and the block takes 32 KB of
// shared memory (chip_smoke.py's build phase prints both).  Keeping the 16
// sums in shared memory instead (48 KB a block, 56 bytes of spills) was
// no faster on the H100 (PERF.md, Findings).
//
// The direct stage, three launches, for K4 at 896 (and, with no stage
// passed, at any n_fft: chip_smoke.py times it as direct_ms); the design
// keeps dfw on chip, as the TPU kernels did:
//
// 1. dreim_kernel: one block owns FR frame rows, stages their cotangent in
//    shared memory, forms dP over each bin's contiguous range of nonzero
//    mel bands (at most two for a triangular filterbank) and writes
//    dRe|dIm (rows, 2 kp) in the residual's layout, zero past n_bins.
// 2. adjoint_dw_kernel: K1's register-blocked SIMT GEMM (128x128 tiles,
//    8x8 outputs a thread, 16-deep steps through shared memory) of dRe|dIm
//    against the bases, generated from an N-entry cos / -sin table at the
//    exact integer phase (m k) mod N: 4 rows kp n_fft fp32 FMA flops,
//    ~38 GFLOP at n_fft 1024 and batch 32, so operations bound it.  Its
//    epilogue multiplies each dfw element by its frame sample, sums the
//    block's 128 rows per column in a fixed order and writes one partial
//    sum per (column, row block) to a (n_fft, blocks) buffer: dfw never
//    reaches device memory.
//
// Both end in dw_sum_kernel: one block per window sample sums its partials
// in a fixed order and a shared-memory tree.  No float atomics anywhere,
// so two runs give bit-identical dw (the TPU package likewise summed its
// per-block parts outside the kernel).
//
// What the TPU design needed and this one drops: the group-row layout and
// the phase-major row order (Mosaic's aligned loads), the bf16 residuals
// and the single-pass bf16 adjoint GEMMs (fp32 throughout), the Nyquist
// split (128-lane tiling).
//
// C interface: framed_bwd() and fused_bwd() check their geometry and the
// stage, launch the stage's kernels on the given stream and return
// cudaGetLastError(); they do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // GEMM rows (frames) per block
constexpr int BN = 128;          // GEMM columns (window samples) per block
constexpr int BK = 16;           // contraction step
constexpr int GEMM_THREADS = 256;
constexpr int A_PAD = 4;

constexpr int FR = 8;            // frame rows per block in dreim_kernel
constexpr int DP_THREADS = 256;
constexpr int SUM_THREADS = 256;

#include "frame_fft.cuh"

// The FFT stage's fixed grid: 4 blocks on each of the H100's 132 SMs;
// Bluestein's, as many as its kernel is built to keep resident
constexpr int DW_BLOCKS = 528;
constexpr int DW_BLOCKS_BLUESTEIN = 264;
static_assert(DW_BLOCKS_BLUESTEIN == 132 * BLUESTEIN_BWD_BLOCKS,
              "Bluestein's grid is its resident blocks");
// dw sums a thread keeps: a block's frames hold at most FFT_BLOCK_POINTS
// samples
constexpr int DW_SLOTS = FFT_BLOCK_POINTS / FFT_THREADS;

__global__ void __launch_bounds__(DP_THREADS)
dreim_kernel(const float* __restrict__ reim, const float* __restrict__ fb,
             const int* __restrict__ bin_lo, const int* __restrict__ bin_hi,
             const float* __restrict__ dmel, float* __restrict__ dreim,
             int rows, int nfr, int kp, int n_bins, int n_mels) {
  extern __shared__ __align__(16) float g[];     // FR x n_mels, cotangent

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * FR;
  const int ncol = 2 * kp;

  // (mel j, frame f) pairs with f fastest: neighbouring threads read
  // neighbouring frames of one mel band of the (B, n_mels, n_frames) input.
  for (int i = tid; i < FR * n_mels; i += DP_THREADS) {
    const int j = i / FR;
    const int f = i - j * FR;
    const int r = row0 + f;
    float v = 0.f;
    if (r < rows) {
      const int b = r / nfr;
      const int t = r - b * nfr;
      v = dmel[((size_t)b * n_mels + j) * nfr + t];
    }
    g[f * n_mels + j] = v;
  }
  __syncthreads();

  for (int i = tid; i < FR * kp; i += DP_THREADS) {
    const int f = i / kp;
    const int k = i - f * kp;
    const int r = row0 + f;
    if (r >= rows) continue;
    float dp = 0.f;
    if (k < n_bins) {
      const float* gf = g + f * n_mels;
      const int hi = __ldg(bin_hi + k);
      for (int j = __ldg(bin_lo + k); j < hi; ++j)
        dp = fmaf(gf[j], __ldg(fb + (size_t)k * n_mels + j), dp);
    }
    const float* src = reim + (size_t)r * ncol;
    float* dst = dreim + (size_t)r * ncol;
    const float dp2 = 2.f * dp;
    dst[k] = dp2 * src[k];
    dst[kp + k] = dp2 * src[kp + k];
  }
}

__global__ void __launch_bounds__(GEMM_THREADS)
adjoint_dw_kernel(const float* __restrict__ dreim,
                  const float* __restrict__ table,
                  const float* __restrict__ x, float* __restrict__ partials,
                  int rows, int sig_len, int nfr, int hop, int n_fft, int kp,
                  int n_bins) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red[BM / 8][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int ncol = 2 * kp;
  // trial blockIdx.z of a pack: its dRe|dIm rows, signal rows and partials
  // (rows is one trial's)
  const size_t trial = blockIdx.z;
  dreim += trial * (size_t)rows * ncol;
  x += trial * (size_t)(rows / nfr) * sig_len;
  partials += trial * (size_t)n_fft * gridDim.x;

  // A loader: dRe|dIm rows a_m + 16 e at depth a_k; 16 neighbouring threads
  // read 16 neighbouring columns of one row.
  const int a_k = tid & (BK - 1);
  const int a_m = tid >> 4;
  const float* a_src[8];
  bool a_ok[8];
  #pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = row0 + a_m + 16 * e;
    a_ok[e] = r < rows;
    a_src[e] = dreim + (size_t)(a_ok[e] ? r : 0) * ncol + a_k;
  }
  // B loader: 4 neighbouring window samples m a thread, depth rows b_k and
  // b_k + 8.  Depth row d is bin k = d (cos plane) or d - kp (-sin plane);
  // the phase index (m k) mod N advances by (BK m) mod N each step and
  // restarts where the -sin plane begins (kp is a multiple of BK).
  const int b_k = tid >> 5;
  const int b_n = (tid & 31) * 4;
  bool b_ok[4];
  int b_i0[4], b_i1[4], b_step[4], b_first0[4], b_first1[4];
  #pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = col0 + b_n + q;
    b_ok[q] = m < n_fft;
    const int mm = b_ok[q] ? m : 0;
    b_first0[q] = b_i0[q] = (b_k * mm) % n_fft;
    b_first1[q] = b_i1[q] = ((b_k + 8) * mm) % n_fft;
    b_step[q] = (BK * mm) % n_fft;
  }

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
    #pragma unroll
    for (int e = 0; e < 8; ++e)
      a_reg[e] = a_ok[e] ? __ldg(a_src[e] + k0) : 0.f;
    if (k0 == kp) {
      #pragma unroll
      for (int q = 0; q < 4; ++q) {
        b_i0[q] = b_first0[q];
        b_i1[q] = b_first1[q];
      }
    }
    const bool sin_plane = k0 >= kp;
    const float* tab = table + (sin_plane ? n_fft : 0);
    const int k = (sin_plane ? k0 - kp : k0) + b_k;
    const bool k0_ok = k < n_bins;
    const bool k1_ok = k + 8 < n_bins;
    #pragma unroll
    for (int q = 0; q < 4; ++q) {
      b_reg0[q] = (b_ok[q] && k0_ok) ? __ldg(tab + b_i0[q]) : 0.f;
      b_reg1[q] = (b_ok[q] && k1_ok) ? __ldg(tab + b_i1[q]) : 0.f;
      b_i0[q] += b_step[q];
      if (b_i0[q] >= n_fft) b_i0[q] -= n_fft;
      b_i1[q] += b_step[q];
      if (b_i1[q] >= n_fft) b_i1[q] -= n_fft;
    }
  };

  load_tiles(0);
  for (int k0 = 0; k0 < ncol; k0 += BK) {
    #pragma unroll
    for (int e = 0; e < 8; ++e) As[a_k][a_m + 16 * e] = a_reg[e];
    *reinterpret_cast<float4*>(&Bs[b_k][b_n]) =
        make_float4(b_reg0[0], b_reg0[1], b_reg0[2], b_reg0[3]);
    *reinterpret_cast<float4*>(&Bs[b_k + 8][b_n]) =
        make_float4(b_reg1[0], b_reg1[1], b_reg1[2], b_reg1[3]);
    __syncthreads();
    if (k0 + BK < ncol) load_tiles(k0 + BK);
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

  // Epilogue: dw partial of column m = sum over the block's rows of
  // frame[r, m] dfw[r, m]; this thread's 8 rows first, then the 16 row
  // groups through shared memory, each in a fixed order.
  const int pad = n_fft / 2;
  float col_sum[8];
  #pragma unroll
  for (int j = 0; j < 8; ++j) col_sum[j] = 0.f;
  #pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= rows) continue;
    const int b = r / nfr;
    const int t = r - b * nfr;
    const float* xb = x + (size_t)b * sig_len;
    const int base = t * hop - pad;
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      const int p = base + m;
      const float fr =
          (m < n_fft && p >= 0 && p < sig_len) ? __ldg(xb + p) : 0.f;
      col_sum[j] = fmaf(fr, acc[i][j], col_sum[j]);
    }
  }
  #pragma unroll
  for (int j = 0; j < 8; ++j)
    red[ty][j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4)] = col_sum[j];
  __syncthreads();
  if (tid < BN) {
    float s = 0.f;
    #pragma unroll
    for (int y = 0; y < BM / 8; ++y) s += red[y][tid];
    const int m = col0 + tid;
    if (m < n_fft) partials[(size_t)m * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(SUM_THREADS)
dw_sum_kernel(const float* __restrict__ partials, float* __restrict__ dw,
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
  if (threadIdx.x == 0) dw[blockIdx.x] = red[0];
}

// dP of bin k of one frame row: the sum over the bin's nonzero mel bands
// of g[j] fb[k, j], in dreim_kernel's order; g points at the row's
// cotangent of band 0, its bands nfr floats apart, and fb_t is the
// filterbank transposed, (n_mels, n_bins).
__device__ __forceinline__ float bin_dp(const float* __restrict__ g,
                                        const float* __restrict__ fb_t,
                                        const int* __restrict__ bin_lo,
                                        const int* __restrict__ bin_hi, int k,
                                        int nfr, int n_bins) {
  float dp = 0.f;
  const int hi = __ldg(bin_hi + k);
  for (int j = __ldg(bin_lo + k); j < hi; ++j)
    dp = fmaf(__ldg(g + (size_t)j * nfr), __ldg(fb_t + (size_t)j * n_bins + k),
              dp);
  return dp;
}

// Y (fr x m pairs, Y[k] = dP (Re + i Im)[k] at 0 < k < m, slot 0 (dRe[0],
// dRe[m])) of the frame rows row0 .., as the planned stage forms it, value
// for value, for Bluestein's stage: a thread's at most 8 pairs take their
// loads together, level by level (the residual and each bin's band range,
// then the cotangent and weights of its first two bands, then bin_dp's
// sum in its order), where a loop over the pairs waits on each load in
// turn.
__device__ __forceinline__ void bluestein_half_spectrum(
    float2* y, const float* __restrict__ reim, const float* __restrict__ fb_t,
    const int* __restrict__ bin_lo, const int* __restrict__ bin_hi,
    const float* __restrict__ dmel, int row0, int fr, int rows, int nfr,
    int kp, int m, int n_mels) {
  constexpr int SLOTS = FFT_BLOCK_POINTS / 2 / FFT_THREADS;
  const int n_bins = m + 1;
  float re[SLOTS], im[SLOTS], g0[SLOTS], w0[SLOTS], g1[SLOTS], w1[SLOTS];
  const float* g[SLOTS];
  int k_of[SLOTS], lo[SLOTS], hi[SLOTS];
  #pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int i = s * FFT_THREADS + threadIdx.x;
    const int f = i / m;
    const int k = i - f * m;
    const int r = row0 + f;
    k_of[s] = k;
    re[s] = im[s] = 0.f;
    g[s] = dmel;
    lo[s] = hi[s] = 0;
    if (f < fr && r < rows) {
      const int b = r / nfr;
      g[s] = dmel + (size_t)b * n_mels * nfr + (r - b * nfr);
      const float* src = reim + (size_t)r * 2 * kp;
      re[s] = __ldg(src + k);
      im[s] = __ldg(src + (k == 0 ? m : kp + k));
      lo[s] = __ldg(bin_lo + k);
      hi[s] = __ldg(bin_hi + k);
    }
  }
  #pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = k_of[s];
    const int j = lo[s];
    g0[s] = w0[s] = g1[s] = w1[s] = 0.f;
    if (j < hi[s]) {
      g0[s] = __ldg(g[s] + (size_t)j * nfr);
      w0[s] = __ldg(fb_t + (size_t)j * n_bins + k);
    }
    if (j + 1 < hi[s]) {
      g1[s] = __ldg(g[s] + (size_t)(j + 1) * nfr);
      w1[s] = __ldg(fb_t + (size_t)(j + 1) * n_bins + k);
    }
  }
  #pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int i = s * FFT_THREADS + threadIdx.x;
    if (i >= fr * m) break;
    const int k = k_of[s];
    // bin_dp's sum: the bin's bands from lo up
    float dp = 0.f;
    if (lo[s] < hi[s]) dp = fmaf(g0[s], w0[s], dp);
    if (lo[s] + 1 < hi[s]) dp = fmaf(g1[s], w1[s], dp);
    for (int j = lo[s] + 2; j < hi[s]; ++j)
      dp = fmaf(__ldg(g[s] + (size_t)j * nfr),
                __ldg(fb_t + (size_t)j * n_bins + k), dp);
    float2 v = make_float2(dp * re[s], dp * im[s]);
    if (k == 0) {
      const float dpm = bin_dp(g[s], fb_t, bin_lo, bin_hi, m, nfr, n_bins);
      v = make_float2(2.f * dp * re[s], 2.f * dpm * im[s]);
    }
    y[i] = v;
  }
}

// The FFT stage: fr frames a group, groups blockIdx.x + i gridDim.x in
// order; a partial dw of n_fft floats a block.  The inverse FFT is the
// plan's, or Bluestein's where BLUESTEIN.
template <bool BLUESTEIN>
__global__ void __launch_bounds__(FFT_THREADS,
                                  BLUESTEIN ? BLUESTEIN_BWD_BLOCKS : 4)
adjoint_fft_dw_kernel(const float* __restrict__ x,
                      const float* __restrict__ reim,
                      const float* __restrict__ table,
                      const float* __restrict__ fb_t,
                      const int* __restrict__ bin_lo,
                      const int* __restrict__ bin_hi,
                      const float* __restrict__ dmel,
                      float* __restrict__ partials, int rows, int sig_len,
                      int nfr, int hop, int n_fft, int kp, int n_mels, int fr,
                      FftStage stage) {
  // the plan's 2 x fr x n_fft / 2 points; Bluestein's fr x (m_pad + m_pad
  // / 16), Y at its start
  extern __shared__ __align__(16) float2 fft_buf[];
  const int m = n_fft / 2;
  const int n_bins = m + 1;
  // trial blockIdx.y of a pack: its signal rows, residual, cotangent and
  // partials (rows is one trial's)
  const size_t trial = blockIdx.y;
  x += trial * (size_t)(rows / nfr) * sig_len;
  reim += trial * (size_t)rows * 2 * kp;
  dmel += trial * (size_t)rows * n_mels;
  partials += trial * (size_t)n_fft * gridDim.x;
  float2* a = fft_buf;
  float2* y = BLUESTEIN ? fft_buf : fft_buf + fr * m;
  const int n_groups = (rows + fr - 1) / fr;
  // This thread's samples: flat index s FFT_THREADS + threadIdx.x of the
  // group's fr x n_fft samples, walked as (frame f, sample mm) pairs.  As
  // n_fft is even, the sample's parity is threadIdx.x's: odd samples are
  // the imaginary parts of the conjugated output, so they change sign.
  const int f0 = threadIdx.x / n_fft;
  const int mm0 = threadIdx.x - f0 * n_fft;
  const int df = FFT_THREADS / n_fft;
  const int dm = FFT_THREADS - df * n_fft;
  const float sign = (threadIdx.x & 1) ? -1.f : 1.f;
  // dw sums: a thread's DW_SLOTS in registers; on Bluestein's stage, whose
  // registers hold the FFT's points, in shared memory past its buffer
  float acc[DW_SLOTS];
  float* acc_s = nullptr;
  if constexpr (BLUESTEIN) {
    acc_s = reinterpret_cast<float*>(
                fft_buf + fr * (stage.m_pad + stage.m_pad / 16)) +
            threadIdx.x;
    #pragma unroll
    for (int s = 0; s < DW_SLOTS; ++s) acc_s[s * FFT_THREADS] = 0.f;
  } else {
    #pragma unroll
    for (int s = 0; s < DW_SLOTS; ++s) acc[s] = 0.f;
  }

  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int row0 = grp * fr;
    __syncthreads();               // the last group's reads are done
    // Y = dP (Re + i Im) at 0 < k < m; slot 0 holds (dRe[0], dRe[m])
    if constexpr (BLUESTEIN) {
      bluestein_half_spectrum(y, reim, fb_t, bin_lo, bin_hi, dmel, row0, fr,
                              rows, nfr, kp, m, n_mels);
    } else {
      int f_src = -1;
      const float* g = dmel;
      const float* src = reim;
      for_frame_columns(fr, m, [&](int f, int k) {
        const int r = row0 + f;
        float2 v = make_float2(0.f, 0.f);
        if (r < rows) {
          if (f != f_src) {
            const int b = r / nfr;
            g = dmel + (size_t)b * n_mels * nfr + (r - b * nfr);
            src = reim + (size_t)r * 2 * kp;
            f_src = f;
          }
          const float dp = bin_dp(g, fb_t, bin_lo, bin_hi, k, nfr, n_bins);
          if (k == 0) {
            const float dpm = bin_dp(g, fb_t, bin_lo, bin_hi, m, nfr,
                                     n_bins);
            v = make_float2(2.f * dp * __ldg(src),
                            2.f * dpm * __ldg(src + m));
          } else {
            v = make_float2(dp * __ldg(src + k), dp * __ldg(src + kp + k));
          }
        }
        y[f * m + k] = v;
      });
    }
    __syncthreads();
    const float* z;
    if constexpr (BLUESTEIN) {
      // the pre-pass, times the chirp in the first pass
      z = reinterpret_cast<const float*>(bluestein_frames(
          fft_buf, n_fft, stage, [&](int f, int k) {
            return irfft_prepass(y + f * m, n_fft, k, table);
          }));
    } else {
      for_frame_columns(fr, m, [&](int f, int k) {
        a[f * m + k] = irfft_prepass(y + f * m, n_fft, k, table);
      });
      z = reinterpret_cast<const float*>(
          fft_frames(a, y, fr, n_fft, stage.plan, table));
    }
    // dw sums: frame sample times dfw, dfw the conjugated output read as
    // floats at the flat index
    int f = f0;
    int mm = mm0;
    int f_row = -1;
    const float* xb = x;
    int base = 0;
    bool row_ok = false;
    #pragma unroll
    for (int s = 0; s < DW_SLOTS; ++s) {
      if (s > 0) {
        f += df;
        mm += dm;
        if (mm >= n_fft) {
          mm -= n_fft;
          ++f;
        }
      }
      if (f < fr) {
        if (f != f_row) {
          const int r = row0 + f;
          row_ok = r < rows;
          if (row_ok) {
            const int b = r / nfr;
            xb = x + (size_t)b * sig_len;
            base = (r - b * nfr) * hop - m;
          }
          f_row = f;
        }
        const int p = base + mm;
        if (row_ok && p >= 0 && p < sig_len) {
          if constexpr (BLUESTEIN) {
            float& a = acc_s[s * FFT_THREADS];
            a = fmaf(__ldg(xb + p), sign * z[s * FFT_THREADS + threadIdx.x],
                     a);
          } else {
            acc[s] = fmaf(__ldg(xb + p),
                          sign * z[s * FFT_THREADS + threadIdx.x], acc[s]);
          }
        }
      }
    }
  }

  // the block's partial: each sample's sums over the group's frames
  __syncthreads();
  float* red = reinterpret_cast<float*>(fft_buf);      // fr x n_fft
  if constexpr (BLUESTEIN) {
    red = acc_s - threadIdx.x;
  } else {
    #pragma unroll
    for (int s = 0; s < DW_SLOTS; ++s) {
      const int i = s * FFT_THREADS + threadIdx.x;
      if (i < fr * n_fft) red[i] = acc[s];
    }
    __syncthreads();
  }
  for (int mm = threadIdx.x; mm < n_fft; mm += FFT_THREADS) {
    float v = 0.f;
    for (int f = 0; f < fr; ++f) v += red[f * n_fft + mm];
    partials[(size_t)mm * gridDim.x + blockIdx.x] = v;
  }
}

// Columns of the partials buffer: blocks of adjoint_fft_dw_kernel (an FFT
// stage) or row blocks of adjoint_dw_kernel (stage == nullptr: the direct
// stage).
int partial_blocks(int rows, int n_fft, const FftStage* stage) {
  if (stage == nullptr) return (rows + BM - 1) / BM;
  const int fr = fft_stage_frames(n_fft, *stage);
  const int groups = (rows + fr - 1) / fr;
  const int cap = stage->m_pad ? DW_BLOCKS_BLUESTEIN : DW_BLOCKS;
  return groups < cap ? groups : cap;
}

// The stage's launches on the given stream, then dw_sum_kernel; returns
// cudaGetLastError().  stage == nullptr takes the direct stage.
int launch_bwd(const float* x, const float* reim, const float* table,
               const float* fb, const float* fb_t, const int* bin_lo,
               const int* bin_hi, const float* dmel, float* dreim,
               float* partials, float* dw, int batch, int trials,
               int sig_len, int nfr, int hop, int n_fft, int kp, int n_bins,
               int n_mels, const FftStage* stage, void* stream) {
  const int rows = batch * nfr;
  if (batch <= 0 || trials <= 0 || trials > 65535 || nfr <= 0 ||
      rows / nfr != batch || hop <= 0 ||
      n_bins != n_fft / 2 + 1 || kp < n_bins || kp % BK != 0 ||
      n_mels <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = partial_blocks(rows, n_fft, stage);
  cudaError_t err;
  if (stage != nullptr) {
    // Bluestein's: and the dw sums, DW_SLOTS floats a thread
    const size_t smem = fft_stage_smem(n_fft, *stage) +
                        (stage->m_pad ? sizeof(float) * FFT_BLOCK_POINTS : 0);
    auto kernel = stage->m_pad ? adjoint_fft_dw_kernel<true>
                               : adjoint_fft_dw_kernel<false>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(n_blocks, trials), FFT_THREADS, smem, s>>>(
        x, reim, table, fb_t, bin_lo, bin_hi, dmel, partials, rows, sig_len,
        nfr, hop, n_fft, kp, n_mels, fft_stage_frames(n_fft, *stage), *stage);
  } else {
    const size_t smem = sizeof(float) * (size_t)FR * n_mels;
    err = cudaFuncSetAttribute(dreim_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    // per frame row: every trial's rows in one grid
    const int all_rows = trials * rows;
    dreim_kernel<<<(all_rows + FR - 1) / FR, DP_THREADS, smem, s>>>(
        reim, fb, bin_lo, bin_hi, dmel, dreim, all_rows, nfr, kp, n_bins,
        n_mels);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(n_blocks, (n_fft + BN - 1) / BN, trials);
    adjoint_dw_kernel<<<grid, GEMM_THREADS, 0, s>>>(
        dreim, table, x, partials, rows, sig_len, nfr, hop, n_fft, kp, n_bins);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // one block a (trial, window sample): partials and dw are (trials,
  // n_fft, ...) in that order
  dw_sum_kernel<<<trials * n_fft, SUM_THREADS, 0, s>>>(partials, dw,
                                                      n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The stage from the host's arguments (fft_stage_from), or the direct
// stage (n_stages < 0 with m_pad = 0); false where they are not a stage of
// n_fft.
bool stage_of(const int* radices, int n_stages, int n_fft, int m_pad,
              const float* bl_table, const float* bl_hat, FftStage* stage,
              const FftStage** chosen) {
  if (n_stages < 0 && m_pad == 0) {
    *chosen = nullptr;
    return true;
  }
  *chosen = stage;
  return fft_stage_from(radices, n_stages, n_fft, m_pad, bl_table, bl_hat,
                        stage);
}

}  // namespace

extern "C" {

const char* framed_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Columns of the partials scratch the caller allocates, (trials, n_fft,
// columns), for rows = batch * nfr frame rows of one trial on the stage
// (n_stages, m_pad) of the entries below: the direct stage where n_stages
// < 0 and m_pad = 0.
int framed_bwd_partial_blocks(int rows, int n_fft, int n_stages, int m_pad) {
  if (n_stages < 0 && m_pad == 0) return partial_blocks(rows, n_fft, nullptr);
  FftStage stage{};
  stage.m_pad = m_pad;
  return partial_blocks(rows, n_fft, &stage);
}

// A pack of `trials` trials, each of `batch` signal rows (rows = batch *
// nfr frame rows a trial): x (trials*batch, sig_len); reim (trials*rows,
// 2*kp) as framed_fwd / fused_fwd wrote it; table (2, n_fft) as there; fb
// (n_bins, n_mels) dense and fb_t, its transpose (n_mels, n_bins); bin_lo /
// bin_hi (n_bins) int32, each bin's nonzero mel range; dmel (trials*batch,
// n_mels, nfr); dreim scratch (trials*rows, 2*kp), read only by the direct
// stage (null on an FFT stage); partials scratch (trials, n_fft,
// framed_bwd_partial_blocks(rows, n_fft, n_stages, m_pad)); dw (trials,
// n_fft), one gradient a trial.  Each trial's partials are its own
// blocks', summed in the order of a launch with trials = 1 on its rows, so
// trial k's dw is bit for bit that launch's.  All fp32 unless stated,
// contiguous, on the current device.
// The stage (radices, n_stages, m_pad, bl_table, bl_hat) is as
// framed_fwd.cu's entries take it: the plan of the complex FFT of length
// n_fft / 2, Bluestein's (fused_bwd only), or the direct stage (radices
// null, n_stages = -1, m_pad = 0); anything else is refused.

// K4: n_fft a multiple of 128, at most 1024 (the framed route's geometry);
// no Bluestein stage.
int framed_bwd(const float* x, const float* reim, const float* table,
               const float* fb, const float* fb_t, const int* bin_lo,
               const int* bin_hi, const float* dmel, float* dreim,
               float* partials, float* dw, int batch, int trials,
               int sig_len, int nfr, int hop, int n_fft, int kp, int n_bins,
               int n_mels, const int* radices, int n_stages, int m_pad,
               const float* bl_table, const float* bl_hat, void* stream) {
  FftStage stage;
  const FftStage* chosen;
  if (n_fft < 128 || n_fft % 128 != 0 || n_fft > 1024 || m_pad != 0 ||
      !stage_of(radices, n_stages, n_fft, m_pad, bl_table, bl_hat, &stage,
                &chosen))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd(x, reim, table, fb, fb_t, bin_lo, bin_hi, dmel, dreim,
                    partials, dw, batch, trials, sig_len, nfr, hop, n_fft, kp,
                    n_bins, n_mels, chosen, stream);
}

// K6: any even n_fft from 2 to 4096 (the fused route's geometry), the
// window centred in it by the caller: the plan's inverse FFT where n_fft
// / 2 has no prime factor above 5, else Bluestein's (faithful mode's n_fft
// = 2 T at most T).
int fused_bwd(const float* x, const float* reim, const float* table,
              const float* fb, const float* fb_t, const int* bin_lo,
              const int* bin_hi, const float* dmel, float* dreim,
              float* partials, float* dw, int batch, int trials, int sig_len,
              int nfr, int hop, int n_fft, int kp, int n_bins, int n_mels,
              const int* radices, int n_stages, int m_pad,
              const float* bl_table, const float* bl_hat, void* stream) {
  FftStage stage;
  const FftStage* chosen;
  if (n_fft < 2 || n_fft % 2 != 0 || n_fft > 4096 ||
      !stage_of(radices, n_stages, n_fft, m_pad, bl_table, bl_hat, &stage,
                &chosen))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd(x, reim, table, fb, fb_t, bin_lo, bin_hi, dmel, dreim,
                    partials, dw, batch, trials, sig_len, nfr, hop, n_fft, kp,
                    n_bins, n_mels, chosen, stream);
}

}  // extern "C"
