// Framed mel power, backward into the window, for Hopper (sm_90a).
//
// Replaces the TPU kernel dmel_tpu/ops/pallas/framed_dmel.py:_bwd_kernel
// (K4), launched by _bwd.  Given the Re|Im residual that the forward kernel
// (framed_fwd.cu) left in global memory, the signal, the filterbank and the
// cotangent g of the (B, n_mels, n_frames) mel power, it computes for every
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
// What bounds it on this card: operations.  The adjoint DFT is a GEMM of
// (rows, 2 kp) by (2 kp, n_fft), 4 rows kp n_fft flops, ~38 GFLOP at
// n_fft 1024 and batch 32, run in fp32 FMAs; the function itself needs an
// inverse real FFT a frame (chip_smoke.py:framed_bound).  The design keeps
// dfw on chip, as the TPU kernel did:
//
// 1. dreim_kernel: one block owns FR frame rows, stages their cotangent in
//    shared memory, forms dP over each bin's contiguous range of nonzero
//    mel bands (at most two for a triangular filterbank) and writes
//    dRe|dIm (rows, 2 kp) in the residual's layout, zero past n_bins.
// 2. adjoint_dw_kernel: K1's register-blocked SIMT GEMM (128x128 tiles,
//    8x8 outputs a thread, 16-deep steps through shared memory) of dRe|dIm
//    against the bases, generated from an N-entry cos / -sin table at the
//    exact integer phase (m k) mod N.  Its epilogue multiplies each dfw
//    element by its frame sample, sums the block's 128 rows per column in
//    a fixed order and writes one partial sum per (column, row block) to a
//    (n_fft, blocks) buffer: dfw never reaches device memory.
// 3. dw_sum_kernel: one block per window sample sums its partials in a
//    fixed order and a shared-memory tree.  No float atomics anywhere, so
//    two runs give bit-identical dw (the TPU package likewise summed its
//    per-block parts outside the kernel).
//
// What the TPU design needed and this one drops: the group-row layout and
// the phase-major row order (Mosaic's aligned loads), the bf16 residuals
// and the single-pass bf16 adjoint GEMMs (fp32 throughout), the Nyquist
// split (128-lane tiling).  The tensor cores are later work.
//
// C interface: framed_bwd() launches the three kernels on the given stream
// and returns cudaGetLastError(); it does not synchronise.

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

}  // namespace

extern "C" {

const char* framed_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Frame rows per block of adjoint_dw_kernel: the caller sizes partials as
// (n_fft, ceil(rows / framed_bwd_rows_per_block())).
int framed_bwd_rows_per_block() { return BM; }

// x (batch, sig_len); reim (rows, 2*kp) as framed_fwd wrote it; table (2,
// n_fft) as there; fb (n_bins, n_mels) dense; bin_lo / bin_hi (n_bins)
// int32, each bin's nonzero mel range; dmel (batch, n_mels, nfr); dreim
// scratch (rows, 2*kp); partials scratch (n_fft, n_blocks); dw (n_fft).
// All fp32 unless stated, contiguous, on the current device.  n_fft a
// multiple of 128, at most 1024 (the framed route's geometry).
int framed_bwd(const float* x, const float* reim, const float* table,
               const float* fb, const int* bin_lo, const int* bin_hi,
               const float* dmel, float* dreim, float* partials, float* dw,
               int batch, int sig_len, int nfr, int hop, int n_fft, int kp,
               int n_bins, int n_mels, void* stream) {
  const int rows = batch * nfr;
  if (batch <= 0 || nfr <= 0 || rows / nfr != batch || hop <= 0 ||
      n_fft < 128 || n_fft % 128 != 0 || n_fft > 1024 ||
      n_bins != n_fft / 2 + 1 || kp < n_bins || kp % BK != 0 ||
      n_mels <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const size_t smem = sizeof(float) * (size_t)FR * n_mels;
  cudaError_t err = cudaFuncSetAttribute(
      dreim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dreim_kernel<<<(rows + FR - 1) / FR, DP_THREADS, smem, s>>>(
      reim, fb, bin_lo, bin_hi, dmel, dreim, rows, nfr, kp, n_bins, n_mels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_blocks = (rows + BM - 1) / BM;
  dim3 grid(n_blocks, (n_fft + BN - 1) / BN);
  adjoint_dw_kernel<<<grid, GEMM_THREADS, 0, s>>>(
      dreim, table, x, partials, rows, sig_len, nfr, hop, n_fft, kp, n_bins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  dw_sum_kernel<<<n_fft, SUM_THREADS, 0, s>>>(partials, dw, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
