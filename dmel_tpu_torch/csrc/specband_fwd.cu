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
// band stage and K2 (specband_bwd.cu) read it.  In two launches:
//
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
// 2. group_mel_kernel<NT>, the band stage, over band groups planned on the
//    host once per geometry (dmel_tpu_torch/ops/specband.py:band_plan):
//    runs of consecutive mel bands that share one sigma, cut so that a
//    group's bins (the union of its bands' nonzero filterbank ranges) span
//    at most one CHUNK = 128 bins, or two where the bands are wider than
//    half a chunk (n_fft 2048 and 4096 at 8 kHz); a band wider than that
//    is a group of its own (~400 bins at 4096, 44.1 kHz and 32 mels).  A
//    block owns ROWS = 32 frame rows x one group (x one trial of a pack),
//    and walks the group's bins in chunks of CHUNK:
//    - it stages the rows' X' columns of the chunk and their 2J halo, both
//      planes, in shared memory with asynchronous 16-byte copies, all of a
//      thread's in flight at once (each waiting on its own load, one after
//      another, left the stage bound by load latency); rows are 16-byte
//      aligned, and the shared memory a block takes depends on the tap
//      count, not on n_fft (54 KB at NT = 49 and 64 mels, four blocks an
//      SM);
//    - lane l of a warp is row l and a thread owns VB = 8 consecutive
//      bins of its row; it slides the NT taps over a ring of VB columns a
//      plane, reading four columns and four taps with each shared load
//      (the row pitch is 4 mod 32 floats, so 8 rows' 16-byte loads hit 32
//      banks), 16 FMAs a tap; NT is a template argument (25, 33, 49, and
//      127 for any other 2J + 1 up to 127, its taps zero-padded on both
//      sides), so the slide unrolls into registers.  The first design
//      read two shared operands and a tap for every FMA pair;
//    - it squares the sums into a power tile, written over the X' tile
//      once every warp has read it, and sums each (band, row) over that
//      band's own nonzero bins only (the first design ran every band over
//      its whole sigma's range: ~32x the FMAs at k_sig = 1); a warp is one
//      band's 32 rows, its lanes read 32 of the band's filterbank entries
//      at once and pass them round with shuffles;
//    - each band's sum is carried in shared memory from chunk to chunk.
//    A block issues its first chunk's copies before it reads its taps, and
//    the blocks take the row tiles last first: the spectra stage wrote
//    those last, so more of their X' is still in L2.
//    Every band is in exactly one group, so each output is written once.
//    The sums run in the first design's order (taps i = 0 .. 2J, then
//    bins ascending; the products it also took with the exact zeros of
//    the filterbank change no sum), so the results are its results, bit
//    for bit.  Neighbouring groups may overlap by part of a triangle:
//    those bins are convolved twice, which changes no result.
//
//    What bounds the stage (chip_smoke.py:k1_band_bound): the xext read,
//    2 k_ext floats a frame, and (6J + 5) flops a bin; at n_fft 1024 and
//    J = 24 these take about as long (72 MB, 1.3 GFLOP at B = 32).  This
//    stage takes 2 (2J + 1) FMAs a bin (the symmetric taps are not paired:
//    that saves flops, not instructions), over each chunk's bins rounded
//    up to 8, and reads each chunk's halo again (from L2 mostly: a row
//    tile's groups are neighbouring blocks).  A two-stage ring of chunks
//    with persistent blocks, tried, ran slower on the H100: its shared
//    memory leaves two blocks an SM where this design runs four.

// What the TPU design needed and this one drops: the sliding-DFT
// recurrence and hop-delta GEMMs (the FFT needs fewer operations still),
// the bf16 hi/lo operand splits (fp32 needs none), the phase-major row
// layout and Nyquist split (128-lane tiling), and spectra carried between
// sequential grid steps (blocks here run in any order and own their
// output).
//
// C interface: specband_fwd() launches the two kernels on the given stream
// and returns cudaGetLastError(); it does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // GEMM rows (frames) per block
constexpr int BN = 128;          // GEMM columns (extended bins) per block
constexpr int BK = 16;           // contraction step
constexpr int GEMM_THREADS = 256;
constexpr int A_PAD = 4;         // keeps the transposed A stores conflict-free

constexpr int ROWS = 32;         // frame rows a band-stage block, one a lane
constexpr int VB = 8;            // consecutive bins a thread
constexpr int CHUNK = 128;       // bins a block convolves at a time
constexpr int BAND_THREADS = 256;
constexpr int BAND_WARPS = BAND_THREADS / 32;
constexpr int MAX_TAPS = 127;    // taps a sigma: 2J + 1 with 2J < 128
constexpr int MAX_SIGMA = 8;     // the JAX package's k_sig * 128 <= 1024
constexpr int GROUP_INTS = 5;    // a group: sigma, lo, hi, first band, end
constexpr int POW_PITCH = CHUNK | 1;   // odd: 32 rows hit 32 banks

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

// Row pitch of a staged X' plane: a chunk of bins and its halo, in whole
// float4s, rounded up to 4 mod 32 floats: the 8 lanes (8 rows) of one
// shared wavefront of 16-byte loads of one column quad hit 32 banks.
template <int NT>
__host__ __device__ constexpr int x_pitch() {
  return ((CHUNK + NT - 1 + 3) / 4 * 4 - 4 + 31) / 32 * 32 + 4;
}

// The taps padded to whole float4s, read four at a time.
template <int NT>
__host__ __device__ constexpr int taps4() { return (NT + 3) / 4; }

template <int NT>
size_t band_smem_bytes(int max_bands) {
  return sizeof(float) * (4 * (size_t)taps4<NT>()            // taps
                          + 2 * (size_t)ROWS * x_pitch<NT>()  // X' planes
                          + (size_t)max_bands * ROWS);        // band sums
}

// Blocks an SM that each instance's register budget is set for.
template <int NT>
__host__ __device__ constexpr int band_min_blocks() {
  return NT <= 49 ? 4 : 2;
}

// A 16-byte copy from device to shared memory that does not wait for the
// load (zeros where !valid): a thread's copies are all in flight at once.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ float lane_of(const float4& q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

// S over one thread's VB bins and their power.  xr/xi point at the staged
// column of the first bin's first tap, 16-byte aligned (bin u needs
// columns u .. u + NT - 1 at taps NT - 1 .. 0); the ring ar/ai holds, at
// tap i, column v + NT - 1 - i of bin v in slot (v - i) mod VB, so each
// tap takes one new column a plane, read four columns (and four taps) at
// a time.  The taps run i = 0 .. NT - 1 as in S = sum_i rho[i] X'[k + 2J -
// i].
template <int NT>
__device__ __forceinline__ void conv_power(const float* xr, const float* xi,
                                           const float4* taps,
                                           float (&pw)[VB]) {
  const float4* r4 = reinterpret_cast<const float4*>(xr);
  const float4* i4 = reinterpret_cast<const float4*>(xi);
  float ar[VB], ai[VB], sr[VB], si[VB];
  #pragma unroll
  for (int v = 0; v < VB; ++v) {
    sr[v] = 0.f;
    si[v] = 0.f;
  }
  #pragma unroll
  for (int v = 1; v < VB; ++v) {
    const int c = v + NT - 1;
    ar[v] = lane_of(r4[c / 4], c % 4);
    ai[v] = lane_of(i4[c / 4], c % 4);
  }
  float4 qr, qi, t4;
  #pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int c = NT - 1 - i;
    if (i == 0 || c % 4 == 3) {
      qr = r4[c / 4];
      qi = i4[c / 4];
    }
    if (i % 4 == 0) t4 = taps[i / 4];
    const float r = lane_of(t4, i % 4);
    ar[(VB - i % VB) % VB] = lane_of(qr, c % 4);
    ai[(VB - i % VB) % VB] = lane_of(qi, c % 4);
    #pragma unroll
    for (int v = 0; v < VB; ++v) {
      const int sl = (v + VB - i % VB) % VB;
      sr[v] = fmaf(r, ar[sl], sr[v]);
      si[v] = fmaf(r, ai[sl], si[v]);
    }
  }
  #pragma unroll
  for (int v = 0; v < VB; ++v) pw[v] = sr[v] * sr[v] + si[v] * si[v];
}

// Runs of VB bins a warp convolves in a chunk.
constexpr int RUNS = CHUNK / VB / BAND_WARPS;

// The band stage: block (tile, group) of grid dimension x, group fastest,
// and the trial of a pack in y.  groups (n_groups, GROUP_INTS) and bands
// (n_mels, 2), each band's nonzero bin range [lo, hi) of the filterbank,
// are the host's plan (specband.py:band_plan); fb the dense filterbank it
// was built from.
template <int NT>
__global__ void __launch_bounds__(BAND_THREADS, band_min_blocks<NT>())
group_mel_kernel(const float* __restrict__ xext, const float* __restrict__ rho,
                 const float* __restrict__ fb, const int* __restrict__ groups,
                 const int* __restrict__ bands, float* __restrict__ out,
                 int rows, int nfr, int kp, int n_taps, int n_mels, int k_sig,
                 int n_groups, int log_out) {
  constexpr int P = x_pitch<NT>();
  extern __shared__ __align__(16) float smem[];
  float* taps = smem;                      // NT, zero-padded to float4s
  float* xr = taps + 4 * taps4<NT>();      // ROWS x P, cos plane
  float* xi = xr + ROWS * P;               // ROWS x P, sin plane
  float* pw = xr;                          // ROWS x POW_PITCH, the power,
                                           // over X' once it is read
  float* acc = xi + ROWS * P;              // max_bands x ROWS, band sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = blockIdx.x % n_groups;
  // the last row tiles first: the spectra stage wrote them last, so more
  // of their X' is still in L2
  const int tile = (rows + ROWS - 1) / ROWS - 1 - blockIdx.x / n_groups;
  const int row0 = tile * ROWS;
  const int pad = (NT - n_taps) / 2;
  const int ncol = 2 * kp;
  // trial blockIdx.y of a pack: its spectra rows, taps and output rows
  // (rows is one trial's)
  const size_t trial = blockIdx.y;
  xext += trial * (size_t)rows * ncol;
  out += trial * (size_t)rows * n_mels;
  const int* gp = groups + grp * GROUP_INTS;
  const int sigma = __ldg(gp);
  const int lo = __ldg(gp + 1);
  const int hi = __ldg(gp + 2);
  const int m0 = __ldg(gp + 3);
  const int nb = __ldg(gp + 4) - m0;
  rho += (trial * k_sig + sigma) * (size_t)n_taps;

  // the chunks start at `base`, up to 3 bins before the group's, so that
  // their first taps' columns c_lo - pad are multiples of 4 (16-byte
  // loads); the power of a bin before the group's is never read
  const int base = lo - ((lo - pad) & 3);
  // issues the copies of the chunk from c_lo: its runs of VB bins and
  // their halo, both planes, every row of the tile; zeros past the last
  // row and outside [0, kp) (columns k_ext .. kp - 1 of xext are exact
  // zeros; kp is a multiple of 4, so a copy lies wholly inside or outside)
  auto stage = [&](int c_lo) {
    const int runs = (min(CHUNK, hi - c_lo) + VB - 1) / VB;
    const int sw4 = (runs * VB + NT - 1 + 3) / 4;
    for (int i = tid; i < ROWS * sw4; i += BAND_THREADS) {
      const int f = i / sw4;
      const int c = 4 * (i - f * sw4);
      const int r = row0 + f;
      const int col = c_lo - pad + c;
      const bool ok = r < rows && col >= 0 && col < kp;
      const float* src = ok ? xext + (size_t)r * ncol + col : xext;
      cp_async16(xr + f * P + c, src, ok);
      cp_async16(xi + f * P + c, ok ? src + kp : xext, ok);
    }
  };
  if (base < hi) stage(base);
  for (int i = tid; i < 4 * taps4<NT>(); i += BAND_THREADS) {
    const int d = i - pad;
    taps[i] = (d >= 0 && d < n_taps) ? __ldg(rho + d) : 0.f;
  }
  for (int i = tid; i < nb * ROWS; i += BAND_THREADS) acc[i] = 0.f;

  for (int c_lo = base; c_lo < hi; c_lo += CHUNK) {
    const int width = min(CHUNK, hi - c_lo);
    const int runs = (width + VB - 1) / VB;
    if (c_lo != base) {
      __syncthreads();     // the last chunk's power is read
      stage(c_lo);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();       // the chunk and the taps are in shared memory

    // lane = row, the warps take the chunk's runs of VB bins in turn
    float pr[RUNS][VB];
    #pragma unroll
    for (int j = 0; j < RUNS; ++j) {
      const int g = warp + j * BAND_WARPS;
      if (g < runs)
        conv_power<NT>(xr + lane * P + g * VB, xi + lane * P + g * VB,
                       reinterpret_cast<const float4*>(taps), pr[j]);
    }
    __syncthreads();       // every warp's X' reads are done
    #pragma unroll
    for (int j = 0; j < RUNS; ++j) {
      const int g = warp + j * BAND_WARPS;
      if (g < runs) {
        #pragma unroll
        for (int v = 0; v < VB; ++v)
          pw[lane * POW_PITCH + g * VB + v] = pr[j][v];
      }
    }
    __syncthreads();

    // (band, row) pairs, row fastest: a warp is one band's 32 rows; its
    // lanes read 32 of the band's filterbank entries at once and pass
    // them round, so the sum waits on no device load
    const int c_hi = c_lo + width;
    const float* pf = pw + lane * POW_PITCH - c_lo;
    for (int i = tid; i < nb * ROWS; i += BAND_THREADS) {
      const int m = m0 + i / ROWS;
      const int k0 = max(__ldg(bands + 2 * m), c_lo);
      const int k1 = min(__ldg(bands + 2 * m + 1), c_hi);
      float a = acc[i];
      for (int kb = k0; kb < k1; kb += 32) {
        const int n = min(32, k1 - kb);
        const float w =
            lane < n ? __ldg(fb + (size_t)(kb + lane) * n_mels + m) : 0.f;
        for (int j = 0; j < n; ++j)
          a = fmaf(pf[kb + j], __shfl_sync(0xffffffffu, w, j), a);
      }
      acc[i] = a;
    }
  }

  // each thread writes the sums it made: no barrier needed; neighbouring
  // threads write neighbouring frames of one mel band
  for (int i = tid; i < nb * ROWS; i += BAND_THREADS) {
    const int r = row0 + lane;
    if (r >= rows) continue;
    float a = acc[i];
    if (log_out) a = logf(a + 1e-10f);
    const int b = r / nfr;
    const int t = r - b * nfr;
    out[((size_t)b * n_mels + m0 + i / ROWS) * nfr + t] = a;
  }
}

template <int NT>
cudaError_t launch_bands(const float* xext, const float* rho, const float* fb,
                         const int* groups, const int* bands, float* out,
                         int rows, int trials, int nfr, int kp, int n_taps,
                         int n_mels, int k_sig, int n_groups, int max_bands,
                         int log_out, cudaStream_t s) {
  const size_t smem = band_smem_bytes<NT>(max_bands);
  cudaError_t err = cudaFuncSetAttribute(
      group_mel_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (rows + ROWS - 1) / ROWS;
  group_mel_kernel<NT><<<dim3(tiles * n_groups, trials), BAND_THREADS, smem,
                         s>>>(xext, rho, fb, groups, bands, out, rows, nfr,
                              kp, n_taps, n_mels, k_sig, n_groups, log_out);
  return cudaGetLastError();
}

// The tap count of the band-stage instance that serves n_taps taps (its
// taps zero-padded on both sides), 0 where none does.
int band_tap_instance(int n_taps) {
  if (n_taps <= 0 || n_taps > MAX_TAPS || n_taps % 2 == 0) return 0;
  return n_taps <= 25 ? 25 : n_taps <= 33 ? 33 : n_taps <= 49 ? 49 : 127;
}

}  // namespace

extern "C" {

const char* specband_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A pack of `trials` trials, each of `batch` signal rows: x (trials*batch,
// sig_len); rho (trials, k_sig, n_taps), one tap vector a (trial, sigma);
// fb (n_bins, n_mels); groups (n_groups, 5) and bands (n_mels, 2) int32,
// the band plan built from fb (specband.py:band_plan: each group's sigma
// in [0, k_sig), its bin range [lo, hi) and its bands [m0, m1), which
// cover every band once; each band's nonzero bins [lo, hi)), max_bands
// the most bands a group holds; xext scratch (trials*batch*nfr, 2*kp);
// out (trials*batch, n_mels, nfr), or null to launch the spectra stage
// alone.  The spectra do not depend on the taps: one pass serves every
// trial's rows.  The band stage takes the trial as a grid dimension, so
// trial k's outputs are bit for bit those of a launch with trials = 1 on
// its rows and taps.  The filterbank, the plan and the spectra stage's
// constants are shared.  The spectra stage: radices (n_stages ints, host
// memory), the FFT's plan, with table (2, n_fft), cos then -sin of 2 pi i
// / n_fft, bins (kp) int32 and signs (2, kp), the extended-bin map; or
// radices null and n_stages = -1 for the direct DFT with basis (n_fft,
// 2*kp).  Operands the stage does not read may be null.  All fp32 unless
// stated, contiguous, on the current device.
int specband_fwd(const float* x, const float* basis, const float* table,
                 const int* bins, const float* signs, const float* rho,
                 const float* fb, const int* groups, const int* bands,
                 float* xext, float* out, int batch, int trials, int sig_len,
                 int nfr, int hop, int n_fft, int kp, int k_ext, int n_bins,
                 int n_taps, int n_mels, int k_sig, int log_out, int n_groups,
                 int max_bands, const int* radices, int n_stages,
                 void* stream) {
  const int rows = batch * nfr;
  const int nt = band_tap_instance(n_taps);
  if (batch <= 0 || trials <= 0 || trials > 65535 || nfr <= 0 ||
      rows / nfr != batch || (trials * rows) / trials != rows ||
      (2 * kp) % BN != 0 || k_ext > kp || nt == 0 ||
      n_bins != n_fft / 2 + 1 || n_bins + n_taps - 1 != k_ext ||
      n_mels <= 0 || k_sig < 1 || k_sig > MAX_SIGMA ||
      (out != nullptr && (groups == nullptr || bands == nullptr ||
                          n_groups < 1 || n_groups > n_mels ||
                          max_bands < 1 || max_bands > n_mels))) {
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

  // the spectra of every trial's rows in one grid
  const int all_rows = trials * rows;
  cudaError_t err;
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
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);

  auto launch = nt == 25 ? launch_bands<25>
                : nt == 33 ? launch_bands<33>
                : nt == 49 ? launch_bands<49> : launch_bands<127>;
  return static_cast<int>(launch(xext, rho, fb, groups, bands, out, rows,
                                 trials, nfr, kp, n_taps, n_mels, k_sig,
                                 n_groups, max_bands, log_out, s));
}

}  // extern "C"
