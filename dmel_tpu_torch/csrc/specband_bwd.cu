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
// What bounds it on this card (chip_smoke.py:k2_bound): at n_fft 4096,
// J = 12 and batch 32 (16 032 frame rows) the function needs ~5.9 GFLOP
// (per bin and row: the tap products 4 (2J+1), S with symmetric taps
// 6J + 2, dS 3; dP 2 a filterbank nonzero), 0.089 ms at the 67 TFLOP/s
// fp32 rate, against 266 MB of X' read once (2 k_ext floats a row),
// 0.080 ms at 3.35 TB/s: operations bound it, bytes nearly.  At n_fft
// 1024 (J = 24) it is 2.9 GFLOP against 72 MB: operations.  This kernel
// computes S with every tap (it takes any rho), ~8 (2J+1) flops a bin.
//
// The design, in three launches after a memset:
//
// 0. bin_range_kernel: each bin's range of mel bands and each sigma's
//    range of bins, from the filterbank and band_map, a warp a bin.
// 1. tap_grad_kernel<NT>: a fixed grid of GRAD_BLOCKS blocks of 128
//    threads (a constant, not read from the device, so drho does not
//    depend on the card).  A work item is ROWS = 32 frame rows x TB = 128
//    bins, over the tiles that meet some sigma's range; the items are
//    numbered row block by row block, and block b takes the contiguous
//    run [b n / GRAD_BLOCKS, (b + 1) n / GRAD_BLOCKS) in order.  For each
//    item the block stages the two X' planes of its rows over the columns
//    [k0 - pad, k0 + TB + NT - 1 - pad) (the tile and the halo its taps
//    need, zero outside [0, k_ext)) in shared memory once for all K
//    sigmas, and the rows' cotangent g when the row block changes.  Lane
//    l of a warp is row l; a thread owns VB = 8 consecutive bins of its
//    row, and the 4 warps take the tile's 16 bin groups in turn, skipping
//    a group outside the sigma's range.  Against the three costs of the
//    first design (one warp a bin over a dense filterbank row, S and the
//    tap sums with two shared loads an FMA, whole X' rows in shared
//    memory):
//    - dP over the bin's own bands only ([first, last] of its filterbank
//      row, at most two for a triangular filterbank), the bands of other
//      sigmas masked, so a bin whose two bands belong to two sigmas gives
//      each its own share.  The tile's bin ranges and each bin's first NB
//      filterbank entries are staged with the tile (all lanes read the
//      same entry, a broadcast, so the filterbank need not be
//      transposed); a bin with more bands reads the rest from the
//      filterbank.  Reading every entry from device memory inside the
//      dP loop, a chain of L2 latencies, was slower on the H100.
//    - S and the tap sums slide a window of the row's X' through
//      registers: tap i needs columns u + NT - 1 - i of the thread's bins
//      u, so each tap loads one new column a plane and feeds 8 FMAs a
//      plane; the row pitch is odd, so the 32 lanes' loads of one column
//      of 32 rows hit 32 banks.  The tap count NT is a template argument
//      (the dispatch ladder's 25, 33, 49, and 127 for any other 2J+1 up to
//      127, its taps padded with zeros on both sides), so every loop over
//      taps unrolls, the window's slots are registers and the thread's
//      tap sums acc[NT] stay in registers across all the rows and bins it
//      visits.  A thread's window never leaves the tile.
//    - The shared memory a block takes depends on NT, n_mels and K, not
//      on n_fft: 57 KB at NT = 49, n_mels = 64 and K = 1, 50 KB at
//      NT = 25, so four blocks an SM fit at any n_fft (the first design
//      staged whole X' rows: 133 KB at n_fft 4096, one block an SM).
//      The registers set the residency instead (below).
//    When the sigma changes, and at the end, the block adds its threads'
//    tap sums into a per-sigma sum in shared memory in a fixed order
//    (a shuffle tree in each warp, then the warps in turn), and writes one
//    partial a (sigma, tap) at the end.  X' is read from device memory
//    once for all K sigmas, plus the halo (NT - 1 columns a tile).
// 2. tap_sum_kernel: one block per (sigma, tap) sums its GRAD_BLOCKS
//    partials in a fixed order and a shared-memory tree.  No float
//    atomics anywhere, so two runs give bit-identical drho (the TPU
//    package likewise sums its per-block parts outside the kernel).
//
// Registers (ptxas -v on the H100 machine, printed by chip_smoke.py's
// build phase), with the budget min_blocks<NT>() sets: NT = 25, 128
// registers and 116 bytes of spill stores (4 blocks an SM); NT = 33, 168
// and 36 bytes (3); NT = 49, 255 and none (2); NT = 127, the instance off
// the dispatch's ladder, 255 and 8.4 KB of spills.  At NT = 49, capped
// at 128 or 168 registers (4 or 3 blocks) it spilled and ran slower on
// the H100 (PERF.md, Findings), so it runs 2 blocks an SM.  At NT = 25 more registers and fewer blocks
// were slower: there the staging's loads need the blocks in flight.
//
// What the TPU design needed and this one drops: bf16 residuals and the
// bf16 casts of dS and T (fp32 throughout), the stacked-adjoint concat
// (GEMM shapes for the MXU), the phase-major frame_io row order and the
// Nyquist split (128-lane tiling).  Bin n_bins-1 is an ordinary bin here.
//
// C interface: specband_bwd() launches the three kernels on the given
// stream and returns cudaGetLastError(); it does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;       // threads a block of tap_grad_kernel
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;           // frame rows a work item, one a lane
constexpr int VB = 8;              // consecutive bins a thread
constexpr int TB = 128;            // bins a work item
constexpr int GROUPS = TB / VB;    // bin groups of a work item
// The fixed grid: 4 blocks on each of the H100's 132 SMs.
constexpr int GRAD_BLOCKS = 528;
constexpr int MAX_TAPS = 127;      // taps a sigma: 2J + 1 with 2J < 128
constexpr int MAX_SIGMA = 8;       // the JAX package's k_sig * 128 <= 1024
constexpr int NB = 4;              // a bin's bands staged with the tile
constexpr int RANGE_THREADS = 256;
constexpr int SUM_THREADS = 256;

// Blocks an SM that each instance's register budget is set for: the tap
// sums acc[NT] and the unrolled slides grow with NT.
template <int NT>
__host__ __device__ constexpr int min_blocks() {
  return NT <= 25 ? 4 : NT <= 33 ? 3 : NT <= 49 ? 2 : 1;
}

// Row pitch of a staged X' plane: the tile and its halo, odd so that the
// 32 lanes (32 rows) reading one column hit 32 banks.
template <int NT>
__host__ __device__ constexpr int pitch() { return (TB + NT - 1) | 1; }

template <int NT>
size_t grad_smem_bytes(int n_mels, int k_sig) {
  return sizeof(float) * (2 * (size_t)ROWS * pitch<NT>()   // X' planes
                          + (size_t)n_mels * ROWS          // g
                          + 2 * (size_t)k_sig * NT         // taps, sums
                          + (size_t)WARPS * NT             // warp sums
                          + (size_t)(NB + 2) * TB          // fb, ranges
                          + n_mels);                       // map
}

// Each bin's range of mel bands, [first, last + 1) over its nonzero
// filterbank entries ([0, 0) for an empty row), and each sigma's range of
// bins, the smallest that holds every nonzero fb[k, m] with band_map[m] =
// s.  A warp a bin, its lanes on neighbouring bands (a coalesced read),
// the first and last nonzero from a ballot.  sig_range holds each sigma's
// (lo, -hi) as two running minima, which the caller starts at 0x7f7f7f7f
// with one memset (an empty sigma keeps lo > hi); integer minima do not
// depend on the order the warps run in.
__global__ void __launch_bounds__(RANGE_THREADS)
bin_range_kernel(const float* __restrict__ fb,
                 const int* __restrict__ band_map, int n_bins, int n_mels,
                 int* __restrict__ bin_range, int* __restrict__ sig_range) {
  const int k = blockIdx.x * (RANGE_THREADS / 32) + (threadIdx.x >> 5);
  if (k >= n_bins) return;
  const int lane = threadIdx.x & 31;
  const float* row = fb + (size_t)k * n_mels;
  int first = n_mels, last = -1;
  for (int m0 = 0; m0 < n_mels; m0 += 32) {
    const int m = m0 + lane;
    const bool nz = m < n_mels && __ldg(row + m) != 0.f;
    const unsigned mask = __ballot_sync(0xffffffffu, nz);
    if (mask != 0u) {
      first = min(first, m0 + __ffs(mask) - 1);
      last = m0 + 31 - __clz(mask);
    }
    if (nz) {
      const int s = band_map == nullptr ? 0 : __ldg(band_map + m);
      atomicMin(sig_range + 2 * s, k);
      atomicMin(sig_range + 2 * s + 1, -(k + 1));
    }
  }
  if (lane == 0) {
    bin_range[2 * k] = last < 0 ? 0 : first;
    bin_range[2 * k + 1] = last + 1;
  }
}

// The tap products of one thread's VB bins: dP from the bins' bands, S by
// sliding the row's X' through the ring ar/ai (slot (v - i) mod VB holds
// column v + NT - 1 - i at tap i), then w = 2 dP S, then the tap sums by
// the same slide.  xr/xi point at the row's column of the group's first
// bin; g at the row's cotangent of band 0 (bands ROWS floats apart); br
// at the bins' band ranges and fv at their first NB filterbank entries,
// as staged with the tile; fbk at the first bin's filterbank row, read
// only for a bin with more than NB bands.
template <int NT>
__device__ __forceinline__ void group_taps(
    const float* xr, const float* xi, const float* ts, const float* g,
    const int* br, const float* fv, const int* map,
    const float* __restrict__ fbk, int n_mels, int s, bool masked,
    float (&acc)[NT]) {
  float dp[VB];
  #pragma unroll
  for (int v = 0; v < VB; ++v) {
    float d = 0.f;
    const int lo = br[2 * v];
    const int hi = br[2 * v + 1];
    #pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int m = lo + j;
      if (m < hi && (!masked || map[m] == s))
        d = fmaf(g[m * ROWS], fv[v * NB + j], d);
    }
    for (int m = lo + NB; m < hi; ++m) {
      if (!masked || map[m] == s)
        d = fmaf(g[m * ROWS], __ldg(fbk + (size_t)v * n_mels + m), d);
    }
    dp[v] = 2.f * d;
  }

  float ar[VB], ai[VB], sr[VB], si[VB];
  #pragma unroll
  for (int v = 0; v < VB; ++v) {
    sr[v] = 0.f;
    si[v] = 0.f;
  }
  #pragma unroll
  for (int v = 1; v < VB; ++v) {
    ar[v] = xr[v + NT - 1];
    ai[v] = xi[v + NT - 1];
  }
  #pragma unroll
  for (int i = 0; i < NT; ++i) {
    ar[(VB - i % VB) % VB] = xr[NT - 1 - i];
    ai[(VB - i % VB) % VB] = xi[NT - 1 - i];
    const float r = ts[i];
    #pragma unroll
    for (int v = 0; v < VB; ++v) {
      const int sl = (v + VB - i % VB) % VB;
      sr[v] = fmaf(r, ar[sl], sr[v]);
      si[v] = fmaf(r, ai[sl], si[v]);
    }
  }
  #pragma unroll
  for (int v = 0; v < VB; ++v) {
    sr[v] *= dp[v];
    si[v] *= dp[v];
  }

  #pragma unroll
  for (int v = 1; v < VB; ++v) {
    ar[v] = xr[v + NT - 1];
    ai[v] = xi[v + NT - 1];
  }
  #pragma unroll
  for (int i = 0; i < NT; ++i) {
    ar[(VB - i % VB) % VB] = xr[NT - 1 - i];
    ai[(VB - i % VB) % VB] = xi[NT - 1 - i];
    float a = acc[i];
    #pragma unroll
    for (int v = 0; v < VB; ++v) {
      const int sl = (v + VB - i % VB) % VB;
      a = fmaf(sr[v], ar[sl], a);
      a = fmaf(si[v], ai[sl], a);
    }
    acc[i] = a;
  }
}

// Adds the block's tap sums to sum (one sigma's NT sums in shared memory):
// each warp's by a shuffle tree, then the warps in order.  Zeroes acc.
// Every thread of the block calls it.
template <int NT>
__device__ __forceinline__ void flush_taps(float (&acc)[NT], float* red,
                                           float* sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  #pragma unroll
  for (int i = 0; i < NT; ++i) {
    float v = acc[i];
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp * NT + i] = v;
    acc[i] = 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NT; i += THREADS) {
    float v = sum[i];
    #pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w * NT + i];
    sum[i] = v;
  }
  __syncthreads();
}

template <int NT>
__global__ void __launch_bounds__(THREADS, min_blocks<NT>())
tap_grad_kernel(const float* __restrict__ xext, const float* __restrict__ rho,
                const float* __restrict__ fb, const float* __restrict__ dmel,
                const float* __restrict__ logmel,
                const int* __restrict__ band_map,
                const int* __restrict__ sig_range,
                const int* __restrict__ bin_range,
                float* __restrict__ partials, int rows, int nfr, int kp,
                int k_ext, int n_bins, int n_taps, int n_mels, int k_sig) {
  constexpr int P = pitch<NT>();
  constexpr int W = TB + NT - 1;     // staged columns a row
  extern __shared__ __align__(16) float smem[];
  float* xr = smem;                    // ROWS x P, cos plane
  float* xi = xr + ROWS * P;           // ROWS x P, sin plane
  float* gs = xi + ROWS * P;           // n_mels x ROWS, cotangent
  float* taps = gs + n_mels * ROWS;    // k_sig x NT, zero-padded taps
  float* sums = taps + k_sig * NT;     // k_sig x NT, the block's tap sums
  float* red = sums + k_sig * NT;      // WARPS x NT
  float* fbv = red + WARPS * NT;       // TB x NB, the bins' first bands
  int* brange = reinterpret_cast<int*>(fbv + NB * TB);   // TB x 2
  int* map = brange + 2 * TB;          // n_mels
  __shared__ int s_lo[MAX_SIGMA], s_hi[MAX_SIGMA];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pad = (NT - n_taps) / 2;
  const int ncol = 2 * kp;
  // trial blockIdx.y of a pack: its spectra rows, taps, cotangent and
  // partials (rows is one trial's); every trial walks the same items
  const size_t trial = blockIdx.y;
  xext += trial * (size_t)rows * ncol;
  rho += trial * (size_t)k_sig * n_taps;
  dmel += trial * (size_t)rows * n_mels;
  if (logmel != nullptr) logmel += trial * (size_t)rows * n_mels;
  partials += trial * (size_t)k_sig * n_taps * gridDim.x;
  const bool masked = band_map != nullptr;
  // the staging's four-column loads: aligned rows and tile starts
  const bool vec = W % 4 == 0 && pad % 4 == 0 && kp % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(xext) & 15) == 0;

  for (int i = tid; i < k_sig * NT; i += THREADS) {
    const int s = i / NT;
    const int d = i - s * NT - pad;
    taps[i] = (d >= 0 && d < n_taps) ? __ldg(rho + s * n_taps + d) : 0.f;
    sums[i] = 0.f;
  }
  for (int m = tid; m < n_mels; m += THREADS)
    map[m] = masked ? __ldg(band_map + m) : 0;
  if (tid < k_sig) {
    s_lo[tid] = __ldg(sig_range + 2 * tid);
    s_hi[tid] = -__ldg(sig_range + 2 * tid + 1);
  }
  __syncthreads();

  // the tiles that meet some sigma's range, and this block's run of items
  int lo = n_bins, hi = 0;
  for (int s = 0; s < k_sig; ++s) {
    if (s_lo[s] < s_hi[s]) {
      lo = min(lo, s_lo[s]);
      hi = max(hi, s_hi[s]);
    }
  }
  const int t_lo = lo / TB;
  const int n_tiles = hi > lo ? (hi - 1) / TB + 1 - t_lo : 0;
  const long long n_items = (long long)((rows + ROWS - 1) / ROWS) * n_tiles;
  const long long it0 = n_items * blockIdx.x / gridDim.x;
  const long long it1 = n_items * (blockIdx.x + 1) / gridDim.x;

  float acc[NT];
  #pragma unroll
  for (int i = 0; i < NT; ++i) acc[i] = 0.f;
  int cur_s = -1;
  int cur_rb = -1;
  for (long long it = it0; it < it1; ++it) {
    const int rb = static_cast<int>(it / n_tiles);
    const int k0 = (t_lo + static_cast<int>(it - (long long)rb * n_tiles)) * TB;
    const int row0 = rb * ROWS;
    __syncthreads();                 // the last item's reads are done
    if (rb != cur_rb) {
      // (mel m, row f) pairs with f fastest: neighbouring threads read
      // neighbouring frames of one mel band of the (B, n_mels, nfr) input
      for (int i = tid; i < ROWS * n_mels; i += THREADS) {
        const int m = i / ROWS;
        const int f = i - m * ROWS;
        const int r = row0 + f;
        float v = 0.f;
        if (r < rows) {
          const int b = r / nfr;
          const size_t at = ((size_t)b * n_mels + m) * nfr + (r - b * nfr);
          v = __ldg(dmel + at);
          if (logmel != nullptr) v *= expf(-__ldg(logmel + at));
        }
        gs[i] = v;
      }
      cur_rb = rb;
    }
    if (vec) {
      // four columns a load: the tile starts on a multiple of 4 columns
      for (int i = tid; i < ROWS * W / 4; i += THREADS) {
        const int f = i / (W / 4);
        const int c = 4 * (i - f * (W / 4));
        const int r = row0 + f;
        const int col = k0 - pad + c;
        float4 re = make_float4(0.f, 0.f, 0.f, 0.f), im = re;
        if (r < rows) {
          const float* src = xext + (size_t)r * ncol + col;
          if (col + 3 < k_ext) {
            re = __ldg(reinterpret_cast<const float4*>(src));
            im = __ldg(reinterpret_cast<const float4*>(src + kp));
          } else {
            float* a = &re.x;
            float* b = &im.x;
            for (int e = 0; e < 4 && col + e < k_ext; ++e) {
              a[e] = __ldg(src + e);
              b[e] = __ldg(src + kp + e);
            }
          }
        }
        float* dr = xr + f * P + c;
        float* di = xi + f * P + c;
        dr[0] = re.x; dr[1] = re.y; dr[2] = re.z; dr[3] = re.w;
        di[0] = im.x; di[1] = im.y; di[2] = im.z; di[3] = im.w;
      }
    } else {
      for (int i = tid; i < ROWS * W; i += THREADS) {
        const int f = i / W;
        const int c = i - f * W;
        const int r = row0 + f;
        const int col = k0 - pad + c;
        float re = 0.f, im = 0.f;
        if (r < rows && col >= 0 && col < k_ext) {
          const float* src = xext + (size_t)r * ncol;
          re = __ldg(src + col);
          im = __ldg(src + kp + col);
        }
        xr[f * P + c] = re;
        xi[f * P + c] = im;
      }
    }
    for (int u = tid; u < TB; u += THREADS) {
      const int k = k0 + u;
      const int lo = k < n_bins ? __ldg(bin_range + 2 * k) : 0;
      const int hi = k < n_bins ? __ldg(bin_range + 2 * k + 1) : 0;
      brange[2 * u] = lo;
      brange[2 * u + 1] = hi;
      #pragma unroll
      for (int j = 0; j < NB; ++j)
        fbv[u * NB + j] =
            lo + j < hi ? __ldg(fb + (size_t)k * n_mels + lo + j) : 0.f;
    }
    __syncthreads();

    for (int s = 0; s < k_sig; ++s) {
      const int u_lo = max(s_lo[s] - k0, 0);
      const int u_hi = min(s_hi[s] - k0, TB);
      if (u_lo >= u_hi) continue;
      if (s != cur_s) {
        if (cur_s >= 0) flush_taps<NT>(acc, red, sums + cur_s * NT);
        cur_s = s;
      }
      for (int q = warp; q < GROUPS; q += WARPS) {
        const int u0 = q * VB;
        if (u0 + VB <= u_lo || u0 >= u_hi) continue;
        group_taps<NT>(xr + lane * P + u0, xi + lane * P + u0, taps + s * NT,
                       gs + lane, brange + 2 * u0, fbv + NB * u0, map,
                       fb + (size_t)(k0 + u0) * n_mels, n_mels, s, masked,
                       acc);
      }
    }
  }
  if (cur_s >= 0) flush_taps<NT>(acc, red, sums + cur_s * NT);
  __syncthreads();
  for (int i = tid; i < k_sig * n_taps; i += THREADS) {
    const int s = i / n_taps;
    partials[(size_t)i * gridDim.x + blockIdx.x] =
        sums[s * NT + pad + i - s * n_taps];
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

template <int NT>
cudaError_t launch_grad(const float* xext, const float* rho, const float* fb,
                        const float* dmel, const float* logmel,
                        const int* band_map, const int* sig_range,
                        const int* bin_range, float* partials, int rows,
                        int trials, int nfr, int kp, int k_ext, int n_bins,
                        int n_taps, int n_mels, int k_sig, cudaStream_t s) {
  const size_t smem = grad_smem_bytes<NT>(n_mels, k_sig);
  cudaError_t err = cudaFuncSetAttribute(
      tap_grad_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tap_grad_kernel<NT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  tap_grad_kernel<NT><<<dim3(GRAD_BLOCKS, trials), THREADS, smem, s>>>(
      xext, rho, fb, dmel, logmel, band_map, sig_range, bin_range, partials,
      rows, nfr, kp, k_ext, n_bins, n_taps, n_mels, k_sig);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* specband_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Columns of the partials scratch the caller allocates, (trials * k_sig *
// n_taps, columns): one a block of the fixed grid.
int specband_bwd_partial_blocks() { return GRAD_BLOCKS; }

// The tap count of the kernel instance that serves n_taps taps (its taps
// zero-padded on both sides), 0 where none does.
int specband_bwd_tap_instance(int n_taps) {
  if (n_taps <= 0 || n_taps > MAX_TAPS || n_taps % 2 == 0) return 0;
  return n_taps <= 25 ? 25 : n_taps <= 33 ? 33 : n_taps <= 49 ? 49 : 127;
}

// A pack of `trials` trials, each of `rows` frame rows: xext (trials*rows,
// 2*kp) as specband_fwd wrote it; rho (trials, k_sig, n_taps); fb (n_bins,
// n_mels); dmel and logmel (trials*batch, n_mels, nfr), logmel null
// without the log epilogue; band_map (n_mels) int32, each mel band's sigma
// in [0, k_sig), or null for k_sig = 1; sig_range scratch (k_sig, 2) and
// bin_range scratch (n_bins, 2), int32, shared by the trials; partials
// scratch (trials * k_sig * n_taps, specband_bwd_partial_blocks()); drho
// (trials, k_sig, n_taps).  tap_grad_kernel takes the trial as a grid
// dimension and each trial's partials are summed in the order of a launch
// with trials = 1 on its rows, so trial k's drho is bit for bit that
// launch's.  All fp32 unless stated, contiguous, on the current device.
int specband_bwd(const float* xext, const float* rho, const float* fb,
                 const float* dmel, const float* logmel, const int* band_map,
                 int* sig_range, int* bin_range, float* partials, float* drho,
                 int rows, int trials, int nfr, int kp, int k_ext, int n_bins,
                 int n_taps, int n_mels, int k_sig, void* stream) {
  const int nt = specband_bwd_tap_instance(n_taps);
  if (rows <= 0 || trials <= 0 || trials > 65535 || nfr <= 0 ||
      rows % nfr != 0 || k_ext > kp || nt == 0 ||
      n_bins + n_taps - 1 != k_ext || n_mels <= 0 || k_sig < 1 ||
      k_sig > MAX_SIGMA || (k_sig > 1 && band_map == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(sig_range, 0x7f, sizeof(int) * 2 * k_sig, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bins_a_block = RANGE_THREADS / 32;
  bin_range_kernel<<<(n_bins + bins_a_block - 1) / bins_a_block,
                     RANGE_THREADS, 0, s>>>(fb, band_map, n_bins, n_mels,
                                            bin_range, sig_range);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto launch = nt == 25 ? launch_grad<25>
                : nt == 33 ? launch_grad<33>
                : nt == 49 ? launch_grad<49> : launch_grad<127>;
  err = launch(xext, rho, fb, dmel, logmel, band_map, sig_range, bin_range,
               partials, rows, trials, nfr, kp, k_ext, n_bins, n_taps, n_mels,
               k_sig, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tap_sum_kernel<<<trials * k_sig * n_taps, SUM_THREADS, 0, s>>>(
      partials, drho, GRAD_BLOCKS);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
