// A real FFT of each frame of a block, in shared memory, in fp32, and its
// adjoint, at any even frame length up to 4096; included by framed_fwd.cu
// (K3 and K5), specband_fwd.cu (K1) and framed_bwd.cu (K4 and K6) inside
// their anonymous namespaces.
//
// A real frame x of even length N is read in pairs as M = N/2 complex
// values z[n] = x[2n] + i x[2n+1]: the float view of the complex buffer is
// the frame itself, so a block loads its frames with plain coalesced float
// stores.  A complex FFT of length M runs as Stockham stages (ping-pong
// buffers, the output in natural order, no bit-reversal pass) of radix 4,
// then at most one radix 2, then radix 3 and radix 5.  The stage of radix
// R after stages whose radices multiply to L takes butterfly i < M/R with
// k = i mod L: inputs z[i + r M/R] times the twiddle W_{LR}^{rk}, a
// radix-R DFT, outputs to (i - k) R + k + q L.  The real post-pass then
// gives bin k <= M of x:
//
//   X[k] = E + W_N^k O,  E = (Z[k] + conj Z[M-k]) / 2,
//                        O = (Z[k] - conj Z[M-k]) / 2i,  Z[M] = Z[0].
//
// The adjoint of the real DFT (K6: dfw[m] = sum_k dRe[k] cos(2 pi m k / N)
// - dIm[k] sin(2 pi m k / N), k <= N/2) is N irfft(Y) with Y[k] = (dRe + i
// dIm)[k] / 2 for 0 < k < M, Y[0] = dRe[0], Y[M] = dRe[M].  Its real
// pre-pass, the inverse of the post-pass above, gives the M complex inputs
//
//   Z[k] = A + i W_N^-k B,  A = Y[k] + conj Y[M-k],  B = Y[k] - conj Y[M-k]
//
// (irfft_prepass), and the inverse complex DFT of Z, read in pairs, is the
// frame: dfw[2n] + i dfw[2n+1] = sum_k Z[k] W_M^-nk.  That inverse runs as
// the forward stages on conj Z, the output conjugated as it is read:
// conj FFT(conj Z) is the FFT with conjugate twiddles to the bit (the
// same products and sums with flipped signs), so fft_frames and
// fft_butterfly serve both directions unchanged.
//
// Every twiddle is an entry of the kernels' float32 table (cos and -sin of
// 2 pi i / N, built in float64 and rounded once) at an exact integer
// phase: W_{LR}^{rk} is entry r k N / (L R), W_R^q entry q N / R.  No angle
// is computed in float.  Each output is one fixed sequence of operations,
// so repeats are bit-identical.
//
// Where M has a prime factor above 5 (faithful mode's N = 2 T, e.g. 1400
// = 2^3 5^2 7), K5 and K6 take Bluestein's chirp-z instead
// (bluestein_frames): with the chirp c[n] = exp(-i pi n^2 / M) = W_N^(n^2),
//
//   Z[k] = c[k] sum_n (z[n] c[n]) conj c[k - n],
//
// a circular convolution of length P, the smallest power of two >= 2 M -
// 1 (16 to 4096): P-point FFT of z c zero-padded, times the FFT of the
// conjugate chirp (built on the host in float64, divided by P and rounded
// once), the inverse FFT (the forward stages on conjugated data, as
// above), times c[k].  Its P-point FFTs are the same Stockham stages (radix
// 4, then at most one radix 2), butterfly for butterfly and twiddle for
// twiddle; each chirp is entry n^2 mod N of the N-entry table, and each
// twiddle W_{LR}^{rk} entry r k 2P / (L R) of the 2P-entry one, which the
// host lays out for the kernels (fft_plan.py:bluestein_table_np).  Against
// numpy's float64 rfft the arithmetic errs by 1.0-2.2e-7 of the largest
// bin at M = 7 to 2039 (the direct DFT 0.9-4.9e-7; tests/test_torch_fft.py).
//
// The stage (the radices in stage order, and Bluestein's P and tables) is
// decided on the host (dmel_tpu_torch/ops/fft_plan.py), checked by
// fft_stage_from() and passed by value.
// dmel_tpu_torch/ops/fft_plan.py:rfft_mirror and irfft_adjoint_mirror are
// this arithmetic step by step in PyTorch, held to numpy's rfft and irfft
// by the CPU tests.
//
// On the card the stages are bound by issue and latency, not by bytes or
// flops: each stage is a pass through shared memory and a barrier, with a
// few butterflies a thread in between, so the time follows how many blocks
// an SM keeps resident.  The planned stages keep a block small (256
// threads, at most 64 registers, 32 KB of shared memory: 4-5 blocks an SM)
// and every index update free of integer division in the inner loops.
// Keeping pairs of radix-4 stages in registers, a shared-memory twiddle
// table and more frames a block each measured slower there on the H100
// (PERF.md, Findings): they cost registers or shared memory, and so
// resident blocks.
//
// Bluestein's stage runs two P-point FFTs a frame, and its first design,
// built like the planned one (a stage a pass, ping-pong buffers of P
// points), took ~15 passes a frame at P = 4096 with 64 KB of shared memory
// (3 blocks an SM) and twiddle gathers from a 64 KB table that did not stay
// in L1: 2.75 ms for K5 at faithful B 512 x 2039, 65 % of it in the two
// FFTs and a quarter in the gathers (tools/bluestein_split.py; NVIDIA H100
// 80GB HBM3, 700 W).  Residency there is already bound by the shared
// memory, so registers are cheap, and the design is:
// - a block holds 4096 points (max(1, 4096 / P) frames) in one buffer of
//   P + P / 16 points a frame (34 KB), the exchange in place: read all,
//   barrier, write;
// - each thread holds 16 points of its frame in registers through a pass
//   of two stages (a radix-16 step), so an FFT is 3 passes at P = 2048 and
//   4096 (4, 4 | 4, 4 | 4, 2 or 4, 4), and the last pass of the first FFT
//   hands its registers to the first pass of the second with no exchange:
//   4 exchanges and the output a frame, ~10 barriers, where the first
//   design took ~15 passes and barriers;
// - the chirp multiply is folded into the first pass, B^ and the
//   conjugations into the hand-over, the chirp into the last pass; the
//   zero half of the first FFT's input is never loaded (its butterflies
//   drop the additions of zero), and of the second FFT's outputs those
//   past P / 2 are never formed, those past M never stored;
// - twiddles are read as one 8-byte load each, from a table laid out by
//   stage (entry (r, k) of a stage at L - 4 + (r - 1) L + k): the threads
//   of a warp read neighbouring entries, and the whole table is P - 4
//   entries (32 KB at 4096), beside the chirp in natural order;
// - one float2 of padding every 16 keeps the radix-16 stores free of bank
//   conflicts.
// K5 takes 0.68 ms there, 4.0x less, K6 1.00 ms, 2.8x less (PERF.md).
// Each output is the same sequence of rounded operations as the first
// design's (the multiplies by twiddle entry 0, exactly 1, and the
// additions of zero dropped: they change no finite nonzero value), which
// tests/test_torch_fft.py holds by emulating the passes against the
// mirror bit for bit at every P; but not the same instructions: nvcc fuses
// multiplies and adds where it finds them, and which it finds follows the
// code around them, so on the card the results differ from the first
// design's in their last bits (at most 2.9e-7 of the largest Re|Im entry
// at faithful B 512; PERF.md).

constexpr int FFT_THREADS = 256;
constexpr int FFT_MAX_STAGES = 12;
// samples a block transforms: max(1, FFT_BLOCK_POINTS / N) frames a block,
// two complex buffers of M values a frame, 32 KB of shared memory a block
// at every N (<= 48 KB up to N = 4096: no opt-in needed, though the
// launchers set it)
constexpr int FFT_BLOCK_POINTS = 4096;

struct FftPlan {
  int n_stages;
  int radix[FFT_MAX_STAGES];
};

// K5's and K6's spectra stage (fft_plan.py:fused_stage): the plan of the
// complex FFT of length n_fft / 2 (m_pad = 0), or Bluestein's (m_pad > 0):
// the plan of the m_pad-point FFT, its (2, 2 m_pad) twiddle table and
// bhat, FFT(b) / m_pad of the conjugate chirp (m_pad (re, im) pairs).
struct FftStage {
  FftPlan plan;
  int m_pad;
  const float* table;
  const float2* bhat;
};

// fewest and most points of Bluestein's padded FFT: 2 (n_fft / 2) - 1 <=
// 4095; at least one pass of two radix-4 stages
constexpr int BLUESTEIN_MIN_POINTS = 16;
constexpr int BLUESTEIN_MAX_POINTS = 4096;
// points of a frame a thread of Bluestein's stage holds through a pass
constexpr int BL_POINTS = 16;
static_assert(BL_POINTS * FFT_THREADS == 4096, "a block holds 4096 points");
// blocks an SM K5's and K6's Bluestein kernels are built for
// (__launch_bounds__): 34 KB of shared memory a block (K6 50 KB, with its
// dw sums), at most 85 and 128 registers a thread
constexpr int BLUESTEIN_FWD_BLOCKS = 3;
constexpr int BLUESTEIN_BWD_BLOCKS = 2;

// The plan from the host's radices; false where it is not a plan of the
// complex FFT of length n_fft / 2.
inline bool fft_plan_from(const int* radices, int n_stages, int n_fft,
                          FftPlan* plan) {
  if (radices == nullptr || n_stages < 0 || n_stages > FFT_MAX_STAGES ||
      n_fft < 2 || n_fft % 2 != 0) {
    return false;
  }
  int m = 1;
  plan->n_stages = n_stages;
  for (int s = 0; s < FFT_MAX_STAGES; ++s) plan->radix[s] = 0;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    if (r != 2 && r != 3 && r != 4 && r != 5) return false;
    plan->radix[s] = r;
    m *= r;
    if (m > n_fft / 2) return false;
  }
  return m == n_fft / 2;
}

// The stage from the host's arguments: m_pad = 0 takes the radices as a
// plan of the complex FFT of length n_fft / 2 (no tables); m_pad > 0 as
// Bluestein's, where m_pad must be the smallest power of two >= n_fft - 1,
// at most BLUESTEIN_MAX_POINTS, the radices a plan of the m_pad-point FFT
// and both tables given.  False otherwise.
inline bool fft_stage_from(const int* radices, int n_stages, int n_fft,
                           int m_pad, const float* table, const float* bhat,
                           FftStage* stage) {
  stage->m_pad = m_pad;
  stage->table = table;
  stage->bhat = reinterpret_cast<const float2*>(bhat);
  if (m_pad == 0) {
    return table == nullptr && bhat == nullptr &&
           fft_plan_from(radices, n_stages, n_fft, &stage->plan);
  }
  if (table == nullptr || bhat == nullptr || n_fft < 2 || n_fft % 2 != 0 ||
      m_pad < 1 || m_pad > BLUESTEIN_MAX_POINTS || (m_pad & (m_pad - 1)) ||
      m_pad < n_fft - 1 || m_pad >= 2 * (n_fft - 1)) {
    return false;
  }
  if (m_pad < BLUESTEIN_MIN_POINTS ||
      !fft_plan_from(radices, n_stages, 2 * m_pad, &stage->plan)) {
    return false;
  }
  // radix 4, then at most one radix 2 (bluestein_frames' passes)
  for (int s = 0; s + 1 < n_stages; ++s) {
    if (radices[s] != 4) return false;
  }
  return true;
}

inline int fft_frames_per_block(int n_fft) {
  return n_fft >= FFT_BLOCK_POINTS ? 1 : FFT_BLOCK_POINTS / n_fft;
}

inline size_t fft_smem_bytes(int n_fft) {
  return sizeof(float2) * (size_t)fft_frames_per_block(n_fft) * n_fft;
}

// Frames a block and shared bytes a block of a stage: the plan's as above;
// Bluestein's max(1, FFT_BLOCK_POINTS / m_pad) frames of m_pad + m_pad / 16
// points (34 KB a block at every m_pad)
inline int fft_stage_frames(int n_fft, const FftStage& stage) {
  if (stage.m_pad == 0) return fft_frames_per_block(n_fft);
  return stage.m_pad >= FFT_BLOCK_POINTS ? 1
                                         : FFT_BLOCK_POINTS / stage.m_pad;
}

inline size_t fft_stage_smem(int n_fft, const FftStage& stage) {
  if (stage.m_pad == 0) return fft_smem_bytes(n_fft);
  return sizeof(float2) * (size_t)fft_stage_frames(n_fft, stage) *
         (stage.m_pad + stage.m_pad / 16);
}

__device__ __forceinline__ float2 fft_tw(const float* __restrict__ tab,
                                         int n, int idx) {
  return make_float2(__ldg(tab + idx), __ldg(tab + n + idx));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// One butterfly of radix R: src[r * stride] in, dst[q * l] out; the
// twiddle of input r is table entry r * t, or none where t < 0 (the first
// stage, whose twiddles are all entry 0: exactly 1).
template <int R>
__device__ __forceinline__ void fft_butterfly(
    const float2* __restrict__ src, float2* __restrict__ dst, int stride,
    int l, int t, const float* __restrict__ tab, int n) {
  float2 a[R];
  #pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = t < 0 ? src[r * stride]
                 : cmul(src[r * stride], fft_tw(tab, n, r * t));
  }
  if constexpr (R == 2) {
    dst[0] = make_float2(a[0].x + a[1].x, a[0].y + a[1].y);
    dst[l] = make_float2(a[0].x - a[1].x, a[0].y - a[1].y);
  } else if constexpr (R == 4) {
    const float2 t0 = make_float2(a[0].x + a[2].x, a[0].y + a[2].y);
    const float2 t1 = make_float2(a[0].x - a[2].x, a[0].y - a[2].y);
    const float2 t2 = make_float2(a[1].x + a[3].x, a[1].y + a[3].y);
    const float2 t3 = make_float2(a[1].x - a[3].x, a[1].y - a[3].y);
    dst[0] = make_float2(t0.x + t2.x, t0.y + t2.y);
    dst[l] = make_float2(t1.x + t3.y, t1.y - t3.x);
    dst[2 * l] = make_float2(t0.x - t2.x, t0.y - t2.y);
    dst[3 * l] = make_float2(t1.x - t3.y, t1.y + t3.x);
  } else if constexpr (R == 3) {
    const float2 w = fft_tw(tab, n, n / 3);
    const float2 s = make_float2(a[1].x + a[2].x, a[1].y + a[2].y);
    const float2 d = make_float2(a[1].x - a[2].x, a[1].y - a[2].y);
    const float2 m = make_float2(a[0].x + w.x * s.x, a[0].y + w.x * s.y);
    dst[0] = make_float2(a[0].x + s.x, a[0].y + s.y);
    dst[l] = make_float2(m.x - w.y * d.y, m.y + w.y * d.x);
    dst[2 * l] = make_float2(m.x + w.y * d.y, m.y - w.y * d.x);
  } else {  // R == 5
    const float2 w1 = fft_tw(tab, n, n / 5);
    const float2 w2 = fft_tw(tab, n, 2 * (n / 5));
    const float2 p1 = make_float2(a[1].x + a[4].x, a[1].y + a[4].y);
    const float2 d1 = make_float2(a[1].x - a[4].x, a[1].y - a[4].y);
    const float2 p2 = make_float2(a[2].x + a[3].x, a[2].y + a[3].y);
    const float2 d2 = make_float2(a[2].x - a[3].x, a[2].y - a[3].y);
    const float2 m1 = make_float2(a[0].x + w1.x * p1.x + w2.x * p2.x,
                                  a[0].y + w1.x * p1.y + w2.x * p2.y);
    const float2 m2 = make_float2(a[0].x + w2.x * p1.x + w1.x * p2.x,
                                  a[0].y + w2.x * p1.y + w1.x * p2.y);
    const float2 n1 = make_float2(w1.y * d1.x + w2.y * d2.x,
                                  w1.y * d1.y + w2.y * d2.y);
    const float2 n2 = make_float2(w2.y * d1.x - w1.y * d2.x,
                                  w2.y * d1.y - w1.y * d2.y);
    dst[0] = make_float2(a[0].x + p1.x + p2.x, a[0].y + p1.y + p2.y);
    dst[l] = make_float2(m1.x - n1.y, m1.y + n1.x);
    dst[2 * l] = make_float2(m2.x - n2.y, m2.y + n2.x);
    dst[3 * l] = make_float2(m2.x + n2.y, m2.y - n2.x);
    dst[4 * l] = make_float2(m1.x + n1.y, m1.y - n1.x);
  }
}

// The complex FFT of length m = n / 2 of each of the fr frames in `a`
// (frame f at a + f m), by all threads of the block; `b` is as large.
// Returns the buffer that holds the result.  Starts and ends with every
// thread past a barrier.
__device__ __forceinline__ float2* fft_frames(
    float2* a, float2* b, int fr, int n, const FftPlan& plan,
    const float* __restrict__ tab) {
  const int m = n / 2;
  int l = 1;
  __syncthreads();
  for (int s = 0; s < plan.n_stages; ++s) {
    const int r = plan.radix[s];
    const int stride = m / r;
    const int step = n / (l * r);           // W_{lr} is entry `step`
    // butterfly (f, i) of this thread, k = i mod l; each step advances the
    // flat index f stride + i by FFT_THREADS, and k by as much mod l (l
    // divides stride, so wrapping i past stride leaves k as it is)
    int f = threadIdx.x / stride;
    int i = threadIdx.x - f * stride;
    int k = i % l;
    const int df = FFT_THREADS / stride;
    const int di = FFT_THREADS - df * stride;
    const int dk = di % l;
    for (; f < fr; f += df, i += di, k += dk) {
      if (i >= stride) {
        i -= stride;
        ++f;
        if (f >= fr) break;
      }
      if (k >= l) k -= l;
      const float2* src = a + f * m + i;
      float2* dst = b + f * m + (i - k) * r + k;
      const int t = l == 1 ? -1 : k * step;
      switch (r) {
        case 4: fft_butterfly<4>(src, dst, stride, l, t, tab, n); break;
        case 2: fft_butterfly<2>(src, dst, stride, l, t, tab, n); break;
        case 3: fft_butterfly<3>(src, dst, stride, l, t, tab, n); break;
        default: fft_butterfly<5>(src, dst, stride, l, t, tab, n);
      }
    }
    __syncthreads();
    float2* tmp = a;
    a = b;
    b = tmp;
    l *= r;
  }
  return a;
}

// Calls fn(f, k) for every (frame f < fr, column k < ncol) pair of this
// thread: the block's threads cover the fr x ncol pairs with k fastest.
template <class Fn>
__device__ __forceinline__ void for_frame_columns(int fr, int ncol, Fn fn) {
  int f = threadIdx.x / ncol;
  int k = threadIdx.x - f * ncol;
  const int df = FFT_THREADS / ncol;
  const int dk = FFT_THREADS - df * ncol;
  for (; f < fr; f += df, k += dk) {
    if (k >= ncol) {
      k -= ncol;
      ++f;
      if (f >= fr) break;
    }
    fn(f, k);
  }
}

// Bin k (0 <= k <= n/2) of the real frame whose complex FFT of length
// m = n / 2 is z.
__device__ __forceinline__ float2 rfft_bin(const float2* z, int n, int k,
                                           const float* __restrict__ tab) {
  const int m = n / 2;
  const float2 zk = z[k == m ? 0 : k];
  const float2 zm = z[k == 0 ? 0 : m - k];
  const float er = 0.5f * (zk.x + zm.x);
  const float ei = 0.5f * (zk.y - zm.y);
  const float orr = 0.5f * (zk.y + zm.y);
  const float oi = -0.5f * (zk.x - zm.x);
  const float2 w = fft_tw(tab, n, k);
  return make_float2(er + (w.x * orr - w.y * oi), ei + (w.x * oi + w.y * orr));
}

// conj Z[k] (0 <= k < m = n / 2): the input of the forward stages whose
// conjugated output is the inverse real FFT of the half spectrum y, with
// y[k] = Y[k] for 0 < k < m and y[0] = (Y[0], Y[m]), both real.
__device__ __forceinline__ float2 irfft_prepass(const float2* y, int n, int k,
                                               const float* __restrict__ tab) {
  const int m = n / 2;
  const float2 yk = k == 0 ? make_float2(y[0].x, 0.f) : y[k];
  const float2 ym = k == 0 ? make_float2(y[0].y, 0.f) : y[m - k];
  const float ar = yk.x + ym.x;
  const float ai = yk.y - ym.y;
  const float br = yk.x - ym.x;
  const float bi = yk.y + ym.y;
  const float2 w = fft_tw(tab, n, k);      // W_N^k; W_N^-k = (w.x, -w.y)
  return make_float2(ar - (w.x * bi - w.y * br),
                     -(ai + (w.x * br + w.y * bi)));
}

// Loads the fr frames of rows row0 .. row0 + fr - 1 (row b nfr + t is
// frame t of batch row b of x, the signal zero-padded by n/2 on both
// sides) into `a` as fr * n floats, times w[m] where w is given; rows past
// `rows` load zeros.  Sample (f, mm) of this thread advances by
// FFT_THREADS a step; a frame's offset in x is found once a frame.
__device__ __forceinline__ void fft_load_frames(
    float2* a, const float* __restrict__ x, const float* __restrict__ w,
    int row0, int fr, int rows, int sig_len, int nfr, int hop, int n) {
  float* dst = reinterpret_cast<float*>(a);
  int f = threadIdx.x / n;
  int mm = threadIdx.x - f * n;
  const int df = FFT_THREADS / n;
  const int dm = FFT_THREADS - df * n;
  int f_src = -1;
  const float* src = x;
  int start = 0;
  for (; f < fr; f += df, mm += dm) {
    if (mm >= n) {
      mm -= n;
      ++f;
      if (f >= fr) break;
    }
    const int r = row0 + f;
    if (f != f_src && r < rows) {
      const int b = r / nfr;
      src = x + (size_t)b * sig_len;
      start = (r - b * nfr) * hop - n / 2;
      f_src = f;
    }
    const int p = start + mm;
    float v = 0.f;
    if (r < rows && p >= 0 && p < sig_len) {
      v = __ldg(src + p);
      if (w != nullptr) v *= __ldg(w + mm);
    }
    dst[f * n + mm] = v;
  }
}

// ---- Bluestein's stage ----------------------------------------------------
//
// A thread of the block owns frame f = t / (P / 16) and i0 = t mod (P / 16)
// (FFT_THREADS x 16 = 4096 points: every thread busy at every P).  A pass
// of radices (R1, R2) (R2 = 1: one stage) after stages multiplying to l
// takes items i = i0 + (P / 16) u, u < 16 / S (S = R1 R2): item i holds
// the points i + c P / S, c < S, in registers v[u S + c] (c = r R2 + r'),
// runs stage one (R2 butterflies of radix R1 over r at l, twiddle (r, k),
// k = i mod l) and stage two (R1 butterflies of radix R2 over r' at R1 l,
// twiddle (r', q l + k)), exactly the Stockham butterflies of fft_frames,
// and leaves output (q, q') in v[u S + q R2 + q'], bound for point (i - k)
// S + k + l (q + R1 q').  The passes are (4, 4) while two radix-4 stages
// remain, then (4, 4), (4, 2), (4, 1) or (2, 1).  The last pass of an FFT
// leaves point i0 + (P / 16) (u + (16 / S) (q + R1 q')) in a thread's
// registers, which is what the first pass reads: the hand-over between the
// two FFTs is a renaming of registers.

// the frame of the block's max(1, 4096 / m_pad) that this thread works on
__device__ __forceinline__ int bl_frame(int mp) {
  return threadIdx.x / (mp >> 4);
}

// a point's place in its frame's buffer: a float2 of padding every 16
__device__ __forceinline__ int bl_pad(int i) { return i + (i >> 4); }

// twiddle W_{4l}^{rk} (or W_{2l}^{k}) of the stage at l >= 4, r >= 1:
// entry l - 4 + (r - 1) l + k of the stage table
__device__ __forceinline__ float2 bl_tw(const float2* __restrict__ tw, int l,
                                        int r, int k) {
  return __ldg(tw + (l - 4) + (r - 1) * l + k);
}

__device__ __forceinline__ void bl_radix4(float2& a0, float2& a1, float2& a2,
                                          float2& a3) {
  const float2 t0 = make_float2(a0.x + a2.x, a0.y + a2.y);
  const float2 t1 = make_float2(a0.x - a2.x, a0.y - a2.y);
  const float2 t2 = make_float2(a1.x + a3.x, a1.y + a3.y);
  const float2 t3 = make_float2(a1.x - a3.x, a1.y - a3.y);
  a0 = make_float2(t0.x + t2.x, t0.y + t2.y);
  a1 = make_float2(t1.x + t3.y, t1.y - t3.x);
  a2 = make_float2(t0.x - t2.x, t0.y - t2.y);
  a3 = make_float2(t1.x - t3.y, t1.y + t3.x);
}

// bl_radix4 with a2 = a3 = 0 (the first FFT's zero half): t0 = t1 = a0,
// t2 = t3 = a1
__device__ __forceinline__ void bl_radix4_half(float2& a0, float2& a1,
                                               float2& a2, float2& a3) {
  const float2 t0 = a0;
  const float2 t2 = a1;
  a0 = make_float2(t0.x + t2.x, t0.y + t2.y);
  a1 = make_float2(t0.x + t2.y, t0.y - t2.x);
  a2 = make_float2(t0.x - t2.x, t0.y - t2.y);
  a3 = make_float2(t0.x - t2.y, t0.y + t2.x);
}

__device__ __forceinline__ void bl_radix2(float2& a0, float2& a1) {
  const float2 t = a0;
  a0 = make_float2(t.x + a1.x, t.y + a1.y);
  a1 = make_float2(t.x - a1.x, t.y - a1.y);
}

// One pass of radices (R1, R2) at l on the thread's registers (see above);
// ZERO_HALF: the first FFT's first pass, inputs r >= 2 of stage one zero.
template <int R1, int R2, bool ZERO_HALF>
__device__ __forceinline__ void bl_pass(float2 (&v)[BL_POINTS], int i0,
                                        int q16, int l,
                                        const float2* __restrict__ tw) {
  constexpr int S = R1 * R2;
  #pragma unroll
  for (int u = 0; u < BL_POINTS / S; ++u) {
    const int i = i0 + q16 * u;
    const int k = i & (l - 1);
    float2 w1[R1];
    if (l > 1) {
      #pragma unroll
      for (int r = 1; r < R1; ++r) w1[r] = bl_tw(tw, l, r, k);
    }
    #pragma unroll
    for (int rr = 0; rr < R2; ++rr) {
      float2* a = v + u * S + rr;
      if (l > 1) {
        #pragma unroll
        for (int r = 1; r < R1; ++r) a[r * R2] = cmul(a[r * R2], w1[r]);
      }
      if constexpr (R1 == 2) {
        bl_radix2(a[0], a[R2]);
      } else if constexpr (ZERO_HALF) {
        bl_radix4_half(a[0], a[R2], a[2 * R2], a[3 * R2]);
      } else {
        bl_radix4(a[0], a[R2], a[2 * R2], a[3 * R2]);
      }
    }
    if constexpr (R2 > 1) {
      const int ll = R1 * l;
      #pragma unroll
      for (int q = 0; q < R1; ++q) {
        float2* a = v + u * S + q * R2;
        #pragma unroll
        for (int rr = 1; rr < R2; ++rr)
          a[rr] = cmul(a[rr], bl_tw(tw, ll, rr, q * l + k));
        if constexpr (R2 == 2) {
          bl_radix2(a[0], a[1]);
        } else {
          bl_radix4(a[0], a[1], a[2], a[3]);
        }
      }
    }
  }
}

// The thread's points of a pass of radices (R1, R2) from its frame's
// buffer fb (P = 16 q16 points).
template <int R1, int R2>
__device__ __forceinline__ void bl_read(float2 (&v)[BL_POINTS],
                                        const float2* fb, int i0, int q16) {
  constexpr int S = R1 * R2;
  const int span = q16 * (BL_POINTS / S);           // P / S
  #pragma unroll
  for (int u = 0; u < BL_POINTS / S; ++u) {
    #pragma unroll
    for (int c = 0; c < S; ++c)
      v[u * S + c] = fb[bl_pad(i0 + q16 * u + c * span)];
  }
}

// The outputs of a pass of radices (R1, R2) at l to their points.
template <int R1, int R2>
__device__ __forceinline__ void bl_write(const float2 (&v)[BL_POINTS],
                                         float2* fb, int i0, int q16, int l) {
  constexpr int S = R1 * R2;
  #pragma unroll
  for (int u = 0; u < BL_POINTS / S; ++u) {
    const int i = i0 + q16 * u;
    const int k = i & (l - 1);
    const int base = (i - k) * S + k;
    #pragma unroll
    for (int q = 0; q < R1; ++q) {
      #pragma unroll
      for (int qq = 0; qq < R2; ++qq)
        fb[bl_pad(base + l * (q + R1 * qq))] = v[u * S + q * R2 + qq];
    }
  }
}

// The hand-over: the first FFT's last pass (R1, R2) leaves point p = i0 +
// (P / 16) c', c' = u + (16 / S) (q + R1 q'), in v[u S + q R2 + q']; times
// bhat[p], conjugated, into v[c'], the second FFT's first pass's order.
template <int R1, int R2>
__device__ __forceinline__ void bl_hand_over(float2 (&v)[BL_POINTS], int i0,
                                            int q16,
                                            const float2* __restrict__ bhat) {
  constexpr int S = R1 * R2;
  constexpr int U = BL_POINTS / S;
  float2 t[BL_POINTS];
  #pragma unroll
  for (int u = 0; u < U; ++u) {
    #pragma unroll
    for (int q = 0; q < R1; ++q) {
      #pragma unroll
      for (int qq = 0; qq < R2; ++qq) {
        const int c = u + U * (q + R1 * qq);
        const float2 b =
            cmul(v[u * S + q * R2 + qq], __ldg(bhat + i0 + q16 * c));
        t[c] = make_float2(b.x, -b.y);
      }
    }
  }
  #pragma unroll
  for (int c = 0; c < BL_POINTS; ++c) v[c] = t[c];
}

// The second FFT's last pass (R1, R2): DFT[p] = c[p] conj Q[p] for its
// points p < m (all past P / 2 >= m are never formed), to out[p].
template <int R1, int R2>
__device__ __forceinline__ void bl_out(const float2 (&v)[BL_POINTS],
                                       float2* out, int i0, int q16, int m,
                                       const float2* __restrict__ chirp_t) {
  constexpr int S = R1 * R2;
  constexpr int U = BL_POINTS / S;
  #pragma unroll
  for (int u = 0; u < U; ++u) {
    #pragma unroll
    for (int q = 0; q < R1; ++q) {
      #pragma unroll
      for (int qq = 0; qq < R2; ++qq) {
        if (2 * (q + R1 * qq) >= S) continue;
        const int p = i0 + q16 * (u + U * (q + R1 * qq));
        const float2 z = v[u * S + q * R2 + qq];
        if (p < m)
          out[p] = cmul(make_float2(z.x, -z.y), __ldg(chirp_t + p));
      }
    }
  }
}

// Bluestein's stage whose last pass is (R1, R2), after n_mid passes (4, 4)
// past the first (n_mid < 0: the first pass is the last, P = 16).
template <int R1, int R2, class Load>
__device__ __forceinline__ void bluestein_passes(
    float2* buf, int m, int mp, int n_mid, const FftStage& stage,
    Load& load) {
  const float2* tw = reinterpret_cast<const float2*>(stage.table);
  const float2* chirp_t = tw + mp;
  const int q16 = mp >> 4;
  const int f = bl_frame(mp);
  const int i0 = threadIdx.x - f * q16;
  float2* fb = buf + f * (mp + q16);
  float2 v[BL_POINTS];
  // the first FFT's input z c: points from m up are zero, and so are all
  // of slots 8 to 15 (points past P / 2 >= m)
  #pragma unroll
  for (int c = 0; c < BL_POINTS / 2; ++c) {
    const int n = i0 + q16 * c;
    v[c] = n < m ? cmul(load(f, n), __ldg(chirp_t + n))
                 : make_float2(0.f, 0.f);
  }
  bl_pass<4, 4, true>(v, i0, q16, 1, tw);
  if (n_mid >= 0) {
    __syncthreads();                 // the load's reads of buf are done
    bl_write<4, 4>(v, fb, i0, q16, 1);
    __syncthreads();
    int l = 16;
    for (int s = 0; s < n_mid; ++s, l *= 16) {
      bl_read<4, 4>(v, fb, i0, q16);
      __syncthreads();
      bl_pass<4, 4, false>(v, i0, q16, l, tw);
      bl_write<4, 4>(v, fb, i0, q16, l);
      __syncthreads();
    }
    bl_read<R1, R2>(v, fb, i0, q16);
    __syncthreads();
    bl_pass<R1, R2, false>(v, i0, q16, l, tw);
  }
  bl_hand_over<R1, R2>(v, i0, q16, stage.bhat);
  bl_pass<4, 4, false>(v, i0, q16, 1, tw);
  if (n_mid >= 0) {
    bl_write<4, 4>(v, fb, i0, q16, 1);
    __syncthreads();
    int l = 16;
    for (int s = 0; s < n_mid; ++s, l *= 16) {
      bl_read<4, 4>(v, fb, i0, q16);
      __syncthreads();
      bl_pass<4, 4, false>(v, i0, q16, l, tw);
      bl_write<4, 4>(v, fb, i0, q16, l);
      __syncthreads();
    }
    bl_read<R1, R2>(v, fb, i0, q16);
    bl_pass<R1, R2, false>(v, i0, q16, l, tw);
  }
  __syncthreads();                   // every read of buf is done
  bl_out<R1, R2>(v, buf + f * m, i0, q16, m, chirp_t);
  __syncthreads();
}

// The complex DFT of length m = n_fft / 2 of each of the block's frames by
// Bluestein's chirp-z, for an m with no plan: load(f, n) gives z[n] of
// frame f (n < m), the stage's table holds the twiddles by stage (P - 4
// entries, fft_plan.py:bluestein_table_np) and from entry P the chirp
// c[n], n < m.  The DFT lands at buf + f m, as fft_frames leaves its
// output; buf holds max(1, 4096 / P) frames of P + P / 16 points.  Starts
// with the caller's reads of buf pending (they end at the first barrier)
// and ends with every thread past a barrier.
template <class Load>
__device__ __forceinline__ const float2* bluestein_frames(
    float2* buf, int n_fft, const FftStage& stage, Load load) {
  const int ns = stage.plan.n_stages;
  const bool two = stage.plan.radix[ns - 1] == 2;
  const int rest = ns - two - 2;     // radix-4 stages past the first pass
  const int m = n_fft / 2;
  const int mp = stage.m_pad;
  if (rest % 2) {
    if (two) {
      bluestein_passes<4, 2>(buf, m, mp, rest / 2, stage, load);
    } else {
      bluestein_passes<4, 1>(buf, m, mp, rest / 2, stage, load);
    }
  } else if (two) {
    bluestein_passes<2, 1>(buf, m, mp, rest / 2, stage, load);
  } else {
    bluestein_passes<4, 4>(buf, m, mp, rest / 2 - 1, stage, load);
  }
  return buf;
}
