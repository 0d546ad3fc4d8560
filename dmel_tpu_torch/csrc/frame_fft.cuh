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
// 1 (at most 4096): P-point FFT of z c zero-padded, times the FFT of the
// conjugate chirp (built on the host in float64, divided by P and rounded
// once), the inverse FFT (the forward stages on conjugated data, as
// above), times c[k].  Each chirp is entry n^2 mod N of the N-entry table;
// the P-point stages read their own 2P-entry table.  Against numpy's
// float64 rfft the arithmetic errs by 1.0-2.2e-7 of the largest bin at M
// = 7 to 2039 (the direct DFT 0.9-4.9e-7; tests/test_torch_fft.py).
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
// an SM keeps resident.  The design keeps a block small (256 threads, at
// most 64 registers, 32 KB of shared memory: 4-5 blocks an SM; Bluestein's
// at P = 4096 takes 64 KB, 3 blocks an SM) and every index update free of
// integer division in the inner loops.  Keeping pairs of radix-4 stages in
// registers, a shared-memory twiddle table and more frames a block each
// measured slower on the H100 (PERF.md, Findings): they cost registers or
// shared memory, and so resident blocks.

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

// most points of Bluestein's padded FFT: 2 (n_fft / 2) - 1 <= 4095
constexpr int BLUESTEIN_MAX_POINTS = 4096;

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
  return fft_plan_from(radices, n_stages, 2 * m_pad, &stage->plan);
}

inline int fft_frames_per_block(int n_fft) {
  return n_fft >= FFT_BLOCK_POINTS ? 1 : FFT_BLOCK_POINTS / n_fft;
}

inline size_t fft_smem_bytes(int n_fft) {
  return sizeof(float2) * (size_t)fft_frames_per_block(n_fft) * n_fft;
}

// Frames a block and shared bytes a block of a stage: the plan's as above;
// Bluestein's two buffers of m_pad points a frame, max(1, FFT_BLOCK_POINTS
// / (2 m_pad)) frames (32 KB a block, 64 KB at m_pad = 4096)
inline int fft_stage_frames(int n_fft, const FftStage& stage) {
  if (stage.m_pad == 0) return fft_frames_per_block(n_fft);
  return 2 * stage.m_pad >= FFT_BLOCK_POINTS
             ? 1 : FFT_BLOCK_POINTS / (2 * stage.m_pad);
}

inline size_t fft_stage_smem(int n_fft, const FftStage& stage) {
  if (stage.m_pad == 0) return fft_smem_bytes(n_fft);
  return 2 * sizeof(float2) * (size_t)fft_stage_frames(n_fft, stage) *
         stage.m_pad;
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

// The chirp c[n] = exp(-i pi n^2 / m) = W_N^(n^2) (N = n_fft = 2 m, n < m):
// table entry n^2 mod N, an exact integer (n^2 < 2^22).
__device__ __forceinline__ float2 chirp(const float* __restrict__ tab,
                                        int n_fft, int n) {
  return fft_tw(tab, n_fft, n * n % n_fft);
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

// The complex DFT of length m = n_fft / 2 of each of the fr frames in `a`
// by Bluestein's chirp-z, for an m with no plan: `a` holds a[n] = z[n]
// c[n] for n < m and zeros up to M = stage.m_pad (frame f at a + f M), `b`
// is as large.  A = FFT_M(a) (the Stockham stages at the 2M-entry table),
// conj(A bhat) in place, the same stages again to Q, and DFT[k] = c[k]
// conj Q[k] for k < m, written to the buffer Q left free at frame stride
// m, as fft_frames leaves its output.  Returns that buffer; the other one
// is free.  tab is the n_fft-entry table.  Starts and ends with every
// thread past a barrier.
__device__ __forceinline__ float2* bluestein_frames(
    float2* a, float2* b, int fr, int n_fft, const FftStage& stage,
    const float* __restrict__ tab) {
  const int mp = stage.m_pad;
  float2* p = fft_frames(a, b, fr, 2 * mp, stage.plan, stage.table);
  for (int i = threadIdx.x; i < fr * mp; i += FFT_THREADS) {
    const float2 v = cmul(p[i], __ldg(stage.bhat + (i & (mp - 1))));
    p[i] = make_float2(v.x, -v.y);
  }
  float2* o = p == a ? b : a;
  const float2* q = fft_frames(p, o, fr, 2 * mp, stage.plan, stage.table);
  o = q == p ? o : p;             // the buffer the stages left free
  const int m = n_fft / 2;
  for_frame_columns(fr, m, [&](int f, int k) {
    const float2 v = q[f * mp + k];
    o[f * m + k] = cmul(make_float2(v.x, -v.y), chirp(tab, n_fft, k));
  });
  __syncthreads();
  return o;
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

// Bluestein's input (K5): the fr frames of rows row0 .. as fft_load_frames
// loads them, times w, read in pairs z[n] = x[2n] + i x[2n+1] and times
// the chirp c[n] (tab the n-entry table), into `a` at frame stride m_pad,
// zeros from n / 2 up.
__device__ __forceinline__ void bluestein_load_frames(
    float2* a, const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ tab, int row0, int fr, int rows, int sig_len,
    int nfr, int hop, int n, int m_pad) {
  const int m = n / 2;
  int f_src = -1;
  const float* src = x;
  int start = 0;
  for_frame_columns(fr, m_pad, [&](int f, int k) {
    const int r = row0 + f;
    float2 v = make_float2(0.f, 0.f);
    if (k < m && r < rows) {
      if (f != f_src) {
        const int b = r / nfr;
        src = x + (size_t)b * sig_len;
        start = (r - b * nfr) * hop - m;
        f_src = f;
      }
      const int p = start + 2 * k;
      if (p >= 0 && p < sig_len) v.x = __ldg(src + p) * __ldg(w + 2 * k);
      if (p + 1 >= 0 && p + 1 < sig_len)
        v.y = __ldg(src + p + 1) * __ldg(w + 2 * k + 1);
      v = cmul(v, chirp(tab, n, k));
    }
    a[f * m_pad + k] = v;
  });
}
