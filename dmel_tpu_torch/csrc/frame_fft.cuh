// A real FFT of each frame of a block, in shared memory, in fp32, and its
// adjoint; included by framed_fwd.cu (K3 and K5), specband_fwd.cu (K1) and
// framed_bwd.cu (K6) inside their anonymous namespaces.
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
// The plan (the radices in stage order) is decided on the host
// (dmel_tpu_torch/ops/fft_plan.py), checked by fft_plan_from() and passed
// by value.  dmel_tpu_torch/ops/fft_plan.py:rfft_mirror and
// irfft_adjoint_mirror are this arithmetic step by step in PyTorch, held
// to numpy's rfft and irfft by the CPU tests.
//
// On the card the stages are bound by issue and latency, not by bytes or
// flops: each stage is a pass through shared memory and a barrier, with a
// few butterflies a thread in between, so the time follows how many blocks
// an SM keeps resident.  The design keeps a block small (256 threads, 48
// registers, 32 KB of shared memory: 5 blocks an SM) and every index
// update free of integer division in the inner loops.  Keeping pairs of
// radix-4 stages in registers, a shared-memory twiddle table and more
// frames a block each measured slower on the H100 (PERF.md, Findings):
// they cost registers or shared memory, and so resident blocks.

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

inline int fft_frames_per_block(int n_fft) {
  return n_fft >= FFT_BLOCK_POINTS ? 1 : FFT_BLOCK_POINTS / n_fft;
}

inline size_t fft_smem_bytes(int n_fft) {
  return sizeof(float2) * (size_t)fft_frames_per_block(n_fft) * n_fft;
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
