// Fused STFT for Hopper (sm_90a): kernel K6 of the port, in two routes.
//
// Replaces: audio_algebra_tpu/ops/pallas/stft_kernel.py: pallas_stft (its
// Pallas kernel, launched once per call), which ops/stft.py:stft takes for
// the default window.
//
// Computes, for every signal row r and frame f of the centre-padded row
// (reflect padding of n_fft / 2 when centred):
//   X[r, k, f] = sum_n xpad[r, f * hop + n] * w[n] * exp(-2 pi i k n / n_fft)
// with w the periodic Hann window, k = 0 .. n_fft / 2, all f32, written as
// complex64 in torch's layout (rows, n_bins, F). The framed signal never
// goes to device memory. Both routes read the row with the reflect padding
// done by index math (no padded copy) and take one launch.
//
// The FFT route (aa_stft_fft; n_fft a power of two from 16 to 4096, the
// route of every caller in the port). One block of 512 threads owns 4096
// complex points of shared memory: a tile of 4096 / (n_fft / 2) consecutive
// frames of one row, each taken as the n_fft / 2-point complex sequence
// z[n] = x[2n] + i x[2n+1], windowed. Each frame's complex FFT is a
// mixed-radix Stockham transform (natural order in and out, no bit
// reversal): one radix-2 or radix-4 stage where log2(n_fft / 2) is not a
// multiple of 3, then radix-8 stages, every butterfly in registers (8
// points a thread a stage) and shared memory between stages. The first
// stage reads its points straight from the row, so the framed signal never
// passes through shared memory either. re and im are separate arrays,
// offset by 16 banks, with one padding word every 32 (index a -> a + a /
// 32), so the strided exchanges hit distinct banks. The split into the
// n_fft / 2 + 1 real-signal bins is fused into the store and taken in
// pairs: with A and B the even and odd samples' spectra (from Z[k] and
// conj Z[m - k]), X[k] = A + W^k B and X[m - k] = conj(A - W^k B).
// Consecutive threads take consecutive frames of one bin, so each bin's
// run of the tile is one contiguous store of its output row. The twiddles
// W^j = exp(-2 pi i j / n_fft), j < n_fft, are one device table, computed
// in float64 on the host and rounded once to f32 (no sincosf). Rounding
// error grows like log n_fft, against sqrt(n_fft) for the DFT product, so
// at n_fft >= 256 this route is closer to an exact STFT than the twin.
//
// Bound: bytes. An FFT needs ~5 (n_fft / 2) log2(n_fft / 2) operations a
// frame, far below the signal read once and the complex64 output written
// once: at 32 rows of 65536 samples, 1024 / 256, 42 MB, 0.0126 ms at the
// H100's 3.35 TB/s.
//
// The DFT route (aa_stft; any other n_fft): an implicit GEMM (frames x
// n_fft) @ (n_fft x 2 n_bins) on the CUDA cores in f32. One block per (tile
// of 32 frames, tile of 64 bins, row) stages its frames' span of the row in
// shared memory, builds the windowed A tile and the cos / sin B tiles from
// a zero-padded device table, and each of 128 threads accumulates a 4-frame
// x 4-bin register tile of (re, im) with FMAs in ascending n. Bound: its
// 4 n_fft n_bins operations a frame at the f32 peak.
//
// C interface (bound with ctypes): aa_stft_fft and aa_stft launch on the
// given stream, allocate nothing, do not synchronise, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;        // frames per block
constexpr int BN = 64;        // bins per block
constexpr int BK = 32;        // depth (samples) per chunk
constexpr int TM = 4;         // frames per thread
constexpr int TN = 4;         // bins per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 128
constexpr int AS = BM + 4;    // A tile row stride: 16-byte aligned rows
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int span_floats(int n_fft, int hop) {
  return ((BM - 1) * hop + n_fft + 3) / 4 * 4;
}

__host__ inline size_t smem_bytes(int n_fft, int hop) {
  return sizeof(float) * (static_cast<size_t>(span_floats(n_fft, hop)) + BK * AS + 2 * BK * BN);
}

__global__ void __launch_bounds__(THREADS)
stft_kernel(const float* __restrict__ x, const float* __restrict__ win,
            const float* __restrict__ bases, float2* __restrict__ out, int t_len,
            int n_fft, int hop, int pad, int n_frames, int n_bins, int kp) {
  extern __shared__ float4 smem4[];
  float* span = reinterpret_cast<float*>(smem4);
  const int span_len = span_floats(n_fft, hop);
  float* a_s = span + span_len;               // [BK][AS]: windowed frames, transposed
  float* c_s = a_s + BK * AS;                 // [BK][BN]: cos basis chunk
  float* s_s = c_s + BK * BN;                 // [BK][BN]: sin basis chunk

  const int row = blockIdx.z;
  const int f0 = blockIdx.x * BM;
  const int k0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);             // bin group
  const int ty = tid / (BN / TN);             // frame group

  // stage the padded row's span [f0 * hop, f0 * hop + span_len)
  const float* xr = x + static_cast<size_t>(row) * t_len;
  const long long padded = static_cast<long long>(t_len) + 2 * pad;
  const long long p0 = static_cast<long long>(f0) * hop;
  for (int i = tid; i < span_len; i += THREADS) {
    const long long p = p0 + i;
    float v = 0.0f;
    if (p < padded) {
      long long s = p - pad;
      if (s < 0) s = -s;                                   // reflect, edge excluded
      else if (s >= t_len) s = 2 * static_cast<long long>(t_len - 1) - s;
      v = __ldg(xr + s);
    }
    span[i] = v;
  }

  const float* cos_b = bases;
  const float* sin_b = bases + static_cast<size_t>(n_fft) * kp;
  float acc_re[TM][TN], acc_im[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_re[i][j] = acc_im[i][j] = 0.0f;

  for (int n0 = 0; n0 < n_fft; n0 += BK) {
    __syncthreads();                 // span staged / last chunk's tiles read
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int f = i / BK, kk = i - f * BK, n = n0 + kk;
      a_s[kk * AS + f] = n < n_fft ? span[f * hop + n] * __ldg(win + n) : 0.0f;
    }
    for (int i = tid; i < BK * (BN / 4); i += THREADS) {
      const int kk = i / (BN / 4), c4 = i - kk * (BN / 4), n = n0 + kk;
      float4 cv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sv = cv;
      if (n < n_fft) {
        const size_t off = static_cast<size_t>(n) * kp + k0 + 4 * c4;
        cv = __ldg(reinterpret_cast<const float4*>(cos_b + off));
        sv = __ldg(reinterpret_cast<const float4*>(sin_b + off));
      }
      reinterpret_cast<float4*>(c_s + kk * BN)[c4] = cv;
      reinterpret_cast<float4*>(s_s + kk * BN)[c4] = sv;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(a_s + kk * AS + ty * TM);
      const float4 c = *reinterpret_cast<const float4*>(c_s + kk * BN + tx * TN);
      const float4 s = *reinterpret_cast<const float4*>(s_s + kk * BN + tx * TN);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float cv[TN] = {c.x, c.y, c.z, c.w};
      const float sv[TN] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_re[i][j] = fmaf(av[i], cv[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(av[i], sv[j], acc_im[i][j]);
        }
    }
  }

  // (re, im) into (rows, n_bins, F): 4 consecutive frames per bin
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int k = k0 + tx * TN + j;
    if (k >= n_bins) continue;
    float2* o = out + (static_cast<size_t>(row) * n_bins + k) * n_frames;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int f = f0 + ty * TM + i;
      if (f < n_frames) o[f] = make_float2(acc_re[i][j], acc_im[i][j]);
    }
  }
}

// ------------------------------------------------------------------ FFT ---
constexpr int FFT_THREADS = 512;
constexpr int FFT_POINTS = 4096;                   // complex points a block
constexpr int FFT_LOG_POINTS = 12;
constexpr int FFT_PADDED = FFT_POINTS + FFT_POINTS / 32;
constexpr float kSqrtHalf = 0.70710678118654752f;

__device__ __forceinline__ int padded(int a) { return a + (a >> 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = make_float2(t.x + b.x, t.y + b.y);
  b = make_float2(t.x - b.x, t.y - b.y);
}

// In-place forward DFT of 4 points, natural order.
__device__ __forceinline__ void dft4(float2& u0, float2& u1, float2& u2, float2& u3) {
  dft2(u0, u2);                                    // u0 = t0, u2 = t1
  dft2(u1, u3);                                    // u1 = t2, u3 = u1 - u3
  u3 = make_float2(u3.y, -u3.x);                   // t3 = -i (u1 - u3)
  dft2(u0, u1);                                    // y0 = t0 + t2, y2 = t0 - t2
  dft2(u2, u3);                                    // y1 = t1 + t3, y3 = t1 - t3
  const float2 y1 = u2, y2 = u1;
  u1 = y1;
  u2 = y2;
}

template <int R> __device__ __forceinline__ void dft(float2 (&u)[R]);

template <> __device__ __forceinline__ void dft<2>(float2 (&u)[2]) { dft2(u[0], u[1]); }

template <> __device__ __forceinline__ void dft<4>(float2 (&u)[4]) {
  dft4(u[0], u[1], u[2], u[3]);
}

// Radix 8: the even and odd points' 4-point DFTs, combined with W8^j.
template <> __device__ __forceinline__ void dft<8>(float2 (&u)[8]) {
  dft4(u[0], u[2], u[4], u[6]);
  dft4(u[1], u[3], u[5], u[7]);
  const float2 o1 = u[3], o2 = u[5], o3 = u[7];
  u[3] = make_float2(kSqrtHalf * (o1.x + o1.y), kSqrtHalf * (o1.y - o1.x));      // W8
  u[5] = make_float2(o2.y, -o2.x);                                               // W8^2
  u[7] = make_float2(kSqrtHalf * (o3.y - o3.x), -kSqrtHalf * (o3.x + o3.y));     // W8^3
  // E_j in u[0], u[2], u[4], u[6]; W8^j O_j in u[1], u[3], u[5], u[7]
  float2 y[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 e = u[2 * j], o = u[2 * j + 1];
    y[j] = make_float2(e.x + o.x, e.y + o.y);
    y[j + 4] = make_float2(e.x - o.x, e.y - o.y);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) u[j] = y[j];
}

template <int R> struct Log2;
template <> struct Log2<2> { static constexpr int v = 1; };
template <> struct Log2<4> { static constexpr int v = 2; };
template <> struct Log2<8> { static constexpr int v = 3; };

// The tile's frames as the input of the first stage: point n2 of frame f
// is x[2 n2] + i x[2 n2 + 1] of the frame, windowed, read from the row with
// the reflect padding done by index math (zero past the last frame).
struct FrameSource {
  const float* xr;
  const float2* win2;
  int t_len, hop, pad, f0, n_frames;

  __device__ __forceinline__ int reflect(int p) const {
    return p < 0 ? -p : (p >= t_len ? 2 * (t_len - 1) - p : p);
  }

  __device__ __forceinline__ float2 load(int f, int n2) const {
    if (f0 + f >= n_frames) return make_float2(0.0f, 0.0f);
    const int p = (f0 + f) * hop + 2 * n2 - pad;
    float a, b;
    if (p >= 0 && p + 1 < t_len) {
      a = __ldg(xr + p);
      b = __ldg(xr + p + 1);
    } else {
      a = __ldg(xr + reflect(p));
      b = __ldg(xr + reflect(p + 1));
    }
    const float2 w = __ldg(win2 + n2);
    return make_float2(a * w.x, b * w.y);
  }
};

// One radix-R Stockham stage over every frame of the block: after the
// stages before it (the product of their radices is p), butterfly i of a
// frame (i < m / R, k = i mod p) reads points i + r m / R, multiplies point
// r by W_m^(r k m / (p R)) = tw[2 r k m / (p R)], and writes its DFT to
// (i - k) R + k + r p. The first stage (p = 1) reads its points from the
// row (`src`); the others read shared memory, then a barrier. A barrier
// ends each stage.
template <int R, bool kFirst>
__device__ __forceinline__ void fft_stage(float* re, float* im, const float2* __restrict__ tw,
                                          int log_m, int p, const FrameSource& src) {
  constexpr int PER = FFT_POINTS / (R * FFT_THREADS);       // butterflies a thread
  const int log_q = log_m - Log2<R>::v;
  const int q = 1 << log_q;
  const int step = (2 << log_m) / (p * R);
  float2 u[PER][R];
  int frame0[PER], idx[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int bf = threadIdx.x + j * FFT_THREADS;
    idx[j] = bf & (q - 1);
    frame0[j] = (bf >> log_q) << log_m;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (kFirst) {
        u[j][r] = src.load(bf >> log_q, idx[j] + r * q);
      } else {
        const int a = padded(frame0[j] + idx[j] + r * q);
        u[j][r] = make_float2(re[a], im[a]);
      }
    }
  }
  if constexpr (!kFirst) __syncthreads();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int k = idx[j] & (p - 1);
    if (p > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) u[j][r] = cmul(u[j][r], __ldg(tw + r * k * step));
    }
    dft<R>(u[j]);
    const int out0 = frame0[j] + (idx[j] - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = padded(out0 + r * p);
      re[a] = u[j][r].x;
      im[a] = u[j][r].y;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(FFT_THREADS)
stft_fft_kernel(const float* __restrict__ x, const float* __restrict__ win,
                const float2* __restrict__ tw, float2* __restrict__ out, int t_len,
                int log_n, int hop, int pad, int n_frames) {
  __shared__ float smem[2 * FFT_PADDED + 16];
  float* re = smem;
  float* im = smem + FFT_PADDED + 16;              // 16 banks from re
  const int log_m = log_n - 1, m = 1 << log_m;
  const int log_frames = FFT_LOG_POINTS - log_m;
  const int frames = 1 << log_frames;
  const int row = blockIdx.y;
  const int f0 = blockIdx.x * frames;
  const FrameSource src{x + static_cast<size_t>(row) * t_len,
                        reinterpret_cast<const float2*>(win), t_len, hop, pad, f0, n_frames};

  int p;
  if (log_m % 3 == 1) {
    fft_stage<2, true>(re, im, tw, log_m, 1, src);
    p = 2;
  } else if (log_m % 3 == 2) {
    fft_stage<4, true>(re, im, tw, log_m, 1, src);
    p = 4;
  } else {
    fft_stage<8, true>(re, im, tw, log_m, 1, src);
    p = 8;
  }
  for (; p < m; p *= 8) fft_stage<8, false>(re, im, tw, log_m, p, src);

  // the real signal's bins, in pairs: with A = (Z[k] + conj Z[m - k]) / 2
  // and B = -i (Z[k] - conj Z[m - k]) / 2 (indices mod m), X[k] = A + W^k B
  // and X[m - k] = conj(A - W^k B)
  const int n_bins = m + 1;
  float2* out_row = out + static_cast<size_t>(row) * n_bins * n_frames + f0;
  for (int i = threadIdx.x; i < ((m >> 1) + 1) * frames; i += FFT_THREADS) {
    const int f = i & (frames - 1), k = i >> log_frames;
    if (f0 + f >= n_frames) continue;
    const int a = padded((f << log_m) + (k & (m - 1)));
    const int b = padded((f << log_m) + ((m - k) & (m - 1)));
    const float zr = re[a], zi = im[a], cr = re[b], ci = -im[b];
    const float ar = 0.5f * (zr + cr), ai = 0.5f * (zi + ci);
    const float br = 0.5f * (zi - ci), bi = -0.5f * (zr - cr);
    const float2 w = __ldg(tw + k);
    const float wbr = w.x * br - w.y * bi, wbi = w.x * bi + w.y * br;
    out_row[static_cast<size_t>(k) * n_frames + f] = make_float2(ar + wbr, ai + wbi);
    if (2 * k != m)
      out_row[static_cast<size_t>(m - k) * n_frames + f] = make_float2(ar - wbr, wbi - ai);
  }
}

}  // namespace

// Shared memory one block needs at (n_fft, hop), in bytes: the wrapper
// refuses shapes above the card's 227 KB per block.
extern "C" long long aa_stft_smem_bytes(int n_fft, int hop) {
  return static_cast<long long>(smem_bytes(n_fft, hop));
}

// x: (rows, t_len) f32, contiguous. win: (n_fft,) f32. bases: [2][n_fft][kp]
// f32 (cos then sin; columns >= n_bins zero; kp a multiple of 64). out:
// (rows, n_bins, n_frames) complex64. pad: n_fft / 2 when centred, else 0
// (must be < t_len). Returns cudaGetLastError().
extern "C" int aa_stft(const void* x, const void* win, const void* bases, void* out,
                       int rows, int t_len, int n_fft, int hop, int pad, int n_frames,
                       int n_bins, int kp, void* stream) {
  if (rows <= 0 || rows > 65535 || n_fft <= 0 || hop <= 0 || n_frames <= 0 ||
      kp % BN != 0 || kp < n_bins || pad >= t_len)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n_fft, hop);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_frames + BM - 1) / BM, kp / BN, rows);
  stft_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float*>(bases), static_cast<float2*>(out), t_len, n_fft, hop, pad,
      n_frames, n_bins, kp);
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, t_len) f32, contiguous. win: (n_fft,) f32. tw: (n_fft,) complex
// f32, tw[j] = exp(-2 pi i j / n_fft). out: (rows, n_fft / 2 + 1, n_frames)
// complex64. n_fft a power of two from 16 to 4096; pad: n_fft / 2 when
// centred, else 0 (must be < t_len). Returns cudaGetLastError().
extern "C" int aa_stft_fft(const void* x, const void* win, const void* tw, void* out,
                           int rows, int t_len, int n_fft, int hop, int pad, int n_frames,
                           void* stream) {
  int log_n = 0;
  while ((1 << log_n) < n_fft) ++log_n;
  if (rows <= 0 || rows > 65535 || (1 << log_n) != n_fft || log_n < 4 ||
      log_n > FFT_LOG_POINTS || hop <= 0 || n_frames <= 0 || pad >= t_len ||
      static_cast<long long>(t_len) + 2 * pad >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int frames = FFT_POINTS / (n_fft / 2);
  const dim3 grid((n_frames + frames - 1) / frames, rows);
  stft_fft_kernel<<<grid, FFT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<float2*>(out), t_len, log_n, hop, pad,
      n_frames);
  return static_cast<int>(cudaGetLastError());
}
