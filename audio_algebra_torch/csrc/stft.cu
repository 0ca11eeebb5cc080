// Fused STFT for Hopper (sm_90a): kernel K6 of the port, in four routes.
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
// goes to device memory. Every route reads the row with the reflect padding
// done by index math (no padded copy), place any number of rows on the
// grid and take one launch. The padding is numpy's mode="reflect" at any
// pad: a row no longer than the pad n_fft / 2 reflects as often as it
// needs (reflect_index), a one-sample row repeats its sample. Such rows
// take their own instance of each kernel (kFold, chosen on the host), so
// the instance every longer row runs keeps the one-reflection index math.
//
// The routes, by the plan of ops/stft_kernel.py: an even n_fft from 16 to
// 8192 whose half m = n_fft / 2 has no prime factor above 13 takes the FFT
// route; any other n_fft from 16 takes an L-point DFT (L = m of the packed
// samples, or n_fft when odd, two frames packed a transform) as an M-point
// power-of-two FFT, M = L where L is a power of two, else by Bluestein's
// chirp-z transform with M >= 2 L - 1: the chirp route where M <= 4096 (one
// block), the cluster route where M <= 65536 (M / 4096 CTAs a frame; 8192's
// 4096 points too, four frames a cluster). An even n_fft above 8192 whose
// 13-smooth half m splits into F = 2 or 4 parts of at most 4096 points
// takes the cluster route's mixed-radix instance: F parts of m / F points,
// no chirp. n_fft below 16 and larger frames take the DFT product.
//
// The FFT route (aa_stft_fft). One block of 512 threads owns 4096 complex points of
// shared memory: a tile of floor(4096 / m) consecutive frames of one row,
// each taken as the m-point complex sequence z[n] = x[2n] + i x[2n+1],
// windowed. Each frame's complex FFT is a mixed-radix Stockham transform
// (natural order in and out, no bit reversal) whose radices the host's
// planner passes: for the power-of-two part of m one radix-2 or radix-4
// stage where its log2 is not a multiple of 3, then radix-8 stages; then one
// stage for each odd prime factor (3, 5, 7, 11, 13, ascending). Every
// butterfly runs in registers, shared memory between stages; the odd ones
// pair points n and R - n, so a radix-R butterfly takes (R - 1)^2 / 2 real
// FMAs a component with its roots as constants. The first stage reads its
// points straight from the row, so the framed signal never passes through
// shared memory either. Two kernels: a power-of-two plan
// (stft_fft_kernel) runs in place in one 4096-point buffer, each thread's
// 4096 / (512 R) butterflies held in registers across the barrier that
// parts a stage's reads from its writes (40 registers: three blocks an SM);
// a plan with odd radices (stft_fft_mixed_kernel) deals its frames * m / R
// butterflies to the threads one at a time and reads one buffer while it
// writes the other (dynamic shared memory, 67.7 KB), so one butterfly alone
// is held in registers, and divides its indices by multiply-highs; plans up
// to radix 8 take an instance without the radix-11 and 13 stages, which
// would spill it (both at 64 registers, two blocks an SM). re and im
// are separate arrays, offset by 16 banks, with one padding word every 32
// (index a -> a + a / 32), so the strided exchanges of the power-of-two
// stages hit distinct banks. The split into the m + 1 real-signal bins is
// fused into the store and taken in pairs: with A and B the even and odd
// samples' spectra (from Z[k] and conj Z[m - k]), X[k] = A + W^k B and
// X[m - k] = conj(A - W^k B). Consecutive threads take consecutive frames
// of one bin, so each bin's run of the tile is one contiguous store of its
// output row. The twiddles W^j = exp(-2 pi i j / n_fft), j < n_fft, are one
// device table, computed in float64 on the host and rounded once to f32
// (no sincosf). Rounding error grows like log n_fft, against sqrt(n_fft)
// for the DFT product, so at n_fft >= 256 this route is closer to an exact
// STFT than the twin.
//
// Bound: bytes. An FFT needs ~5 (n_fft / 2) log2(n_fft / 2) operations a
// frame, far below the signal read once and the complex64 output written
// once: at 32 rows of 65536 samples, 1024 / 256, 42 MB, 0.0126 ms at the
// H100's 3.35 TB/s.
//
// The chirp route (aa_stft_chirp) and the cluster route (aa_stft_cluster):
// see "chirp-z" and "cluster" below. Both run the FFT route's power-of-two
// Stockham stages (in place, radix 2 or 4, then 8), read the row as it does
// and store four consecutive frames of a bin together where a block or a
// cluster holds four (the chirp route: 4096 / M transforms a block). Same
// bound as the FFT route.
//
// The DFT route (aa_stft; n_fft below 16, and frames beyond the cluster
// route's 65536 points): an implicit GEMM (frames x n_fft) @ (n_fft x
// 2 n_bins) on the CUDA cores in f32. One block per (tile of 32 frames,
// row) and tile of 64 bins builds the windowed A tile of each 32-sample
// chunk straight from the row (through L1 and L2, so no frame span has to
// fit shared memory; the next chunk's tile is read into registers while
// this one's products run) and the cos / sin B tiles from a zero-padded
// device table, and each of 128 threads accumulates a 4-frame x 4-bin
// register tile of (re, im) with FMAs in ascending n. Bound: its 4 n_fft
// n_bins operations a frame at the f32 peak.
//
// C interface (bound with ctypes): aa_stft_fft, aa_stft_chirp,
// aa_stft_cluster, aa_stft_cluster_mixed and aa_stft launch on the given
// stream, allocate nothing,
// do not synchronise, and return the launch's error or cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Sample s of a row of t_len samples reflect-padded (edge excluded) as far
// as s lies. kFold = false: one reflection, which covers s in [-(t_len - 1),
// 2 (t_len - 1)], every index of a row longer than the pad. kFold = true:
// reflected at 0 and at t_len - 1 until s lands in the row, numpy's
// mode="reflect" at any pad (the padded row is periodic with period
// 2 (t_len - 1)); a row of one sample is that sample everywhere. One
// instance for both, with a modulo on the out-of-range branch, took the
// power-of-two FFT kernel from 40 to 44 registers (its third block an SM)
// and 10-20 % of its time, though no index of a long row reaches it.
template <bool kFold, typename I>
__device__ __forceinline__ I reflect_index(I s, I t_len) {
  if constexpr (kFold) {
    if (t_len == 1) return 0;
    const I last = t_len - 1;
    while (s < 0 || s > last) s = s < 0 ? -s : 2 * last - s;
    return s;
  } else {
    return s < 0 ? -s : (s >= t_len ? 2 * (t_len - 1) - s : s);
  }
}

constexpr int BM = 32;        // frames per block
constexpr int BN = 64;        // bins per block
constexpr int BK = 32;        // depth (samples) per chunk
constexpr int TM = 4;         // frames per thread
constexpr int TN = 4;         // bins per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 128
constexpr int AS = BM + 4;    // A tile row stride: 16-byte aligned rows

template <bool kFold>
__global__ void __launch_bounds__(THREADS)
stft_kernel(const float* __restrict__ x, const float* __restrict__ win,
            const float* __restrict__ bases, float2* __restrict__ out, int t_len,
            int n_fft, int hop, int pad, int n_frames, int n_bins, int kp, int tiles) {
  __shared__ __align__(16) float a_s[BK * AS];    // windowed frames, transposed
  __shared__ __align__(16) float c_s[BK * BN];    // cos basis chunk
  __shared__ __align__(16) float s_s[BK * BN];    // sin basis chunk

  const int row = blockIdx.x / tiles;
  const int f0 = (blockIdx.x - row * tiles) * BM;
  const int k0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);             // bin group
  const int ty = tid / (BN / TN);             // frame group

  const float* xr = x + static_cast<size_t>(row) * t_len;
  const long long padded = static_cast<long long>(t_len) + 2 * pad;
  const float* cos_b = bases;
  const float* sin_b = bases + static_cast<size_t>(n_fft) * kp;
  float acc_re[TM][TN], acc_im[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_re[i][j] = acc_im[i][j] = 0.0f;

  // the next chunk's A tile is read into registers while this one's
  // products run, so a small grid does not wait on the row between chunks
  // (the B tiles too would take 168 registers and slow a full grid)
  constexpr int A_PER = BM * BK / THREADS;          // 8 points a thread
  constexpr int B_PER = BK * (BN / 4) / THREADS;    // 4 float4 of each basis
  static_assert(A_PER * THREADS == BM * BK && B_PER * THREADS == BK * (BN / 4), "whole tiles");
  float a_r[A_PER];
  auto load = [&](int n0) {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      // point n of frame f0 + f of the padded row, zero past its end; a
      // warp reads 32 consecutive samples of one frame
      const int i = tid + q * THREADS, f = i / BK, n = n0 + (i - f * BK);
      const long long p = static_cast<long long>(f0 + f) * hop + n;
      float v = 0.0f;
      if (n < n_fft && p < padded) {
        const long long s = reflect_index<kFold, long long>(p - pad, t_len);
        v = __ldg(xr + s) * __ldg(win + n);
      }
      a_r[q] = v;
    }
  };

  load(0);
  for (int n0 = 0; n0 < n_fft; n0 += BK) {
    __syncthreads();                 // the last chunk's tiles read
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int i = tid + q * THREADS, f = i / BK;
      a_s[(i - f * BK) * AS + f] = a_r[q];
    }
#pragma unroll
    for (int q = 0; q < B_PER; ++q) {
      const int i = tid + q * THREADS, kk = i / (BN / 4), c4 = i - kk * (BN / 4);
      const int n = n0 + kk;
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
    if (n0 + BK < n_fft) load(n0 + BK);
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
constexpr int FFT_PADDED = FFT_POINTS + FFT_POINTS / 32;
constexpr int FFT_LOG_POINTS = 12;
constexpr int FFT_BUFFER = 2 * FFT_PADDED + 16;   // re, then im 16 banks on
constexpr int FFT_MIXED_SMEM_BYTES = 2 * FFT_BUFFER * static_cast<int>(sizeof(float));
constexpr int FFT_MAX_STAGES = 12;                 // 3^7 = 2187 takes 7; 4 bits each
constexpr float kSqrtHalf = 0.70710678118654752f;

__device__ __forceinline__ int padded(int a) { return a + (a >> 5); }

// a / d for 0 <= a < 2^13 and 1 <= d <= 4096 as a multiply-high by
// ceil(2^32 / d): exact, since a (ceil(2^32 / d) d - 2^32) < 2^13 d < 2^32.
// The double quotient rounds to within 2^-21 of 2^32 / d, whose fraction is
// 0 or at least 1 / d, so its ceiling is exact.
struct Divisor {
  int d;
  unsigned magic;
  __device__ __forceinline__ explicit Divisor(int d_)
      : d(d_), magic(d_ == 1 ? 0u : static_cast<unsigned>(ceil(4294967296.0 / d_))) {}
  __device__ __forceinline__ int div(int a) const {
    return d == 1 ? a : static_cast<int>(__umulhi(static_cast<unsigned>(a), magic));
  }
};

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

// cos and sin of 2 pi j / R, j = 1 .. (R - 1) / 2, rounded to f32.
template <int R> __device__ __forceinline__ void odd_roots(float* c, float* s);

template <> __device__ __forceinline__ void odd_roots<3>(float* c, float* s) {
  c[0] = -0.5f;
  s[0] = 0.8660254f;
}

template <> __device__ __forceinline__ void odd_roots<5>(float* c, float* s) {
  c[0] = 0.309017f;  c[1] = -0.809017f;
  s[0] = 0.95105654f; s[1] = 0.58778524f;
}

template <> __device__ __forceinline__ void odd_roots<7>(float* c, float* s) {
  c[0] = 0.6234898f; c[1] = -0.22252093f; c[2] = -0.90096885f;
  s[0] = 0.7818315f; s[1] = 0.9749279f;   s[2] = 0.43388373f;
}

template <> __device__ __forceinline__ void odd_roots<11>(float* c, float* s) {
  c[0] = 0.8412535f;  c[1] = 0.41541502f; c[2] = -0.14231484f; c[3] = -0.65486073f;
  c[4] = -0.959493f;
  s[0] = 0.54064083f; s[1] = 0.90963197f; s[2] = 0.98982143f;  s[3] = 0.7557496f;
  s[4] = 0.28173256f;
}

template <> __device__ __forceinline__ void odd_roots<13>(float* c, float* s) {
  c[0] = 0.885456f;   c[1] = 0.56806475f; c[2] = 0.12053668f; c[3] = -0.3546049f;
  c[4] = -0.7485108f; c[5] = -0.97094184f;
  s[0] = 0.46472317f; s[1] = 0.82298386f; s[2] = 0.99270886f; s[3] = 0.9350162f;
  s[4] = 0.66312265f; s[5] = 0.23931566f;
}

// In-place forward DFT of an odd prime number R of points, natural order:
// with t+_n = u[n] + u[R - n], t-_n = u[n] - u[R - n] and theta = 2 pi n k
// / R, y[k] = a - i b and y[R - k] = a + i b, a = u[0] + sum_n t+_n cos
// theta, b = sum_n t-_n sin theta (n, k = 1 .. (R - 1) / 2). Every index
// is a constant once the loops unroll, so the roots are immediates.
template <int R>
__device__ __forceinline__ void dft_odd(float2 (&u)[R]) {
  static_assert(R == 3 || R == 5 || R == 7 || R == 11 || R == 13, "an odd prime radix");
  constexpr int H = (R - 1) / 2;
  float c[H], s[H];
  odd_roots<R>(c, s);
  float2 tp[H], tm[H];
#pragma unroll
  for (int n = 1; n <= H; ++n) {
    tp[n - 1] = make_float2(u[n].x + u[R - n].x, u[n].y + u[R - n].y);
    tm[n - 1] = make_float2(u[n].x - u[R - n].x, u[n].y - u[R - n].y);
  }
  float2 y0 = u[0];
#pragma unroll
  for (int n = 0; n < H; ++n) y0 = make_float2(y0.x + tp[n].x, y0.y + tp[n].y);
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 a = u[0], b = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int n = 1; n <= H; ++n) {
      const int j = (n * k) % R;                   // theta = 2 pi j / R
      const int jj = j <= H ? j : R - j;
      const float cj = c[jj - 1], sj = j <= H ? s[jj - 1] : -s[jj - 1];
      a = make_float2(fmaf(tp[n - 1].x, cj, a.x), fmaf(tp[n - 1].y, cj, a.y));
      b = make_float2(fmaf(tm[n - 1].x, sj, b.x), fmaf(tm[n - 1].y, sj, b.y));
    }
    u[k] = make_float2(a.x + b.y, a.y - b.x);      // a - i b
    u[R - k] = make_float2(a.x - b.y, a.y + b.x);  // a + i b
  }
  u[0] = y0;
}

template <int R> __device__ __forceinline__ void dft(float2 (&u)[R]) { dft_odd<R>(u); }

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

// The tile's frames as the input of the first stage: point n2 of frame f
// is x[2 n2] + i x[2 n2 + 1] of the frame, windowed, read from the row with
// the reflect padding done by index math (zero past the last frame).
template <bool kFold>
struct FrameSource {
  const float* xr;
  const float2* win2;
  int t_len, hop, pad, f0, n_frames;

  __device__ __forceinline__ int reflect(int p) const { return reflect_index<kFold>(p, t_len); }

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

// Where the tile sits: frame tile blockIdx.x of row blockIdx.y + blockIdx.z
// * gridDim.y (rows past 65,535 go to grid.z); false past the last row.
__device__ __forceinline__ bool tile_of(int rows, int& row) {
  row = blockIdx.y + blockIdx.z * gridDim.y;
  return row < rows;
}

// The real signal's bins from the m-point spectra Z of a tile's frames (in
// zre / zim, frame f at f * m), in pairs: with A = (Z[k] + conj Z[m - k]) / 2
// and B = -i (Z[k] - conj Z[m - k]) / 2 (indices mod m), X[k] = A + W^k B
// and X[m - k] = conj(A - W^k B). Item i is bin k = i / frames of frame i
// mod frames, so consecutive threads store consecutive frames of one bin.
template <typename Div>
__device__ __forceinline__ void real_split(const float* zre, const float* zim,
                                           const float2* __restrict__ tw,
                                           float2* __restrict__ out_row, int m, int frames,
                                           const Div& by_frames, int f0, int n_frames) {
  for (int i = threadIdx.x; i < ((m >> 1) + 1) * frames; i += FFT_THREADS) {
    const int k = by_frames.div(i), f = i - k * frames;
    if (f0 + f >= n_frames) continue;
    const int a = padded(f * m + k);
    const int b = padded(f * m + (k == 0 ? 0 : m - k));
    const float zr = zre[a], zi = zim[a], cr = zre[b], ci = -zim[b];
    const float ar = 0.5f * (zr + cr), ai = 0.5f * (zi + ci);
    const float br = 0.5f * (zi - ci), bi = -0.5f * (zr - cr);
    const float2 w = __ldg(tw + k);
    const float wbr = w.x * br - w.y * bi, wbi = w.x * bi + w.y * br;
    out_row[static_cast<size_t>(k) * n_frames + f] = make_float2(ar + wbr, ai + wbi);
    if (2 * k != m)
      out_row[static_cast<size_t>(m - k) * n_frames + f] = make_float2(ar - wbr, wbi - ai);
  }
}

struct Shift {                                     // a power-of-two divisor
  int log_d;
  __device__ __forceinline__ int div(int a) const { return a >> log_d; }
};

template <int R> struct Log2;
template <> struct Log2<2> { static constexpr int v = 1; };
template <> struct Log2<4> { static constexpr int v = 2; };
template <> struct Log2<8> { static constexpr int v = 3; };

// A power-of-two plan. One radix-R Stockham stage over every frame of the
// block, in place: after the stages before it (the product of their radices
// is p), butterfly i of a frame (i < m / R, k = i mod p) reads points i + r
// m / R, multiplies point r by W_m^(r k m / (p R)) = tw[2 r k m / (p R)],
// and writes its DFT to (i - k) R + k + r p. The block's kPoints points
// (4096; the cluster route's 16384) give each thread kPoints / (512 R)
// butterflies, all held in registers across the
// barrier that parts the stage's reads from its writes. The first stage
// (p = 1) reads its points from the row (`src`); the others read shared
// memory, then a barrier. A barrier ends each stage.
template <int R, bool kFirst, int kPoints = FFT_POINTS, typename Source>
__device__ __forceinline__ void fft_stage(float* re, float* im, const float2* __restrict__ tw,
                                          int log_m, int p, const Source& src) {
  constexpr int PER = kPoints / (R * FFT_THREADS);          // butterflies a thread
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

// A power-of-two plan (m = 2^log_m, 8 to 4096): its first radix (2, 4 or
// 8), then radix-8 stages, in one 4096-point buffer.
template <bool kFold>
__global__ void __launch_bounds__(FFT_THREADS)
stft_fft_kernel(const float* __restrict__ x, const float* __restrict__ win,
                const float2* __restrict__ tw, float2* __restrict__ out, int t_len,
                int rows, int log_m, int first, int hop, int pad, int n_frames) {
  __shared__ float smem[FFT_BUFFER];
  float* re = smem;
  float* im = smem + FFT_PADDED + 16;              // 16 banks from re
  const int m = 1 << log_m;
  const int log_frames = FFT_LOG_POINTS - log_m;
  const int frames = 1 << log_frames;
  int row;
  if (!tile_of(rows, row)) return;
  const int f0 = blockIdx.x * frames;
  const FrameSource<kFold> src{x + static_cast<size_t>(row) * t_len,
                               reinterpret_cast<const float2*>(win), t_len, hop, pad, f0,
                               n_frames};

  int p;
  if (first == 2) {
    fft_stage<2, true>(re, im, tw, log_m, 1, src);
    p = 2;
  } else if (first == 4) {
    fft_stage<4, true>(re, im, tw, log_m, 1, src);
    p = 4;
  } else {
    fft_stage<8, true>(re, im, tw, log_m, 1, src);
    p = 8;
  }
  for (; p < m; p *= 8) fft_stage<8, false>(re, im, tw, log_m, p, src);
  real_split(re, im, tw, out + static_cast<size_t>(row) * (m + 1) * n_frames + f0, m, frames,
             Shift{log_frames}, f0, n_frames);
}

// A plan with odd radices. One radix-R Stockham stage as above, over points
// = frames x m (frames = floor(4096 / m)), with q = m / R and twiddle
// tw[r k n_fft / (p R)]; its frames * m / R butterflies are dealt to the
// threads one at a time (t, t + 512, ...), and the stage reads one buffer
// (the first stage the row) and writes the other, so no barrier parts its
// reads from its writes and one butterfly alone is held in registers. q, p
// and the frame index are divided by multiply-highs. A barrier ends each
// stage.
template <int R, bool kFirst, typename Source>
__device__ __forceinline__ void fft_stage_mixed(const float* re_in, const float* im_in,
                                                float* re_out, float* im_out,
                                                const float2* __restrict__ tw, int n_fft,
                                                int points, int p, const Source& src) {
  const int m = n_fft >> 1;
  const int q = m / R;
  const int step = n_fft / (p * R);
  const Divisor by_q(q), by_p(p);
  for (int bf = threadIdx.x; bf < points / R; bf += FFT_THREADS) {
    const int f = by_q.div(bf);
    const int i = bf - f * q;
    const int k = i - by_p.div(i) * p;
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (kFirst) {
        u[r] = src.load(f, i + r * q);
      } else {
        const int a = padded(f * m + i + r * q);
        u[r] = make_float2(re_in[a], im_in[a]);
      }
    }
    if (p > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) u[r] = cmul(u[r], __ldg(tw + r * k * step));
    }
    dft<R>(u);
    const int out0 = f * m + (i - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = padded(out0 + r * p);
      re_out[a] = u[r].x;
      im_out[a] = u[r].y;
    }
  }
  __syncthreads();
}

// The plan's radices, 4 bits each, first stage in the lowest bits.
__device__ __forceinline__ int radix_of(unsigned long long radices, int s) {
  return static_cast<int>((radices >> (4 * s)) & 15);
}

// A plan with odd radices (m = n_fft / 2 up to 4096, 13-smooth): stage s
// reads buffer (s + 1) % 2 of the dynamic shared memory and writes buffer s
// % 2. kLarge: the plan holds 11 or 13; a plan of radices up to 8 takes the
// instance without those stages. Both at 64 registers, two blocks an SM
// (the large one spills 96 bytes there, and runs 30 % faster than at its
// own 112 registers and one block).
template <bool kLarge, bool kFold>
__global__ void __launch_bounds__(FFT_THREADS, 2)
stft_fft_mixed_kernel(const float* __restrict__ x, const float* __restrict__ win,
                      const float2* __restrict__ tw, float2* __restrict__ out, int t_len,
                      int rows, int n_fft, unsigned long long radices, int n_stages, int hop,
                      int pad, int n_frames) {
  extern __shared__ float smem[];                  // FFT_MIXED_SMEM_BYTES: two buffers
  float* re[2] = {smem, smem + FFT_BUFFER};
  float* im[2] = {smem + FFT_PADDED + 16, smem + FFT_BUFFER + FFT_PADDED + 16};
  const int m = n_fft >> 1;
  const int frames = FFT_POINTS / m;
  const int points = frames * m;
  int row;
  if (!tile_of(rows, row)) return;
  const int f0 = blockIdx.x * frames;
  const FrameSource<kFold> src{x + static_cast<size_t>(row) * t_len,
                               reinterpret_cast<const float2*>(win), t_len, hop, pad, f0,
                               n_frames};

  int p = 1, b = 0;
#define AA_STAGE(R, FIRST) \
  fft_stage_mixed<R, FIRST>(re[b ^ 1], im[b ^ 1], re[b], im[b], tw, n_fft, points, p, src)
  for (int s = 0; s < n_stages; ++s) {
    const int radix = radix_of(radices, s);
    b = s & 1;
    if (s == 0) {
      switch (radix) {
        case 2: AA_STAGE(2, true); break;
        case 3: AA_STAGE(3, true); break;
        case 4: AA_STAGE(4, true); break;
        case 5: AA_STAGE(5, true); break;
        case 7: AA_STAGE(7, true); break;
        case 8: AA_STAGE(8, true); break;
      }
      if constexpr (kLarge) {
        if (radix == 11) AA_STAGE(11, true);
        if (radix == 13) AA_STAGE(13, true);
      }
    } else {
      switch (radix) {
        case 3: AA_STAGE(3, false); break;
        case 5: AA_STAGE(5, false); break;
        case 7: AA_STAGE(7, false); break;
        case 8: AA_STAGE(8, false); break;
      }
      if constexpr (kLarge) {
        if (radix == 11) AA_STAGE(11, false);
        if (radix == 13) AA_STAGE(13, false);
      }
    }
    p *= radix;
  }
#undef AA_STAGE
  real_split(re[b], im[b], tw, out + static_cast<size_t>(row) * (m + 1) * n_frames + f0, m,
             frames, Divisor(frames), f0, n_frames);
}

// ------------------------------------------------------------ chirp-z ---
// Both routes below take an L-point DFT (L = n_fft / 2 of the packed even
// and odd samples for an even n_fft, L = n_fft for an odd one) as Bluestein's
// chirp-z transform where L is not a power of two: with w[n] = exp(-i pi n^2
// / L) (the `chirp` table, n^2 reduced mod 2 L on the host), Z[k] = w[k]
// sum_n (z[n] w[n]) conj w[k - n], a convolution that two forward M-point
// FFTs compute (M >= 2 L - 1, a power of two): A = FFT(z w, zero-padded to
// M); R = FFT(conj(A B')), B' = FFT(conj w wrapped to M) / M (the `bhat`
// table); Z[k] = w[k] conj R[k] (the inverse FFT as conj FFT conj). Both
// tables are computed on the host in float64 and rounded once to f32.

// Point n of transform t times the chirp w[n], zero from the length L on.
// An even n_fft: transform t is frame f0 + t as z[n] = x[2n] + i x[2n+1],
// windowed. An odd n_fft: transform t packs frames f0 + 2 t (real part) and
// f0 + 2 t + 1 (imaginary part), windowed; the split separates them.
template <bool kOdd, bool kFold>
struct ChirpSource {
  const float* xr;
  const float* win;
  const float2* chirp;
  int t_len, hop, pad, f0, n_frames, length;

  __device__ __forceinline__ float sample(int p) const {
    return __ldg(xr + (p >= 0 && p < t_len ? p : reflect_index<kFold>(p, t_len)));
  }

  __device__ __forceinline__ float2 load(int t, int n) const {
    float2 v = make_float2(0.0f, 0.0f);
    if (n >= length) return v;
    if constexpr (kOdd) {
      const int f = f0 + 2 * t;
      const float w = __ldg(win + n);
      if (f < n_frames) v.x = sample(f * hop + n - pad) * w;
      if (f + 1 < n_frames) v.y = sample((f + 1) * hop + n - pad) * w;
    } else {
      const int f = f0 + t;
      if (f >= n_frames) return v;
      const int p = f * hop + 2 * n - pad;
      const float2 w = __ldg(reinterpret_cast<const float2*>(win) + n);
      v = make_float2(sample(p) * w.x, sample(p + 1) * w.y);
    }
    return cmul(v, __ldg(chirp + n));
  }
};

struct NoSource {};                                // stages that read shared memory only

// A forward 2^log_m-point FFT of every transform in the buffer (kPoints
// points), in place: the power-of-two plan's radix 2 or 4 first where log_m
// is not a multiple of 3, then radix 8. kFirst: the first stage reads `src`.
template <bool kFirst, int kPoints = FFT_POINTS, typename Source>
__device__ __forceinline__ void pow2_fft(float* re, float* im, const float2* __restrict__ tw,
                                         int log_m, const Source& src) {
  int p;
  if (log_m % 3 == 1) {
    fft_stage<2, kFirst, kPoints>(re, im, tw, log_m, 1, src);
    p = 2;
  } else if (log_m % 3 == 2) {
    fft_stage<4, kFirst, kPoints>(re, im, tw, log_m, 1, src);
    p = 4;
  } else {
    fft_stage<8, kFirst, kPoints>(re, im, tw, log_m, 1, src);
    p = 8;
  }
  for (; p < (1 << log_m); p *= 8) fft_stage<8, false, kPoints>(re, im, tw, log_m, p, src);
}

// The bins of one item from Z[k] and Z[L - k] (zk, zb; Z[0] twice at k = 0)
// into out_row (n_bins, n_frames) at frame f. Even n_fft: the real split of
// the packed samples, X[k] = A + W^k B and X[L - k] = conj(A - W^k B) with
// W^k = split_tw[k] = exp(-2 pi i k / n_fft). Odd n_fft: frames f (real
// part) and f + 1 (imaginary part), X_f[k] = (Z[k] + conj Z[L - k]) / 2 and
// X_f+1[k] = -i (Z[k] - conj Z[L - k]) / 2.
template <bool kOdd>
__device__ __forceinline__ void store_bins(float2 zk, float2 zb, int k, int length, int f,
                                           const float2* __restrict__ split_tw,
                                           float2* __restrict__ out_row, int n_frames) {
  float2* o = out_row + static_cast<size_t>(k) * n_frames + f;
  if constexpr (kOdd) {
    o[0] = make_float2(0.5f * (zk.x + zb.x), 0.5f * (zk.y - zb.y));
    if (f + 1 < n_frames) o[1] = make_float2(0.5f * (zk.y + zb.y), -0.5f * (zk.x - zb.x));
  } else {
    const float cr = zb.x, ci = -zb.y;
    const float ar = 0.5f * (zk.x + cr), ai = 0.5f * (zk.y + ci);
    const float br = 0.5f * (zk.y - ci), bi = -0.5f * (zk.x - cr);
    const float2 w = __ldg(split_tw + k);
    const float wbr = w.x * br - w.y * bi, wbi = w.x * bi + w.y * br;
    o[0] = make_float2(ar + wbr, ai + wbi);
    if (2 * k != length)
      out_row[static_cast<size_t>(length - k) * n_frames + f] = make_float2(ar - wbr, wbi - ai);
  }
}

// The chirp route's split: Z[k] = w[k] conj R[k] of transform t (at t M + k),
// item i is bin k = i / T of transform i mod T, so consecutive threads store
// consecutive frames of one bin.
template <bool kOdd>
__device__ __forceinline__ void chirp_split(const float* re, const float* im,
                                            const float2* __restrict__ chirp,
                                            const float2* __restrict__ split_tw,
                                            float2* __restrict__ out_row, int length, int log_m,
                                            int log_t, int f0, int n_frames) {
  const int per = kOdd ? 2 : 1;
  for (int i = threadIdx.x; i < ((length >> 1) + 1) << log_t; i += FFT_THREADS) {
    const int k = i >> log_t, t = i & ((1 << log_t) - 1);
    const int f = f0 + per * t;
    if (f >= n_frames) continue;
    const int kb = k == 0 ? 0 : length - k;
    const int a = padded((t << log_m) + k), b = padded((t << log_m) + kb);
    const float2 zk = cmul(__ldg(chirp + k), make_float2(re[a], -im[a]));
    const float2 zb = cmul(__ldg(chirp + kb), make_float2(re[b], -im[b]));
    store_bins<kOdd>(zk, zb, k, length, f, split_tw, out_row, n_frames);
  }
}

// conj(A B') in place over `points` points, transform length 2^log_m:
// point i of the buffer is bin b(i) of its transform.
template <typename Bin>
__device__ __forceinline__ void chirp_product(float* re, float* im,
                                              const float2* __restrict__ bhat, int points,
                                              const Bin& bin) {
#pragma unroll 4
  for (int i = threadIdx.x; i < points; i += FFT_THREADS) {
    const int a = padded(i);
    const float2 v = cmul(make_float2(re[a], im[a]), __ldg(bhat + bin(i)));
    re[a] = v.x;
    im[a] = -v.y;
  }
  __syncthreads();
}

// The chirp-z route within one block (M = 2^log_m from 32 to 4096): the
// block's 4096 points hold T = 4096 / M transforms (2 T frames of an odd
// n_fft). The first FFT's first stage reads the chirp-multiplied frames
// from the row; the product with B' is one pass over shared memory; the
// split reads R. One 4096-point buffer, in place, as stft_fft_kernel.
template <bool kOdd, bool kFold>
__global__ void __launch_bounds__(FFT_THREADS, 2)
stft_chirp_kernel(const float* __restrict__ x, const float* __restrict__ win,
                  const float2* __restrict__ chirp, const float2* __restrict__ bhat,
                  const float2* __restrict__ tw, const float2* __restrict__ split_tw,
                  float2* __restrict__ out, int t_len, int rows, int log_m, int length,
                  int hop, int pad, int n_frames, int n_bins) {
  __shared__ float smem[FFT_BUFFER];
  float* re = smem;
  float* im = smem + FFT_PADDED + 16;               // 16 banks from re
  const int log_t = FFT_LOG_POINTS - log_m;
  int row;
  if (!tile_of(rows, row)) return;
  const int f0 = (blockIdx.x << log_t) * (kOdd ? 2 : 1);
  const ChirpSource<kOdd, kFold> src{x + static_cast<size_t>(row) * t_len, win, chirp, t_len,
                                     hop, pad, f0, n_frames, length};
  pow2_fft<true>(re, im, tw, log_m, src);
  const int mask = (1 << log_m) - 1;
  chirp_product(re, im, bhat, FFT_POINTS, [mask](int i) { return i & mask; });
  pow2_fft<false>(re, im, tw, log_m, NoSource{});
  chirp_split<kOdd>(re, im, chirp, split_tw,
                    out + static_cast<size_t>(row) * n_bins * n_frames, length, log_m, log_t,
                    f0, n_frames);
}

// ------------------------------------------------------------ cluster ---
// Frames of 4096 points and more (n_fft 8192, one CTA a frame, four a
// cluster; above, Bluestein's M or n_fft / 2 beyond one block):
// the N-point transform (N = 2^log_n from 4096 to 65536) spread over F = N
// / 4096 CTAs a frame, each holding a 4096-point part of each of its kSlots
// slots. A cluster holds four transforms (four frames, or four packed pairs
// of an odd n_fft): kSlots = 1, four groups of F CTAs (F <= 4, up to 16
// CTAs, 33.8 KB each); kSlots = 4, one group of F CTAs (135 KB each). A
// four-step split, P = 4096, within each group:
//   DIF (x in natural order, part j holding points 4096 j + p): the F-point
//   DFTs across the group through distributed shared memory, each result
//   times W_N^(p k1) and written back to part k1, then each part's
//   4096-point FFT in place: part k1 holds X[k1 + F k2] at k2.
//   DIT (part c holding points c + F p, the order DIF leaves): each part's
//   4096-point FFT, then across the group W_N^(c kp) and the F-point DFTs:
//   part kc holds X[kp + 4096 kc] at kp, natural order.
// A power-of-two n_fft / 2 takes DIF alone; a chirp-z length takes DIF for
// A, the product with B' in place (B' indexed k1 + F k2) and DIT for R.
// The split reads Z[k] and Z[L - k] wherever they lie in the cluster
// through distributed shared memory; item i is bin i / 4 of transform i
// mod 4 and each CTA takes an equal run of items, so four lanes store four
// consecutive frames of a bin (32 bytes, one sector; eight frames of an odd
// n_fft).
constexpr int CL_TRANSFORMS = 4;                          // transforms a cluster
constexpr int CL_LOG_TRANSFORMS = 2;
constexpr int CL_MAX_LOG_PARTS = 4;                       // 16 CTAs: 65536 points

template <int kSlots> struct ClusterSmem {
  static constexpr int POINTS = kSlots * FFT_POINTS;
  static constexpr int PADDED = POINTS + POINTS / 32;
  static constexpr int IM = PADDED + 16;                  // im, 16 banks from re
  static constexpr int BYTES = (IM + PADDED) * static_cast<int>(sizeof(float));
};

// Point a (padded) of CTA `rank`'s re / im (im at re + kIm), through
// distributed shared memory.
template <int kIm>
__device__ __forceinline__ float2 dsmem_load(float* re, int a, int rank) {
  const float* p = cg::this_cluster().map_shared_rank(re + a, rank);
  return make_float2(p[0], p[kIm]);
}

template <int kIm>
__device__ __forceinline__ void dsmem_store(float* re, int a, int rank, float2 v) {
  float* p = cg::this_cluster().map_shared_rank(re + a, rank);
  p[0] = v.x;
  p[kIm] = v.y;
}

// W16^j = exp(-2 pi i j / 16), j = 0 .. 9 (constant once unrolled).
__device__ __forceinline__ float2 w16(int j) {
  constexpr float c1 = 0.92387953f, s1 = 0.38268343f;
  switch (j) {
    case 0: return make_float2(1.0f, 0.0f);
    case 1: return make_float2(c1, -s1);
    case 2: return make_float2(kSqrtHalf, -kSqrtHalf);
    case 3: return make_float2(s1, -c1);
    case 4: return make_float2(0.0f, -1.0f);
    case 6: return make_float2(-kSqrtHalf, -kSqrtHalf);
    default: return make_float2(-c1, s1);          // 9
  }
}

// 16 points, natural order: n = 4 n1 + n2, k = k1 + 4 k2, two radix-4 passes.
__device__ __forceinline__ void dft16(float2 (&u)[16]) {
  float2 y[4][4];                                  // y[n2][k1]
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    float2 v[4] = {u[n2], u[n2 + 4], u[n2 + 8], u[n2 + 12]};
    dft<4>(v);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) y[n2][k1] = n2 * k1 ? cmul(v[k1], w16(n2 * k1)) : v[k1];
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    float2 v[4] = {y[0][k1], y[1][k1], y[2][k1], y[3][k1]};
    dft<4>(v);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) u[k1 + 4 * k2] = v[k2];
  }
}

template <int F> __device__ __forceinline__ void dft_parts(float2 (&u)[F]) {
  if constexpr (F == 16) dft16(u); else dft<F>(u);
}

// The F-point DFTs across a group's parts (ranks group0 .. group0 + F - 1):
// this part's share of the `points` positions of each slot (4096, or a
// mixed-radix part's P, one slot). kDit = false: DFT, then W_N^(p k) on
// output k (DIF); true: W_N^(c p) on input c, then the DFT (DIT). Output k
// goes to part k at the same position.
template <int F, bool kDit, int kSlots>
__device__ __forceinline__ void parts_dft(float* re, const float2* __restrict__ tw_n, int group0,
                                          int part, int points = FFT_POINTS) {
  constexpr int IM = ClusterSmem<kSlots>::IM;
  const int share = (points + F - 1) / F;
  for (int i = threadIdx.x; i < kSlots * share; i += FFT_THREADS) {
    const int s = kSlots == 1 ? 0 : i / share, p = part * share + (i - s * share);
    if (p >= points) break;                        // a part of odd P: the last position
    const int a = padded((s << FFT_LOG_POINTS) + p);
    float2 u[F];
#pragma unroll
    for (int c = 0; c < F; ++c) u[c] = dsmem_load<IM>(re, a, group0 + c);
    if constexpr (kDit) {
#pragma unroll
      for (int c = 1; c < F; ++c) u[c] = cmul(u[c], __ldg(tw_n + c * p));
    }
    dft_parts<F>(u);
    if constexpr (!kDit) {
#pragma unroll
      for (int k = 1; k < F; ++k) u[k] = cmul(u[k], __ldg(tw_n + k * p));
    }
#pragma unroll
    for (int k = 0; k < F; ++k) dsmem_store<IM>(re, a, group0 + k, u[k]);
  }
}

template <bool kDit, int kSlots>
__device__ __forceinline__ void parts_dft_of(int log_f, float* re,
                                             const float2* __restrict__ tw_n, int group0,
                                             int part, int points = FFT_POINTS) {
  switch (log_f) {
    case 1: parts_dft<2, kDit, kSlots>(re, tw_n, group0, part, points); break;
    case 2: parts_dft<4, kDit, kSlots>(re, tw_n, group0, part, points); break;
    case 3: parts_dft<8, kDit, kSlots>(re, tw_n, group0, part, points); break;
    case 4: parts_dft<16, kDit, kSlots>(re, tw_n, group0, part, points); break;
  }
}

// This CTA's part of each of its slots: points 4096 part + p of transform
// t0 + slot.
template <int kSlots, typename Source>
__device__ __forceinline__ void load_part(float* re, float* im, const Source& src, int t0,
                                          int part) {
#pragma unroll 4
  for (int i = threadIdx.x; i < kSlots * FFT_POINTS; i += FFT_THREADS) {
    const float2 v = src.load(t0 + (i >> FFT_LOG_POINTS),
                              (part << FFT_LOG_POINTS) + (i & (FFT_POINTS - 1)));
    const int a = padded(i);
    re[a] = v.x;
    im[a] = v.y;
  }
}

// grid (tiles x the cluster's CTAs, rows), clusters of 4 F / kSlots CTAs;
// CTA rank = group F + part. kSlots = 1 runs three blocks an SM at 40
// registers (spilling 0.4-0.9 KB a thread: 4-15 % faster than two blocks at
// 64 registers, in turns); kSlots = 4 one (135 KB of shared memory).
template <int kSlots, bool kChirp, bool kOdd, bool kFold>
__global__ void __launch_bounds__(FFT_THREADS, kSlots == 1 ? 3 : 1)
stft_cluster_kernel(const float* __restrict__ x, const float* __restrict__ win,
                    const float2* __restrict__ chirp, const float2* __restrict__ bhat,
                    const float2* __restrict__ tw_n, const float2* __restrict__ tw_local,
                    const float2* __restrict__ split_tw, float2* __restrict__ out, int t_len,
                    int rows, int log_f, int length, int hop, int pad, int n_frames,
                    int n_bins) {
  using Smem = ClusterSmem<kSlots>;
  extern __shared__ float smem[];                  // Smem::BYTES
  float* re = smem;
  float* im = smem + Smem::IM;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int log_cs = log_f + CL_LOG_TRANSFORMS - (kSlots == 1 ? 0 : CL_LOG_TRANSFORMS);
  const int part = rank & ((1 << log_f) - 1);
  const int group0 = rank - part;                  // the group's first CTA
  const int t0 = (rank >> log_f) * kSlots;         // the group's first transform
  int row;
  if (!tile_of(rows, row)) return;                 // the whole cluster shares its row
  const int f0 = (blockIdx.x >> log_cs) * CL_TRANSFORMS * (kOdd ? 2 : 1);
  const float* xr = x + static_cast<size_t>(row) * t_len;
  if constexpr (kChirp) {
    load_part<kSlots>(re, im, ChirpSource<kOdd, kFold>{xr, win, chirp, t_len, hop, pad, f0,
                                                        n_frames, length}, t0, part);
  } else {
    load_part<kSlots>(re, im, FrameSource<kFold>{xr, reinterpret_cast<const float2*>(win),
                                                 t_len, hop, pad, f0, n_frames}, t0, part);
  }
  if (log_f > 0) {
    cluster.sync();
    parts_dft_of<false, kSlots>(log_f, re, tw_n, group0, part);
  }
  cluster.sync();
  pow2_fft<false, Smem::POINTS>(re, im, tw_local, FFT_LOG_POINTS, NoSource{});
  if constexpr (kChirp) {
    chirp_product(re, im, bhat, Smem::POINTS,
                  [part, log_f](int i) { return part + ((i & (FFT_POINTS - 1)) << log_f); });
    pow2_fft<false, Smem::POINTS>(re, im, tw_local, FFT_LOG_POINTS, NoSource{});
    if (log_f > 0) {
      cluster.sync();
      parts_dft_of<true, kSlots>(log_f, re, tw_n, group0, part);
    }
  }
  cluster.sync();                                  // every CTA's points final
  // the split: Z[idx] of transform t is R's point idx (chirp-z, natural
  // order) or the DIF's bin idx (at part idx mod F, position idx / F), in
  // group t / kSlots, slot t mod kSlots
  const int items = ((length >> 1) + 1) << CL_LOG_TRANSFORMS;
  const int share = (((items + (1 << log_cs) - 1) >> log_cs) + 31) & ~31;
  const int end = min(items, (rank + 1) * share);
  float2* out_row = out + static_cast<size_t>(row) * n_bins * n_frames;
  auto z = [&](int t, int idx) {
    const int q = kChirp ? idx >> FFT_LOG_POINTS : idx & ((1 << log_f) - 1);
    const int p = kChirp ? idx & (FFT_POINTS - 1) : idx >> log_f;
    const int slot = t & (kSlots - 1);
    const float2 v = dsmem_load<Smem::IM>(re, padded((slot << FFT_LOG_POINTS) + p),
                                          ((t / kSlots) << log_f) + q);
    return kChirp ? cmul(__ldg(chirp + idx), make_float2(v.x, -v.y)) : v;
  };
  for (int i = rank * share + threadIdx.x; i < end; i += FFT_THREADS) {
    const int k = i >> CL_LOG_TRANSFORMS, t = i & (CL_TRANSFORMS - 1);
    const int f = f0 + (kOdd ? 2 : 1) * t;
    if (f >= n_frames) continue;
    store_bins<kOdd>(z(t, k), z(t, k == 0 ? 0 : length - k), k, length, f, split_tw, out_row,
                     n_frames);
  }
  cluster.sync();                                  // no CTA leaves while its points are read
}

// The cluster route for an even n_fft above 8192 whose half m is 13-smooth
// but not a power of two, where m = F P with F = 2 or 4 and P <= 4096: the
// four-step DIF as above with the F-point DFTs across the parts (W_m^(p
// k1)), then each part's P-point mixed-radix Stockham FFT (the FFT route's
// stft_fft_mixed_kernel stages, reading one buffer of 67.7 KB while writing
// the other), no chirp. A CTA a frame, four frames a cluster of 4 F CTAs.
template <bool kLarge, bool kFold>
__global__ void __launch_bounds__(FFT_THREADS, 2)
stft_cluster_mixed_kernel(const float* __restrict__ x, const float* __restrict__ win,
                          const float2* __restrict__ tw_m, const float2* __restrict__ tw_local,
                          const float2* __restrict__ split_tw, float2* __restrict__ out,
                          int t_len, int rows, int log_f, int part_points,
                          unsigned long long radices, int n_stages, int hop, int pad,
                          int n_frames, int n_bins) {
  constexpr int IM = FFT_PADDED + 16;              // as ClusterSmem<1>::IM
  extern __shared__ float smem[];                  // FFT_MIXED_SMEM_BYTES: two buffers
  float* re[2] = {smem, smem + FFT_BUFFER};
  float* im[2] = {smem + IM, smem + FFT_BUFFER + IM};
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int log_cs = log_f + CL_LOG_TRANSFORMS;
  const int part = rank & ((1 << log_f) - 1);
  const int group0 = rank - part;
  const int m = part_points << log_f;
  int row;
  if (!tile_of(rows, row)) return;                 // the whole cluster shares its row
  const int f0 = (blockIdx.x >> log_cs) * CL_TRANSFORMS;
  const float* xr = x + static_cast<size_t>(row) * t_len;
  const FrameSource<kFold> src{xr, reinterpret_cast<const float2*>(win), t_len, hop, pad, f0,
                               n_frames};
  // points part P + p of frame rank / F into buffer 1, which stage 0 reads
  for (int p = threadIdx.x; p < part_points; p += FFT_THREADS) {
    const float2 v = src.load(rank >> log_f, part * part_points + p);
    re[1][padded(p)] = v.x;
    im[1][padded(p)] = v.y;
  }
  cluster.sync();
  parts_dft_of<false, 1>(log_f, re[1], tw_m, group0, part, part_points);
  cluster.sync();
  int p = 1, b = 0;
  const NoSource none;
#define AA_STAGE(R)                                                                        \
  fft_stage_mixed<R, false>(re[b ^ 1], im[b ^ 1], re[b], im[b], tw_local, 2 * part_points, \
                            part_points, p, none)
  for (int s = 0; s < n_stages; ++s) {
    const int radix = radix_of(radices, s);
    b = s & 1;
    switch (radix) {
      case 2: AA_STAGE(2); break;
      case 3: AA_STAGE(3); break;
      case 4: AA_STAGE(4); break;
      case 5: AA_STAGE(5); break;
      case 7: AA_STAGE(7); break;
      case 8: AA_STAGE(8); break;
    }
    if constexpr (kLarge) {
      if (radix == 11) AA_STAGE(11);
      if (radix == 13) AA_STAGE(13);
    }
    p *= radix;
  }
#undef AA_STAGE
  cluster.sync();                                  // every CTA's bins final
  // the split: Z[k] at part k mod F, position k / F, of frame t's group
  const int items = ((m >> 1) + 1) << CL_LOG_TRANSFORMS;
  const int share = (((items + (1 << log_cs) - 1) >> log_cs) + 31) & ~31;
  const int end = min(items, (rank + 1) * share);
  float2* out_row = out + static_cast<size_t>(row) * n_bins * n_frames;
  auto z = [&](int t, int idx) {
    return dsmem_load<IM>(re[b], padded(idx >> log_f), (t << log_f) + (idx & ((1 << log_f) - 1)));
  };
  for (int i = rank * share + threadIdx.x; i < end; i += FFT_THREADS) {
    const int k = i >> CL_LOG_TRANSFORMS, t = i & (CL_TRANSFORMS - 1);
    const int f = f0 + t;
    if (f >= n_frames) continue;
    store_bins<false>(z(t, k), z(t, k == 0 ? 0 : m - k), k, m, f, split_tw, out_row, n_frames);
  }
  cluster.sync();                                  // no CTA leaves while its points are read
}

bool odd_radix(int r) { return r == 3 || r == 5 || r == 7 || r == 11 || r == 13; }

}  // namespace

// x: (rows, t_len) f32, contiguous. win: (n_fft,) f32. bases: [2][n_fft][kp]
// f32 (cos then sin; columns >= n_bins zero; kp a multiple of 64). out:
// (rows, n_bins, n_frames) complex64. pad: n_fft / 2 when centred, else 0
// (any t_len >= 1). Returns cudaGetLastError().
extern "C" int aa_stft(const void* x, const void* win, const void* bases, void* out,
                       int rows, int t_len, int n_fft, int hop, int pad, int n_frames,
                       int n_bins, int kp, void* stream) {
  const int tiles = (n_frames + BM - 1) / BM;
  if (rows <= 0 || n_fft <= 0 || hop <= 0 || n_frames <= 0 || kp % BN != 0 ||
      kp < n_bins || kp / BN > 65535 || t_len <= 0 || pad < 0 ||
      static_cast<long long>(tiles) * rows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles * rows, kp / BN);
  const auto kernel = pad >= t_len ? stft_kernel<true> : stft_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float*>(bases), static_cast<float2*>(out), t_len, n_fft, hop, pad,
      n_frames, n_bins, kp, tiles);
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, t_len) f32, contiguous. win: (n_fft,) f32. tw: (n_fft,) complex
// f32, tw[j] = exp(-2 pi i j / n_fft). out: (rows, n_fft / 2 + 1, n_frames)
// complex64. radices: the n_stages radices (2, 3, 4, 5, 7, 8, 11 or 13) of
// the plan, whose product is m = n_fft / 2, from 8 to 4096. pad: n_fft / 2
// when centred, else 0 (any t_len >= 1). Returns cudaGetLastError().
extern "C" int aa_stft_fft(const void* x, const void* win, const void* tw, void* out,
                           int rows, int t_len, int n_fft, int hop, int pad, int n_frames,
                           const int* radices, int n_stages, void* stream) {
  const int m = n_fft / 2;
  if (rows <= 0 || n_fft % 2 != 0 || m < 8 || m > FFT_POINTS || hop <= 0 ||
      n_frames <= 0 || t_len <= 0 || pad < 0 || n_stages < 1 || n_stages > FFT_MAX_STAGES ||
      static_cast<long long>(t_len) + 2 * pad >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // radix 2 or 4 only first, 8 and the odd primes anywhere
  unsigned long long packed = 0;
  long long product = 1;
  bool odd = false, large = false;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    if (!(r == 8 || odd_radix(r) || (s == 0 && (r == 2 || r == 4))))
      return static_cast<int>(cudaErrorInvalidValue);
    packed |= static_cast<unsigned long long>(r) << (4 * s);
    product *= r;
    odd = odd || odd_radix(r);
    large = large || r > 8;
  }
  const int frames = FFT_POINTS / m;
  const dim3 grid((n_frames + frames - 1) / frames, rows < 65535 ? rows : 65535,
                  (rows + 65534) / 65535);
  if (product != m || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(win);
  const float2* twf = static_cast<const float2*>(tw);
  float2* of = static_cast<float2*>(out);
  const bool fold = pad >= t_len;                  // a row no longer than the pad
  if (odd) {
    const auto kernel = large ? (fold ? stft_fft_mixed_kernel<true, true>
                                      : stft_fft_mixed_kernel<true, false>)
                              : (fold ? stft_fft_mixed_kernel<false, true>
                                      : stft_fft_mixed_kernel<false, false>);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FFT_MIXED_SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, FFT_THREADS, FFT_MIXED_SMEM_BYTES, st>>>(
        xf, wf, twf, of, t_len, rows, n_fft, packed, n_stages, hop, pad, n_frames);
  } else {
    int log_m = 0;
    while ((1 << log_m) < m) ++log_m;
    const auto kernel = fold ? stft_fft_kernel<true> : stft_fft_kernel<false>;
    kernel<<<grid, FFT_THREADS, 0, st>>>(xf, wf, twf, of, t_len, rows, log_m, radices[0], hop,
                                         pad, n_frames);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, t_len) f32, contiguous. win: (n_fft,) f32. chirp: (length,)
// complex f32, w[n] = exp(-i pi (n^2 mod 2 length) / length). bhat: (M,)
// complex f32, the M-point DFT of conj w wrapped to M, over M (M = 2^log_m,
// 32 to 4096, at least 2 length - 1). tw: (2 M,) complex f32, exp(-2 pi i j
// / 2M). split_tw: (n_fft,) complex f32, exp(-2 pi i j / n_fft) (read for an
// even n_fft). length: n_fft / 2 for an even n_fft, n_fft for an odd one.
// out: (rows, n_fft / 2 + 1, n_frames) complex64. pad: n_fft / 2 when
// centred, else 0 (any t_len >= 1). Returns cudaGetLastError().
extern "C" int aa_stft_chirp(const void* x, const void* win, const void* chirp, const void* bhat,
                             const void* tw, const void* split_tw, void* out, int rows,
                             int t_len, int n_fft, int hop, int pad, int n_frames, int log_m,
                             int length, void* stream) {
  const bool odd = n_fft % 2 != 0;
  if (rows <= 0 || hop <= 0 || n_frames <= 0 || t_len <= 0 || pad < 0 || log_m < 5 ||
      log_m > FFT_LOG_POINTS || length != (odd ? n_fft : n_fft / 2) || length < 8 ||
      2 * length - 1 > (1 << log_m) || static_cast<long long>(t_len) + 2 * pad >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (FFT_POINTS >> log_m) * (odd ? 2 : 1);      // frames a block
  const dim3 grid((n_frames + per - 1) / per, rows < 65535 ? rows : 65535,
                  (rows + 65534) / 65535);
  if (grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool fold = pad >= t_len;
  const auto kernel = odd ? (fold ? stft_chirp_kernel<true, true> : stft_chirp_kernel<true, false>)
                          : (fold ? stft_chirp_kernel<false, true>
                                  : stft_chirp_kernel<false, false>);
  kernel<<<grid, FFT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float2*>(chirp), static_cast<const float2*>(bhat),
      static_cast<const float2*>(tw), static_cast<const float2*>(split_tw),
      static_cast<float2*>(out), t_len, rows, log_m, length, hop, pad, n_frames, n_fft / 2 + 1);
  return static_cast<int>(cudaGetLastError());
}

namespace {

using ClusterKernel = void (*)(const float*, const float*, const float2*, const float2*,
                               const float2*, const float2*, const float2*, float2*, int, int,
                               int, int, int, int, int, int);

template <int kSlots, bool kChirp, bool kOdd, bool kFold>
cudaError_t configured_cluster_kernel(ClusterKernel& kernel) {
  kernel = stft_cluster_kernel<kSlots, kChirp, kOdd, kFold>;
  static bool configured = false;                  // attributes set once per instance
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ClusterSmem<kSlots>::BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  configured = e == cudaSuccess;
  return e;
}

template <int kSlots>
cudaError_t cluster_kernel_of(bool chirped, bool odd, bool fold, ClusterKernel& kernel) {
  return !chirped ? (fold ? configured_cluster_kernel<kSlots, false, false, true>(kernel)
                          : configured_cluster_kernel<kSlots, false, false, false>(kernel))
         : odd    ? (fold ? configured_cluster_kernel<kSlots, true, true, true>(kernel)
                          : configured_cluster_kernel<kSlots, true, true, false>(kernel))
                  : (fold ? configured_cluster_kernel<kSlots, true, false, true>(kernel)
                          : configured_cluster_kernel<kSlots, true, false, false>(kernel));
}

}  // namespace

// As aa_stft_chirp, with the transform of N = 2^log_n points (4096 to 65536)
// on N / 4096 CTAs a frame, four transforms a cluster: slots 1 (four groups
// of CTAs, N <= 16384) or 4 (every transform in each CTA). length == N (an
// even n_fft whose half is N) takes no chirp: chirp and bhat may be null.
// Otherwise 2 length - 1 <= N and bhat has N points. tw_n: (N,) complex
// f32, exp(-2 pi i j / N). tw_local: (8192,) complex f32, exp(-2 pi i j /
// 8192) (each CTA's 4096-point FFT). Returns the launch's error or
// cudaGetLastError().
extern "C" int aa_stft_cluster(const void* x, const void* win, const void* chirp,
                               const void* bhat, const void* tw_n, const void* tw_local,
                               const void* split_tw, void* out, int rows, int t_len, int n_fft,
                               int hop, int pad, int n_frames, int log_n, int length, int slots,
                               void* stream) {
  const bool odd = n_fft % 2 != 0;
  const int log_f = log_n - FFT_LOG_POINTS;
  const int log_cs = log_f + (slots == 1 ? CL_LOG_TRANSFORMS : 0);
  if (rows <= 0 || hop <= 0 || n_frames <= 0 || t_len <= 0 || pad < 0 || log_f < 0 ||
      log_f > CL_MAX_LOG_PARTS || (slots != 1 && slots != CL_TRANSFORMS) ||
      log_cs > CL_MAX_LOG_PARTS || length != (odd ? n_fft : n_fft / 2) || length < 8 ||
      static_cast<long long>(t_len) + 2 * pad >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool chirped = length != (1 << log_n);
  if (chirped ? 2 * length - 1 > (1 << log_n) : odd) return static_cast<int>(cudaErrorInvalidValue);
  const int per = CL_TRANSFORMS * (odd ? 2 : 1);  // frames a cluster
  const long long tiles = (n_frames + per - 1) / per;
  if ((tiles << log_cs) > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles << log_cs), rows < 65535 ? rows : 65535,
                  (rows + 65534) / 65535);
  if (grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool fold = pad >= t_len;
  ClusterKernel kernel;
  const cudaError_t e = slots == 1 ? cluster_kernel_of<1>(chirped, odd, fold, kernel)
                                   : cluster_kernel_of<CL_TRANSFORMS>(chirped, odd, fold, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FFT_THREADS);
  cfg.dynamicSmemBytes = slots == 1 ? ClusterSmem<1>::BYTES : ClusterSmem<CL_TRANSFORMS>::BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float2*>(chirp), static_cast<const float2*>(bhat),
      static_cast<const float2*>(tw_n), static_cast<const float2*>(tw_local),
      static_cast<const float2*>(split_tw), static_cast<float2*>(out), t_len, rows, log_f,
      length, hop, pad, n_frames, n_fft / 2 + 1);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// As aa_stft_cluster for an even n_fft whose half m = parts x P is 13-smooth
// but not a power of two (parts 2 or 4, P <= 4096): radices, the n_stages
// radices of P's Stockham stages (radix 2 or 4 only first, as
// aa_stft_fft's). tw_m: (m,) complex f32, exp(-2 pi i j / m). tw_local:
// (2 P,) complex f32, exp(-2 pi i j / 2P). split_tw: (n_fft,). Returns the
// launch's error or cudaGetLastError().
extern "C" int aa_stft_cluster_mixed(const void* x, const void* win, const void* tw_m,
                                     const void* tw_local, const void* split_tw, void* out,
                                     int rows, int t_len, int n_fft, int hop, int pad,
                                     int n_frames, int parts, const int* radices, int n_stages,
                                     void* stream) {
  const int log_f = parts == 2 ? 1 : parts == 4 ? 2 : -1;
  const int m = n_fft / 2;
  if (rows <= 0 || hop <= 0 || n_frames <= 0 || t_len <= 0 || pad < 0 || log_f < 0 ||
      n_fft % 2 != 0 || m % parts != 0 || m / parts < 8 || m / parts > FFT_POINTS ||
      n_stages < 1 || n_stages > FFT_MAX_STAGES ||
      static_cast<long long>(t_len) + 2 * pad >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long packed = 0;
  long long product = 1;
  bool large = false;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    if (!(r == 8 || odd_radix(r) || (s == 0 && (r == 2 || r == 4))))
      return static_cast<int>(cudaErrorInvalidValue);
    packed |= static_cast<unsigned long long>(r) << (4 * s);
    product *= r;
    large = large || r > 8;
  }
  const int log_cs = log_f + CL_LOG_TRANSFORMS;
  const long long tiles = (n_frames + CL_TRANSFORMS - 1) / CL_TRANSFORMS;
  if (product != m / parts || (tiles << log_cs) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles << log_cs), rows < 65535 ? rows : 65535,
                  (rows + 65534) / 65535);
  if (grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool fold = pad >= t_len;
  const auto kernel = large ? (fold ? stft_cluster_mixed_kernel<true, true>
                                    : stft_cluster_mixed_kernel<true, false>)
                            : (fold ? stft_cluster_mixed_kernel<false, true>
                                    : stft_cluster_mixed_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       FFT_MIXED_SMEM_BYTES);
  if (e == cudaSuccess)                            // 16 CTAs a cluster at 4 parts
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FFT_THREADS);
  cfg.dynamicSmemBytes = FFT_MIXED_SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x),
                         static_cast<const float*>(win), static_cast<const float2*>(tw_m),
                         static_cast<const float2*>(tw_local),
                         static_cast<const float2*>(split_tw), static_cast<float2*>(out), t_len,
                         rows, log_f, m / parts, packed, n_stages, hop, pad, n_frames,
                         n_fft / 2 + 1);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
