// Fused STFT for Hopper (sm_90a): kernel K6 of the port.
//
// Replaces: audio_algebra_tpu/ops/pallas/stft_kernel.py: pallas_stft (its
// Pallas kernel, launched once per call), which ops/stft.py:stft takes for
// the default window.
//
// Computes, for every signal row r and frame f of the centre-padded row
// (reflect padding of n_fft / 2 when centred):
//   X[r, k, f] = sum_n xpad[r, f * hop + n] * w[n] * (cos[n, k] + i sin[n, k])
// with w the periodic Hann window and cos / sin the onesided DFT bases
// (angle -2 pi k n / n_fft), all f32, written as complex64 in torch's
// layout (rows, n_bins, F). The framed signal never goes to device memory.
//
// Design: an implicit GEMM (frames x n_fft) @ (n_fft x 2 n_bins) on the
// CUDA cores in f32 (TF32 tensor cores would lose the accuracy the 1e-9
// iSTFT round trip needs). One block per (tile of 32 frames, tile of 64
// bins, row); grid.y walks the bins. The block stages its frames' span of
// the row, (32 - 1) * hop + n_fft samples, in shared memory once, with the
// reflect padding done by index math (no padded copy in device memory).
// Then for each depth chunk of 32 samples it builds the windowed A tile
// (32 x 32) and the cos / sin B tiles (32 x 64 each, from a zero-padded
// device table that stays in L2) in shared memory, and each of 128
// threads accumulates a 4-frame x 4-bin register tile of (re, im) with
// FMAs, summing over n in ascending order.
//
// Bound: f32 FMA rate. At the spectrogram models' shape, 32 rows of 65536
// samples at n_fft 1024 / hop 256, the product is 17.3 GFLOP (0.26 ms at
// the H100's 67 TFLOP/s f32) against 42 MB of device memory traffic
// (0.013 ms). The 64-bin tiles pad 513 bins to 576, 11% of the work.
//
// C interface (bound with ctypes): aa_stft launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

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
