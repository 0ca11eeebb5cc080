// The effects bank's three recurrences for Hopper (sm_90a): kernels R1, R2
// and R3 of the port. None has a Pallas counterpart: the JAX package writes
// each as a `lax.scan` (or an associative scan), which torch does not have,
// and a Python loop over 262,144 samples would launch about a million
// kernels a call.
//
// R1 aa_sosfilt replaces audio_algebra_tpu/ops/filters.py:189-232
//   (`sosfilt` over `_biquad_assoc`; `_biquad_scan` :170-187): a cascade of
//   biquad sections in transposed direct form II over each row of (rows, T),
//       y = b0 x + s1;  s1 = b1 x - a1 y + s2;  s2 = b2 x - a2 y,
//   the output of one section the input of the next, the state zero at t = 0.
//   The coefficients (b0, b1, b2, a0, a1, a2), a0 = 1, are per row (a knob
//   sweep's rows each carry their own) or one set for every row.
// R2 aa_envelope replaces audio_algebra_tpu/ops/effects.py:97-102 (the
//   compressor's `lax.scan`): env = c env + (1 - c) |x|, c = a_att where
//   |x| > env, else a_rel, from env = 0. It is not affine, so it has no
//   associative form.
// R3 aa_freeverb_ir replaces audio_algebra_tpu/ops/effects.py:178-223
//   (`freeverb_ir`'s `lax.scan`): the impulse response of JUCE's Freeverb wet
//   path, 8 damped feedback combs summed, then 4 series allpasses.
//
// R1 and R2: one thread a row, the state in registers, one warp a block of 32
// rows. A thread reading its own row alone would make a warp's loads stride by
// T, so the warp stages 32 x 128 tiles through shared memory, double-buffered:
// cp.async copies the next tile row by row (512 contiguous bytes a row, 16 a
// lane) while each thread runs its row's 128 samples of the current one, 32
// at a time moved into registers (float4 reads, row stride 132 words: no bank
// conflict), so no load sits on the chain; the warp stores the tile back row
// by row with 16-byte stores. R1 is instantiated for 1-8 sections, each
// unrolled with its state in registers. Bound: the serial chain. A row
// is T dependent steps; R1's step carries 2 dependent FMAs a sample (y, then
// s1; the sections pipeline behind it), R2's an FMA and a select. The bytes
// (x read once, y written once) take far less at the xae path's shapes.
//
// R3: one block of 256 threads an impulse response, every delay line in
// shared memory (8 x <= 1,785 + 4 x <= 630 floats at 48 kHz, plus two 8 x 257
// staging arrays: ~72 KB, dynamic). Time goes in chunks of m samples, m no
// longer than the shortest delay line (244 at 48 kHz, at most 256). Within a
// chunk no delay line reads a slot that the chunk writes, and each sample owns
// its own slot of every line, so: every comb's outputs of the chunk are read
// in parallel (a thread a sample); the 8 comb threads each run their one-FMA
// damping chain over the m samples; then, a thread a sample, the feedback
// writes, the comb sum (in the fixed order 0..7; XLA's `out.sum()` may add in
// another order, a difference of a few f32 ulps of the sum) and the 4
// allpasses in series. Bound: the damping chain, one dependent FMA a sample.
//
// C interface (bound with ctypes): each function launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(). R1 and R2 take rows of a length that is a multiple of
// 4, 16-byte aligned (ops/recurrence.py pads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;          // rows a block (one warp), R1 and R2
constexpr int kTile = 128;         // samples a staged tile
constexpr int kLd = kTile + 4;     // a tile row's stride: 16-byte rows, no bank conflict
constexpr int kChunk = 32;         // samples a thread holds in registers at once

constexpr int kCombs = 8;
constexpr int kAllpasses = 4;
constexpr int kIrThreads = 256;    // R3's block; also its longest chunk
constexpr int kStride = kIrThreads + 1;
constexpr long long kMaxSmemBytes = 232448;  // shared memory one block may use on an H100
__constant__ int kCombTunings[kCombs] = {1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617};
__constant__ int kAllpassTunings[kAllpasses] = {556, 441, 341, 225};
constexpr int kCombTuningsHost[kCombs] = {1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617};
constexpr int kAllpassTuningsHost[kAllpasses] = {556, 441, 341, 225};

// The biquad cascade's state: NSEC sections in registers.
template <int NSEC>
struct Biquads {
  float b0[NSEC], b1[NSEC], b2[NSEC], a1[NSEC], a2[NSEC], s1[NSEC], s2[NSEC];

  __device__ void init(const float* c) {
#pragma unroll
    for (int k = 0; k < NSEC; ++k) {
      b0[k] = c[6 * k];
      b1[k] = c[6 * k + 1];
      b2[k] = c[6 * k + 2];
      a1[k] = c[6 * k + 4];
      a2[k] = c[6 * k + 5];
      s1[k] = s2[k] = 0.f;
    }
  }

  __device__ __forceinline__ float operator()(float v) {
#pragma unroll
    for (int k = 0; k < NSEC; ++k) {
      const float y = b0[k] * v + s1[k];
      s1[k] = b1[k] * v - a1[k] * y + s2[k];
      s2[k] = b2[k] * v - a2[k] * y;
      v = y;
    }
    return v;
  }
};

// The compressor's attack / release envelope follower.
struct Envelope {
  float a_att, a_rel, om_att, om_rel, env;

  __device__ void init(float att, float rel) {
    a_att = att;
    a_rel = rel;
    om_att = 1.f - att;      // (1 - coeff) in f32, as the JAX scan computes it
    om_rel = 1.f - rel;
    env = 0.f;
  }

  __device__ __forceinline__ float operator()(float v) {
    const float l = fabsf(v);
    const float up = a_att * env + om_att * l;
    const float down = a_rel * env + om_rel * l;
    env = l > env ? up : down;
    return env;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of one 32-row x kTile tile of (rows, t_len) into `dst`,
// 16 bytes a lane a row: each row's kTile samples are one 512-byte run. Past
// t_len nothing is copied (what the buffer holds there is never stored).
__device__ __forceinline__ void load_tile(float (*dst)[kLd], const float* __restrict__ x,
                                          int row0, int n_rows, int t_len, int t0) {
  const int col = t0 + 4 * threadIdx.x;
  if (col < t_len) {
    for (int r = 0; r < n_rows; ++r)
      cp_async16(&dst[r][4 * threadIdx.x], x + static_cast<size_t>(row0 + r) * t_len + col);
  }
  cp_async_commit();
}

// One warp runs `step` along each of its 32 rows of (rows, t_len), t_len a
// multiple of 4 (the wrappers pad), in tiles of 32 rows x kTile samples
// double-buffered in shared memory: the next tile's cp.async copy is in
// flight while a thread steps through its row of the current one, kChunk
// samples at a time in registers, and the warp writes the tile back row by
// row with 16-byte stores.
template <typename Step>
__device__ void scan_rows(const float* __restrict__ x, float* __restrict__ y, int rows,
                          int t_len, Step& step) {
  __shared__ __align__(16) float tile[2][kRows][kLd];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, rows - row0);
  load_tile(tile[0], x, row0, n_rows, t_len, 0);
  int buf = 0;
  for (int t0 = 0; t0 < t_len; t0 += kTile, buf ^= 1) {
    if (t0 + kTile < t_len)
      load_tile(tile[buf ^ 1], x, row0, n_rows, t_len, t0 + kTile);
    else
      cp_async_commit();                       // an empty group keeps the count
    cp_async_wait<1>();                        // this tile's copy has landed
    __syncwarp();
    if (lane < n_rows) {
      float* mine = tile[buf][lane];
      for (int c = 0; c < kTile; c += kChunk) {
        float v[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(mine + c + j);
          v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) v[j] = step(v[j]);
#pragma unroll
        for (int j = 0; j < kChunk; j += 4)
          *reinterpret_cast<float4*>(mine + c + j) = make_float4(v[j], v[j + 1], v[j + 2],
                                                                 v[j + 3]);
      }
    }
    __syncwarp();
    const int col = t0 + 4 * lane;
    if (col < t_len) {
      for (int r = 0; r < n_rows; ++r)
        *reinterpret_cast<float4*>(y + static_cast<size_t>(row0 + r) * t_len + col) =
            *reinterpret_cast<const float4*>(&tile[buf][r][4 * lane]);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

template <int NSEC>
__global__ void __launch_bounds__(kRows)
sosfilt_kernel(const float* __restrict__ x, const float* __restrict__ sos,
               float* __restrict__ y, int rows, int t_len, int sos_stride) {
  const int row = min(blockIdx.x * kRows + threadIdx.x, rows - 1);
  Biquads<NSEC> step;
  step.init(sos + static_cast<size_t>(row) * sos_stride);
  scan_rows(x, y, rows, t_len, step);
}

__global__ void __launch_bounds__(kRows)
envelope_kernel(const float* __restrict__ x, float* __restrict__ env, int rows, int t_len,
                float a_att, float a_rel) {
  Envelope step;
  step.init(a_att, a_rel);
  scan_rows(x, env, rows, t_len, step);
}

__host__ __device__ inline int delay_size(int sr, int tuning, int spread) {
  const long long s = static_cast<long long>(sr) * (tuning + spread) / 44100;
  return s > 1 ? static_cast<int>(s) : 1;
}

__global__ void __launch_bounds__(kIrThreads)
freeverb_ir_kernel(const float* __restrict__ feedback, const float* __restrict__ damp,
                   const int* __restrict__ spreads, float* __restrict__ ir, int n, int sr,
                   int chunk) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int spread = spreads[b];
  int csize[kCombs], coff[kCombs], asize[kAllpasses], aoff[kAllpasses];
  int total = 0;
#pragma unroll
  for (int k = 0; k < kCombs; ++k) {
    csize[k] = delay_size(sr, kCombTunings[k], spread);
    coff[k] = total;
    total += csize[k];
  }
#pragma unroll
  for (int k = 0; k < kAllpasses; ++k) {
    asize[k] = delay_size(sr, kAllpassTunings[k], spread);
    aoff[k] = total;
    total += asize[k];
  }
  float* outs = smem + total;                 // [kCombs][kStride]: comb outputs
  float* lasts = outs + kCombs * kStride;     // [kCombs][kStride]: damped feedback
  for (int i = tid; i < total; i += kIrThreads) smem[i] = 0.f;
  const float fb = feedback[b], dm = damp[b], odm = 1.f - dm;
  float last = 0.f;                           // comb `tid`'s state (tid < kCombs)
  int cpos[kCombs], apos[kAllpasses];         // (i0 + tid) mod each delay
#pragma unroll
  for (int k = 0; k < kCombs; ++k) cpos[k] = tid % csize[k];
#pragma unroll
  for (int k = 0; k < kAllpasses; ++k) apos[k] = tid % asize[k];
  __syncthreads();

  for (int i0 = 0; i0 < n; i0 += chunk) {
    const int m = min(chunk, n - i0);
    const bool mine = tid < m;
    if (mine) {
#pragma unroll
      for (int k = 0; k < kCombs; ++k) outs[k * kStride + tid] = smem[coff[k] + cpos[k]];
    }
    __syncthreads();
    if (tid < kCombs) {
      const float* o = outs + tid * kStride;
      float* l = lasts + tid * kStride;
      for (int j = 0; j < m; ++j) {
        last = o[j] * odm + last * dm;
        l[j] = last;
      }
    }
    __syncthreads();
    if (mine) {
      const float inp = (i0 + tid == 0) ? 1.f : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kCombs; ++k) {
        smem[coff[k] + cpos[k]] = inp + lasts[k * kStride + tid] * fb;
        sum += outs[k * kStride + tid];
      }
      float a = sum;
#pragma unroll
      for (int k = 0; k < kAllpasses; ++k) {
        // Within a chunk each sample owns its own slot of every allpass, so
        // the stages run in series for this sample with no barrier.
        float* slot = smem + aoff[k] + apos[k];
        const float bufout = *slot;
        *slot = a + bufout * 0.5f;
        a = bufout - a;
      }
      ir[static_cast<size_t>(b) * n + i0 + tid] = a;
    }
#pragma unroll
    for (int k = 0; k < kCombs; ++k) {
      cpos[k] += chunk;
      while (cpos[k] >= csize[k]) cpos[k] -= csize[k];
    }
#pragma unroll
    for (int k = 0; k < kAllpasses; ++k) {
      apos[k] += chunk;
      while (apos[k] >= asize[k]) apos[k] -= asize[k];
    }
    __syncthreads();
  }
}

int blocks_for(int rows) { return (rows + kRows - 1) / kRows; }

}  // namespace

template <int NSEC>
cudaError_t launch_sosfilt(const float* x, const float* sos, float* y, int rows, int t_len,
                           int sos_stride, cudaStream_t stream) {
  sosfilt_kernel<NSEC><<<blocks_for(rows), kRows, 0, stream>>>(x, sos, y, rows, t_len,
                                                              sos_stride);
  return cudaGetLastError();
}

extern "C" int aa_sosfilt(const float* x, const float* sos, float* y, int rows, int t_len,
                          int n_sec, int sos_per_row, void* stream) {
  if (rows < 1 || t_len < 1 || t_len % 4) return cudaErrorInvalidValue;
  const int stride = sos_per_row ? 6 * n_sec : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_sec) {
    case 1: return launch_sosfilt<1>(x, sos, y, rows, t_len, stride, s);
    case 2: return launch_sosfilt<2>(x, sos, y, rows, t_len, stride, s);
    case 3: return launch_sosfilt<3>(x, sos, y, rows, t_len, stride, s);
    case 4: return launch_sosfilt<4>(x, sos, y, rows, t_len, stride, s);
    case 5: return launch_sosfilt<5>(x, sos, y, rows, t_len, stride, s);
    case 6: return launch_sosfilt<6>(x, sos, y, rows, t_len, stride, s);
    case 7: return launch_sosfilt<7>(x, sos, y, rows, t_len, stride, s);
    case 8: return launch_sosfilt<8>(x, sos, y, rows, t_len, stride, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int aa_envelope(const float* x, float* env, int rows, int t_len, float a_att,
                           float a_rel, void* stream) {
  if (rows < 1 || t_len < 1 || t_len % 4) return cudaErrorInvalidValue;
  envelope_kernel<<<blocks_for(rows), kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      x, env, rows, t_len, a_att, a_rel);
  return cudaGetLastError();
}

// The chunk length and shared memory of a launch whose spreads lie in
// [min_spread, max_spread] (the delay sizes grow with the spread).
static int freeverb_chunk(int sr, int min_spread) {
  int m = kIrThreads;
  for (int k = 0; k < kAllpasses; ++k)
    m = min(m, delay_size(sr, kAllpassTuningsHost[k], min_spread));
  for (int k = 0; k < kCombs; ++k) m = min(m, delay_size(sr, kCombTuningsHost[k], min_spread));
  return m;
}

static long long freeverb_smem_bytes(int sr, int max_spread) {
  long long total = 2LL * kCombs * kStride;
  for (int k = 0; k < kCombs; ++k) total += delay_size(sr, kCombTuningsHost[k], max_spread);
  for (int k = 0; k < kAllpasses; ++k) total += delay_size(sr, kAllpassTuningsHost[k], max_spread);
  return total * static_cast<long long>(sizeof(float));
}

extern "C" int aa_freeverb_ir(const float* feedback, const float* damp, const int* spreads,
                              float* ir, int n_ir, int n, int sr, int min_spread,
                              int max_spread, void* stream) {
  if (n_ir < 1 || n < 1 || sr < 1 || min_spread < 0) return cudaErrorInvalidValue;
  const long long smem = freeverb_smem_bytes(sr, max_spread);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      freeverb_ir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  freeverb_ir_kernel<<<n_ir, kIrThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      feedback, damp, spreads, ir, n, sr, freeverb_chunk(sr, min_spread));
  return cudaGetLastError();
}
