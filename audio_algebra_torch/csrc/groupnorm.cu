// Fused GroupNorm(num_groups=1) [+ tanh-GELU] [+ residual add] for Hopper
// (sm_90a), on a contiguous (B, C, T) tensor in float32 or bfloat16, with
// the turbo int8 variants of the apply pass.
//
// Replaces: audio_algebra_tpu/ops/pallas/groupnorm.py:groupnorm1_gelu_btc
// (its Pallas bodies _stats_kernel_tbc, _apply_kernel_tbc,
// _apply_res_kernel_tbc and _fused_gn_kernel_tbc: K1; and the turbo bodies
// _apply_quant_kernel_tbc, _apply_res_amax_kernel_tbc and
// _apply_res_amax_q_kernel_tbc: K2).
//
// Computes, for every batch row b (all C*T elements of it):
//   mu_b   = sum(x) / n,  var_b = max(sum(x*x) / n - mu_b^2, 0)   (f32)
//   rstd_b = 1 / sqrt(var_b + eps)
//   y      = gelu_tanh((x - mu_b) * rstd_b * scale_c + bias_c)
// with the one-pass sum / sum-of-squares formula of the JAX code (not
// Welford) so the two agree. K1 writes [res +] y in x's dtype. K2 modes:
//   quant       (K2a) int8 = clip(rint(y * qinv_c), +-127); y is not written
//   res_amax    (K2b) out = res + y (f32, then cast) and, per channel,
//                     amax_c = max over (B, T) of |out| taken in f32
//   res_amax_q  (K2c) K2b plus the int8 twin clip(rint(out_f32 * qinv_c))
// Rounding is round-half-to-even (__float2int_rn), as jnp.round.
//
// Bound: HBM bytes. The least traffic is one read of x (and of the
// residual) and one write of each output (int8: 1 byte an element). This
// design reads x twice (a statistics pass, then the apply pass), which
// caps it near 2/3 of that bound for K1 and K2b, 1/2 for K2a. Both passes
// use 16-byte vector loads and stores with neighbouring threads on
// neighbouring addresses; int8 stores are 4 or 8 bytes a thread. The
// statistics pass (common.cuh) writes per-block (sum, sumsq) partials to a
// [B, n_split, 2] f32 scratch with no atomics, so the order of the sums is
// fixed and the result is reproducible run to run. The TPU kernel carried
// the amax across its sequential grid; here blocks run in any order, so
// each block max-reduces |out| per channel into a shared-memory table
// (warp-aggregated: lanes on one channel reduce with __reduce_max_sync
// first), then max-accumulates the table into the (C,) output with
// atomicMax on the bit patterns of non-negative floats, whose integer
// order is their float order. Max is order-free, so the result is exact
// and reproducible. The statistics pass zeroes that output first.
//
// C interface (bound with ctypes): aa_groupnorm1_gelu (K1) and
// aa_groupnorm1_turbo (K2) launch both passes on the given stream,
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include "common.cuh"

namespace {

using aa::kThreads;
using aa::VecIO;

enum TurboMode { kQuant = 0, kResAmax = 1, kResAmaxQ = 2 };

__device__ __forceinline__ float gelu_tanh(float y) {
  return 0.5f * y * (1.0f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
}

// (mu, rstd) of batch row blockIdx.y from its statistics partials, shared
// by the whole block.
__device__ __forceinline__ void row_stats(const float* partials, int n_split, int n,
                                          float eps, float& mu, float& rstd) {
  __shared__ float s_mu, s_rstd;
  if (threadIdx.x < 32) {
    float m, r;
    aa::fold_partials(partials + static_cast<size_t>(blockIdx.y) * n_split * 2,
                      n_split, n, eps, m, r);
    if (threadIdx.x == 0) {
      s_mu = m;
      s_rstd = r;
    }
  }
  __syncthreads();
  mu = s_mu;
  rstd = s_rstd;
}

// grid (blocks_per_row, B): each block folds its row's partials into
// (mu, rstd), then normalises a grid-strided share of the row.
template <typename T, bool GELU, bool RES>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ partials,
                const T* __restrict__ scale, const T* __restrict__ bias,
                T* __restrict__ y, int n, int t_len, int n_split, float eps,
                int vec_ok) {
  constexpr int V = VecIO<T>::V;
  float mu, rstd;
  row_stats(partials, n_split, n, eps, mu, rstd);
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const T* xr = x + base;
  T* yr = y + base;
  const T* rr = RES ? res + base : nullptr;
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;

  int tail = 0;
  if (vec_ok) {
    const int nv = n / V;
    for (int j = first; j < nv; j += stride) {
      const int i = j * V;
      float v[V];
      VecIO<T>::load(xr + i, v);
      float r[V];
      if (RES) VecIO<T>::load(rr + i, r);
      int c = i / t_len;
      int t = i - c * t_len;
      float c_scale = VecIO<T>::get(scale + c), c_bias = VecIO<T>::get(bias + c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (t == t_len) {            // crossed into the next channel
          t = 0;
          ++c;
          c_scale = VecIO<T>::get(scale + c);
          c_bias = VecIO<T>::get(bias + c);
        }
        float o = (v[k] - mu) * rstd;
        o = o * c_scale + c_bias;
        if (GELU) o = gelu_tanh(o);
        if (RES) o = r[k] + o;
        v[k] = o;
        ++t;
      }
      VecIO<T>::store(yr + i, v);
    }
    tail = nv * V;
  }
  for (int i = tail + first; i < n; i += stride) {
    const int c = i / t_len;
    float o = (VecIO<T>::get(xr + i) - mu) * rstd;
    o = o * VecIO<T>::get(scale + c) + VecIO<T>::get(bias + c);
    if (GELU) o = gelu_tanh(o);
    if (RES) o = VecIO<T>::get(rr + i) + o;
    VecIO<T>::put(yr + i, o);
  }
}

__device__ __forceinline__ int quant8(float v, float qinv) {
  return __float2int_rn(fminf(fmaxf(v * qinv, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

// V int8 values in one 4- or 8-byte store.
template <int V> struct I8Store;
template <> struct I8Store<4> {
  static __device__ __forceinline__ void store(int8_t* p, const int (&q)[4]) {
    *reinterpret_cast<uint32_t*>(p) = pack4(q[0], q[1], q[2], q[3]);
  }
};
template <> struct I8Store<8> {
  static __device__ __forceinline__ void store(int8_t* p, const int (&q)[8]) {
    uint2 w;
    w.x = pack4(q[0], q[1], q[2], q[3]);
    w.y = pack4(q[4], q[5], q[6], q[7]);
    *reinterpret_cast<uint2*>(p) = w;
  }
};

// Max of m into the block's table at channel c, one shared atomic for the
// lanes of a warp that hold the same channel.
__device__ __forceinline__ void amax_warp(unsigned* s_amax, int c, float m) {
  const unsigned active = __activemask();
  const unsigned peers = __match_any_sync(active, c);
  const unsigned top = __reduce_max_sync(peers, __float_as_uint(m));
  if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1))
    atomicMax(s_amax + c, top);
}

// K2. grid (blocks_per_row, B), dynamic shared memory C * 4 bytes for the
// amax modes. Same walk over the row as gn_apply_kernel.
template <typename T, bool GELU, int MODE>
__global__ void __launch_bounds__(kThreads)
gn_turbo_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ partials,
                const T* __restrict__ scale, const T* __restrict__ bias,
                const float* __restrict__ qinv, T* __restrict__ y,
                int8_t* __restrict__ y8, unsigned* __restrict__ amax,
                int c_len, int n, int t_len, int n_split, float eps, int vec_ok) {
  constexpr int V = VecIO<T>::V;
  constexpr bool AMAX = MODE != kQuant;     // residual, float output, amax
  constexpr bool EMIT8 = MODE != kResAmax;  // int8 output
  extern __shared__ unsigned s_amax[];
  float mu, rstd;
  row_stats(partials, n_split, n, eps, mu, rstd);
  if (AMAX) {
    for (int k = threadIdx.x; k < c_len; k += kThreads) s_amax[k] = 0u;
    __syncthreads();
  }
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const T* xr = x + base;
  const T* rr = AMAX ? res + base : nullptr;
  T* yr = AMAX ? y + base : nullptr;
  int8_t* y8r = EMIT8 ? y8 + base : nullptr;
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;

  int tail = 0;
  if (vec_ok) {
    const int nv = n / V;
    for (int j = first; j < nv; j += stride) {
      const int i = j * V;
      float v[V];
      VecIO<T>::load(xr + i, v);
      float r[V];
      if (AMAX) VecIO<T>::load(rr + i, r);
      int c = i / t_len;
      int t = i - c * t_len;
      float c_scale = VecIO<T>::get(scale + c), c_bias = VecIO<T>::get(bias + c);
      float c_qinv = EMIT8 ? qinv[c] : 0.f;
      float m = 0.f;
      int q[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (t == t_len) {            // crossed into the next channel
          if (AMAX) {
            atomicMax(s_amax + c, __float_as_uint(m));
            m = 0.f;
          }
          t = 0;
          ++c;
          c_scale = VecIO<T>::get(scale + c);
          c_bias = VecIO<T>::get(bias + c);
          if (EMIT8) c_qinv = qinv[c];
        }
        float o = (v[k] - mu) * rstd;
        o = o * c_scale + c_bias;
        if (GELU) o = gelu_tanh(o);
        if (AMAX) {
          o = r[k] + o;
          m = fmaxf(m, fabsf(o));
        }
        if (EMIT8) q[k] = quant8(o, c_qinv);
        v[k] = o;
        ++t;
      }
      if (AMAX) {
        VecIO<T>::store(yr + i, v);
        amax_warp(s_amax, c, m);
      }
      if (EMIT8) I8Store<V>::store(y8r + i, q);
    }
    tail = nv * V;
  }
  for (int i = tail + first; i < n; i += stride) {
    const int c = i / t_len;
    float o = (VecIO<T>::get(xr + i) - mu) * rstd;
    o = o * VecIO<T>::get(scale + c) + VecIO<T>::get(bias + c);
    if (GELU) o = gelu_tanh(o);
    if (AMAX) {
      o = VecIO<T>::get(rr + i) + o;
      VecIO<T>::put(yr + i, o);
      atomicMax(s_amax + c, __float_as_uint(fabsf(o)));
    }
    if (EMIT8) y8r[i] = static_cast<int8_t>(quant8(o, qinv[c]));
  }
  if (AMAX) {
    __syncthreads();
    for (int k = threadIdx.x; k < c_len; k += kThreads) {
      const unsigned a = s_amax[k];
      if (a) atomicMax(amax + k, a);
    }
  }
}

template <typename T, bool GELU, bool RES>
void launch_apply(dim3 grid, cudaStream_t st, const void* x, const void* res,
                  const float* partials, const void* scale, const void* bias,
                  void* y, int n, int t_len, int n_split, float eps, int vec_ok) {
  gn_apply_kernel<T, GELU, RES><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), partials,
      static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(y), n, t_len, n_split, eps, vec_ok);
}

template <typename T>
void launch_all(int b, int c, int t_len, int n_split, int apply_blocks,
                int gelu, int has_res, float eps, int vec_ok,
                const void* x, const void* res, const void* scale,
                const void* bias, void* y, float* partials, cudaStream_t st) {
  const int n = c * t_len;
  aa::launch_stats<T>(x, partials, b, n, n_split, vec_ok, st);
  const dim3 grid(apply_blocks, b);
  if (gelu && has_res)
    launch_apply<T, true, true>(grid, st, x, res, partials, scale, bias, y, n, t_len, n_split, eps, vec_ok);
  else if (gelu)
    launch_apply<T, true, false>(grid, st, x, res, partials, scale, bias, y, n, t_len, n_split, eps, vec_ok);
  else if (has_res)
    launch_apply<T, false, true>(grid, st, x, res, partials, scale, bias, y, n, t_len, n_split, eps, vec_ok);
  else
    launch_apply<T, false, false>(grid, st, x, res, partials, scale, bias, y, n, t_len, n_split, eps, vec_ok);
}

template <typename T, bool GELU, int MODE>
void launch_turbo_mode(dim3 grid, cudaStream_t st, const void* x, const void* res,
                       const float* partials, const void* scale, const void* bias,
                       const float* qinv, void* y, void* y8, unsigned* amax, int c,
                       int n, int t_len, int n_split, float eps, int vec_ok) {
  const size_t smem = MODE == kQuant ? 0 : static_cast<size_t>(c) * sizeof(unsigned);
  gn_turbo_kernel<T, GELU, MODE><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), partials,
      static_cast<const T*>(scale), static_cast<const T*>(bias), qinv,
      static_cast<T*>(y), static_cast<int8_t*>(y8), amax, c, n, t_len, n_split,
      eps, vec_ok);
}

template <typename T, bool GELU>
int launch_turbo_gelu(int mode, dim3 grid, cudaStream_t st, const void* x,
                      const void* res, const float* partials, const void* scale,
                      const void* bias, const float* qinv, void* y, void* y8,
                      unsigned* amax, int c, int n, int t_len, int n_split,
                      float eps, int vec_ok) {
  if (mode == kQuant)
    launch_turbo_mode<T, GELU, kQuant>(grid, st, x, res, partials, scale, bias, qinv, y, y8, amax, c, n, t_len, n_split, eps, vec_ok);
  else if (mode == kResAmax)
    launch_turbo_mode<T, GELU, kResAmax>(grid, st, x, res, partials, scale, bias, qinv, y, y8, amax, c, n, t_len, n_split, eps, vec_ok);
  else if (mode == kResAmaxQ)
    launch_turbo_mode<T, GELU, kResAmaxQ>(grid, st, x, res, partials, scale, bias, qinv, y, y8, amax, c, n, t_len, n_split, eps, vec_ok);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int launch_turbo(int mode, int b, int c, int t_len, int n_split, int apply_blocks,
                 int gelu, float eps, int vec_ok, const void* x, const void* res,
                 const void* scale, const void* bias, const float* qinv, void* y,
                 void* y8, unsigned* amax, float* partials, cudaStream_t st) {
  const int n = c * t_len;
  aa::launch_stats<T>(x, partials, b, n, n_split, vec_ok, st,
                      mode == kQuant ? nullptr : amax, c);
  const dim3 grid(apply_blocks, b);
  if (gelu)
    return launch_turbo_gelu<T, true>(mode, grid, st, x, res, partials, scale, bias, qinv, y, y8, amax, c, n, t_len, n_split, eps, vec_ok);
  return launch_turbo_gelu<T, false>(mode, grid, st, x, res, partials, scale, bias, qinv, y, y8, amax, c, n, t_len, n_split, eps, vec_ok);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. res may be null (has_res = 0).
// partials: [b, n_split, 2] float32 scratch. Returns cudaGetLastError().
extern "C" int aa_groupnorm1_gelu(int dtype, const void* x, const void* res,
                                  const void* scale, const void* bias, void* y,
                                  void* partials, int b, int c, int t_len,
                                  int n_split, int apply_blocks, int gelu,
                                  int has_res, float eps, int vec_ok,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (dtype == 0)
    launch_all<float>(b, c, t_len, n_split, apply_blocks, gelu, has_res, eps,
                      vec_ok, x, res, scale, bias, y, part, st);
  else if (dtype == 1)
    launch_all<__nv_bfloat16>(b, c, t_len, n_split, apply_blocks, gelu, has_res,
                              eps, vec_ok, x, res, scale, bias, y, part, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K2. mode: 0 = quant (x -> y8), 1 = res_amax (x, res -> y, amax),
// 2 = res_amax_q (x, res -> y, amax, y8). qinv: (c,) float32 (modes 0, 2);
// amax: (c,) float32, zeroed here by the statistics pass (modes 1, 2);
// y8: int8 like x (modes 0, 2). Returns cudaGetLastError().
extern "C" int aa_groupnorm1_turbo(int dtype, int mode, const void* x, const void* res,
                                   const void* scale, const void* bias,
                                   const void* qinv, void* y, void* y8, void* amax,
                                   void* partials, int b, int c, int t_len,
                                   int n_split, int apply_blocks, int gelu, float eps,
                                   int vec_ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  const float* qi = static_cast<const float*>(qinv);
  unsigned* am = static_cast<unsigned*>(amax);
  int err;
  if (dtype == 0)
    err = launch_turbo<float>(mode, b, c, t_len, n_split, apply_blocks, gelu, eps,
                              vec_ok, x, res, scale, bias, qi, y, y8, am, part, st);
  else if (dtype == 1)
    err = launch_turbo<__nv_bfloat16>(mode, b, c, t_len, n_split, apply_blocks, gelu,
                                      eps, vec_ok, x, res, scale, bias, qi, y, y8, am,
                                      part, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
