// Fused GroupNorm(num_groups=1) [+ tanh-GELU] [+ residual add] for Hopper
// (sm_90a), on a contiguous (B, C, T) tensor in float32 or bfloat16.
//
// Replaces: audio_algebra_tpu/ops/pallas/groupnorm.py:groupnorm1_gelu_btc
// (its Pallas bodies _stats_kernel_tbc, _apply_kernel_tbc,
// _apply_res_kernel_tbc and _fused_gn_kernel_tbc; the turbo int8 variants
// are not ported here).
//
// Computes, for every batch row b (all C*T elements of it):
//   mu_b   = sum(x) / n,  var_b = max(sum(x*x) / n - mu_b^2, 0)   (f32)
//   rstd_b = 1 / sqrt(var_b + eps)
//   y      = [res +] gelu_tanh((x - mu_b) * rstd_b * scale_c + bias_c)
// with the one-pass sum / sum-of-squares formula of the JAX code (not
// Welford) so the two agree, and the output in x's dtype.
//
// Bound: HBM bytes. The least traffic is one read of x (and of the
// residual) and one write of y. This design reads x twice (a statistics
// pass, then the apply pass), so without a residual it reaches at most
// about 2/3 of that bound, and 3/4 with one. Both passes use 16-byte
// vector loads and stores with neighbouring threads on neighbouring
// addresses. The statistics pass (common.cuh) writes per-block
// (sum, sumsq) partials to a [B, n_split, 2] f32 scratch with no atomics,
// so the order of the sums is fixed and the result is reproducible run to
// run.
//
// C interface (bound with ctypes): aa_groupnorm1_gelu launches both
// passes on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include "common.cuh"

namespace {

using aa::kThreads;
using aa::VecIO;

__device__ __forceinline__ float gelu_tanh(float y) {
  return 0.5f * y * (1.0f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
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
  __shared__ float s_mu, s_rstd;
  const int b = blockIdx.y;
  if (threadIdx.x < 32) {
    float mu, rstd;
    aa::fold_partials(partials + static_cast<size_t>(b) * n_split * 2, n_split, n,
                      eps, mu, rstd);
    if (threadIdx.x == 0) {
      s_mu = mu;
      s_rstd = rstd;
    }
  }
  __syncthreads();
  const float mu = s_mu, rstd = s_rstd;
  const size_t base = static_cast<size_t>(b) * n;
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
