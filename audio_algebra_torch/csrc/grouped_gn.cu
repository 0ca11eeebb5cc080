// Grouped GroupNorm + FiLM + SiLU for Hopper (sm_90a), on a contiguous
// (B, C, T) tensor in float32 or bfloat16: kernel K5 of the port.
//
// Replaces: audio_algebra_tpu/ops/pallas/groupnorm_grouped.py:
// grouped_gn_film_silu (its Pallas apply kernels _affine_silu_kernel and
// _flat_affine_silu_kernel, launched by _pallas_apply, and the XLA
// statistics reduce in front of them).
//
// Computes, for batch b and group g (channels g*C/G .. (g+1)*C/G - 1):
//   mu, var over the group's (C/G) * T elements in f32 (one-pass sum and
//   sum of squares, the variance clamped at 0), rstd = 1 / sqrt(var + eps)
//   S_bc = rstd * scale_c              [* (1 + fs_bc)]
//   T_bc = (bias_c - mu * S_bc')       [* (1 + fs_bc)] [+ shift_bc]
//   y    = [silu](x * S_bc + T_bc), in x's dtype
// with S_bc' = rstd * scale_c, in the order of groupnorm_grouped.py:161-181.
//
// Layout: in (B, C, T) group g of batch b is one contiguous span of
// (C/G) * T elements, so the kernel is K1's two-pass design (groupnorm.cu)
// over B * G rows: a statistics pass (common.cuh) writes fixed-order
// (sum, sumsq) partials with no atomics, then an apply pass folds a row's
// partials and writes y with 16-byte vector loads and stores.
//
// Bound: HBM bytes. The least traffic is one read of x and one write of y
// (2.5 us at (2, 512, 2048) bf16 on an H100 SXM); this design reads x
// twice, so it reaches at most 2/3 of that. The main path's calls are
// small (8.4 MB at the largest), so launch cost, not bytes, sets their
// time at the deep levels.
//
// C interface (bound with ctypes): aa_grouped_gn_film_silu launches both
// passes on the given stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError().

#include "common.cuh"

namespace {

using aa::kThreads;
using aa::VecIO;

__device__ __forceinline__ float silu(float y) { return y / (1.0f + __expf(-y)); }

// Per-channel (S, T) of batch b at channel c, from the row's (mu, rstd).
template <typename T, bool FS, bool SH>
__device__ __forceinline__ void channel_affine(const T* scale, const T* bias,
                                               const T* fs, const T* sh, int c,
                                               float mu, float rstd,
                                               float& s_c, float& t_c) {
  s_c = rstd * VecIO<T>::get(scale + c);
  t_c = VecIO<T>::get(bias + c) - mu * s_c;
  if (FS) {
    const float f = 1.0f + VecIO<T>::get(fs + c);
    s_c *= f;
    t_c *= f;
  }
  if (SH) t_c += VecIO<T>::get(sh + c);
}

// grid (blocks_per_row, B * G): each block folds its row's partials into
// (mu, rstd), then applies the affine to a grid-strided share of the row.
template <typename T, bool FS, bool SH, bool SILU>
__global__ void __launch_bounds__(kThreads)
ggn_apply_kernel(const T* __restrict__ x, const float* __restrict__ partials,
                 const T* __restrict__ scale, const T* __restrict__ bias,
                 const T* __restrict__ film_scale, const T* __restrict__ film_shift,
                 int film_stride, T* __restrict__ y, int groups, int cg, int t_len,
                 int n_split, float eps, int vec_ok) {
  constexpr int V = VecIO<T>::V;
  __shared__ float s_mu, s_rstd;
  const int row = blockIdx.y;
  const int n = cg * t_len;
  if (threadIdx.x < 32) {
    float mu, rstd;
    aa::fold_partials(partials + static_cast<size_t>(row) * n_split * 2, n_split, n,
                      eps, mu, rstd);
    if (threadIdx.x == 0) {
      s_mu = mu;
      s_rstd = rstd;
    }
  }
  __syncthreads();
  const float mu = s_mu, rstd = s_rstd;
  const int b = row / groups, c0 = (row - b * groups) * cg;
  const T* sc = scale + c0;
  const T* bi = bias + c0;
  const T* fs = FS ? film_scale + static_cast<size_t>(b) * film_stride + c0 : nullptr;
  const T* sh = SH ? film_shift + static_cast<size_t>(b) * film_stride + c0 : nullptr;
  const size_t base = static_cast<size_t>(row) * n;
  const T* xr = x + base;
  T* yr = y + base;
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;

  int tail = 0;
  if (vec_ok) {
    const int nv = n / V;
    for (int j = first; j < nv; j += stride) {
      const int i = j * V;
      float v[V];
      VecIO<T>::load(xr + i, v);
      int c = i / t_len;
      int t = i - c * t_len;
      float s_c, t_c;
      channel_affine<T, FS, SH>(sc, bi, fs, sh, c, mu, rstd, s_c, t_c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (t == t_len) {            // crossed into the next channel
          t = 0;
          ++c;
          channel_affine<T, FS, SH>(sc, bi, fs, sh, c, mu, rstd, s_c, t_c);
        }
        float o = v[k] * s_c + t_c;
        if (SILU) o = silu(o);
        v[k] = o;
        ++t;
      }
      VecIO<T>::store(yr + i, v);
    }
    tail = nv * V;
  }
  for (int i = tail + first; i < n; i += stride) {
    float s_c, t_c;
    channel_affine<T, FS, SH>(sc, bi, fs, sh, i / t_len, mu, rstd, s_c, t_c);
    float o = VecIO<T>::get(xr + i) * s_c + t_c;
    if (SILU) o = silu(o);
    VecIO<T>::put(yr + i, o);
  }
}

template <typename T, bool FS, bool SH, bool SILU>
void launch_apply(dim3 grid, cudaStream_t st, const void* x, const float* partials,
                  const void* scale, const void* bias, const void* fs,
                  const void* sh, int film_stride, void* y, int groups, int cg,
                  int t_len, int n_split, float eps, int vec_ok) {
  ggn_apply_kernel<T, FS, SH, SILU><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), partials, static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<const T*>(fs),
      static_cast<const T*>(sh), film_stride, static_cast<T*>(y), groups, cg,
      t_len, n_split, eps, vec_ok);
}

template <typename T>
void launch_all(int b, int c, int t_len, int groups, int n_split, int apply_blocks,
                int silu_on, float eps, int vec_ok, const void* x,
                const void* scale, const void* bias, const void* fs,
                const void* sh, int film_stride, void* y, float* partials,
                cudaStream_t st) {
  const int cg = c / groups, rows = b * groups;
  aa::launch_stats<T>(x, partials, rows, cg * t_len, n_split, vec_ok, st);
  const dim3 grid(apply_blocks, rows);
  const int mode = (fs != nullptr) * 4 + (sh != nullptr) * 2 + (silu_on != 0);
#define AA_GGN_CASE(M, F, S, L)                                                   \
  case M:                                                                         \
    launch_apply<T, F, S, L>(grid, st, x, partials, scale, bias, fs, sh,          \
                             film_stride, y, groups, cg, t_len, n_split, eps,     \
                             vec_ok);                                             \
    break;
  switch (mode) {
    AA_GGN_CASE(0, false, false, false)
    AA_GGN_CASE(1, false, false, true)
    AA_GGN_CASE(2, false, true, false)
    AA_GGN_CASE(3, false, true, true)
    AA_GGN_CASE(4, true, false, false)
    AA_GGN_CASE(5, true, false, true)
    AA_GGN_CASE(6, true, true, false)
    AA_GGN_CASE(7, true, true, true)
  }
#undef AA_GGN_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. film_scale / film_shift may be null;
// when given they are (B, C) rows `film_stride` elements apart, in x's
// dtype. partials: [B * groups, n_split, 2] float32 scratch. Returns
// cudaGetLastError().
extern "C" int aa_grouped_gn_film_silu(int dtype, const void* x, const void* scale,
                                       const void* bias, const void* film_scale,
                                       const void* film_shift, int film_stride,
                                       void* y, void* partials, int b, int c,
                                       int t_len, int groups, int n_split,
                                       int apply_blocks, int silu_on, float eps,
                                       int vec_ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (groups <= 0 || c % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    launch_all<float>(b, c, t_len, groups, n_split, apply_blocks, silu_on, eps,
                      vec_ok, x, scale, bias, film_scale, film_shift, film_stride,
                      y, part, st);
  else if (dtype == 1)
    launch_all<__nv_bfloat16>(b, c, t_len, groups, n_split, apply_blocks, silu_on,
                              eps, vec_ok, x, scale, bias, film_scale, film_shift,
                              film_stride, y, part, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
