// Pieces shared by the port's kernels: 16-byte vector IO in f32 or bf16
// and bf16 packing (all kernels); fixed-order warp and block sums and,
// for the GroupNorm kernels (groupnorm.cu: K1, grouped_gn.cu: K5), the
// statistics pass that writes per-block (sum, sumsq) partials of
// contiguous rows with no atomics, so the order of the sums is fixed and
// the result is reproducible run to run.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace aa {

constexpr int kThreads = 256;

// 16-byte vector load/store of V elements, converted to and from f32.
template <typename T> struct VecIO;

template <> struct VecIO<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* p, float (&o)[V]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&o)[V]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

template <> struct VecIO<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&o)[V]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    o[0] = bf16_lo(v.x); o[1] = bf16_hi(v.x);
    o[2] = bf16_lo(v.y); o[3] = bf16_hi(v.y);
    o[4] = bf16_lo(v.z); o[5] = bf16_hi(v.z);
    o[6] = bf16_lo(v.w); o[7] = bf16_hi(v.w);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&o)[V]) {
    uint4 v;
    v.x = bf16_pack(o[0], o[1]);
    v.y = bf16_pack(o[2], o[3]);
    v.z = bf16_pack(o[4], o[5]);
    v.w = bf16_pack(o[6], o[7]);
    *reinterpret_cast<uint4*>(p) = v;
  }
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of (a, b) over the block, in a fixed order; the result is valid in
// thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32], sb[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) { sa[warp] = a; sb[warp] = b; }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0.f;
    b = lane < kThreads / 32 ? sb[lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// grid (n_split, rows): block s of row r reduces the slice [lo, hi) of the
// row's n contiguous elements into partials[r, s, 0:2] = (sum, sumsq).
// Block (0, 0) also zeroes `zero[0:zero_n]` when it is given: the turbo
// apply pass (groupnorm.cu) max-accumulates its amax there, and this saves
// it a separate fill launch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                int n, int per, int n_split, int vec_ok,
                unsigned* __restrict__ zero, int zero_n) {
  constexpr int V = VecIO<T>::V;
  const int b = blockIdx.y, s = blockIdx.x;
  if (zero != nullptr && b == 0 && s == 0)
    for (int k = threadIdx.x; k < zero_n; k += kThreads) zero[k] = 0u;
  const T* row = x + static_cast<size_t>(b) * n;
  const int lo = s * per;
  const int hi = min(n, lo + per);
  float s1 = 0.f, s2 = 0.f;
  int tail = lo;
  if (vec_ok && hi > lo) {
    const int vhi = lo + ((hi - lo) / V) * V;
    for (int i = lo + threadIdx.x * V; i < vhi; i += kThreads * V) {
      float v[V];
      VecIO<T>::load(row + i, v);
#pragma unroll
      for (int k = 0; k < V; ++k) { s1 += v[k]; s2 += v[k] * v[k]; }
    }
    tail = vhi;
  }
  for (int i = tail + threadIdx.x; i < hi; i += kThreads) {
    const float v = VecIO<T>::get(row + i);
    s1 += v;
    s2 += v * v;
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    float* p = partials + (static_cast<size_t>(b) * n_split + s) * 2;
    p[0] = s1;
    p[1] = s2;
  }
}

// Launch the statistics pass over `rows` rows of n elements each.
template <typename T>
void launch_stats(const void* x, float* partials, int rows, int n, int n_split,
                  int vec_ok, cudaStream_t st, unsigned* zero = nullptr,
                  int zero_n = 0) {
  constexpr int V = VecIO<T>::V;
  int per = (n + n_split - 1) / n_split;
  per = ((per + V - 1) / V) * V;
  gn_stats_kernel<T><<<dim3(n_split, rows), kThreads, 0, st>>>(
      static_cast<const T*>(x), partials, n, per, n_split, vec_ok, zero, zero_n);
}

// Fold a row's n_split partials into (mean, rstd) in f32, in a fixed
// order, with the variance clamped at 0. Called by threads 0..31 of a
// block; the result is valid in thread 0.
__device__ __forceinline__ void fold_partials(const float* p, int n_split, int n,
                                              float eps, float& mu, float& rstd) {
  float a = 0.f, c = 0.f;
  for (int k = threadIdx.x; k < n_split; k += 32) { a += p[2 * k]; c += p[2 * k + 1]; }
  a = warp_sum(a);
  c = warp_sum(c);
  mu = a / static_cast<float>(n);
  const float var = fmaxf(c / static_cast<float>(n) - mu * mu, 0.f);
  rstd = 1.0f / sqrtf(var + eps);
}

}  // namespace aa
