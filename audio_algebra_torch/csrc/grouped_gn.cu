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
// Layout: in (B, C, T) group g of batch b is one contiguous row of
// n = (C/G) * T elements. Two routes, chosen by shape on the host
// (ops/groupnorm_grouped.py: ggn_plan):
//
//   cluster (aa_ggn_cluster): one launch; a row goes to one thread-block
//     cluster of cs CTAs (1 to 16). Each CTA copies its slice of the row
//     into shared memory ONCE, by bulk copies (cp.async.bulk, in four
//     chunks on four mbarriers, so the sums start on the first chunk while
//     the rest arrive), sums x and x^2 in f32, and posts its (sum, sumsq)
//     in its shared memory. After a cluster barrier every CTA reads the
//     cs partials through distributed shared memory and folds them in rank
//     order, so every CTA, and every run, gets the same bits. Each CTA then
//     computes the (S, T) planes of the channels its slice touches and
//     writes y from its resident slice. Traffic: one read of x, one write
//     of y, no scratch tensor.
//   two_pass (aa_ggn_two_pass): rows whose slice would not fit the shared
//     memory of a CTA even at 16 CTAs a cluster: K1's two-pass design
//     (groupnorm.cu) over B * G rows, a statistics pass (common.cuh)
//     writing fixed-order (sum, sumsq) partials with no atomics, then an
//     apply pass that folds a row's partials and writes y. Reads x twice.
//
// Bound: HBM bytes. The least traffic is one read of x and one write of y
// (2.5 us at (2, 512, 2048) bf16 on an H100 SXM), which the cluster route
// moves. At the main path's sizes (12.6 MB of x at the largest) the time
// goes to the launch, the chain load -> sums -> cluster barrier -> apply
// (no store can start before the statistics), and the apply's SiLU on
// the MUFU pipe: one tanh.approx an element in bf16, ex2 and a reciprocal
// in f32 (PERF.md, PR 8).
//
// C interface (bound with ctypes): each entry launches on the given
// stream, allocates nothing, does not synchronise, returns
// cudaErrorInvalidValue before any launch when an argument is out of range
// (groups <= 0 among them), and else cudaGetLastError().

#include <cooperative_groups.h>

#include "common.cuh"

namespace cgs = cooperative_groups;

namespace {

using aa::kThreads;
using aa::VecIO;

constexpr int kChunks = 4;               // bulk copies (and mbarriers) a slice
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
// Dynamic shared memory a CTA of the cluster route may ask for: the H100's
// 227 KB a block, less 2 KB for the kernel's static shared memory.
// ops/groupnorm_grouped.py: SMEM_BUDGET is the same number.
constexpr int kMaxDynamicSmem = 225 * 1024;

__device__ __forceinline__ float silu(float y) { return y / (1.0f + __expf(-y)); }
// The cluster route's SiLU, whose MUFU operations bound its apply: in f32
// with the fast division (2 ulp; 0 where 1 + e^-y overflows), two
// operations; for bf16 outputs, whose rounding is 2^-9, as y sigmoid(y) =
// h + h tanh(h), h = y / 2, one (tanh.approx, ~2^-11 relative).
__device__ __forceinline__ float fast_silu(float y) {
  return __fdividef(y, 1.0f + __expf(-y));
}
__device__ __forceinline__ float tanh_silu(float y) {
  const float h = 0.5f * y;
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

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

// ------------------------------------------------------------- cluster ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Sum of (a, b) over a block of any multiple of 32 threads up to 1024, in
// a fixed order; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2_any(float& a, float& b) {
  __shared__ float sa[32], sb[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  a = aa::warp_sum(a);
  b = aa::warp_sum(b);
  if (lane == 0) { sa[warp] = a; sb[warp] = b; }
  __syncthreads();
  if (warp == 0) {
    a = lane < warps ? sa[lane] : 0.f;
    b = lane < warps ? sb[lane] : 0.f;
    a = aa::warp_sum(a);
    b = aa::warp_sum(b);
  }
}

// grid (cs, B * G), clusters of (cs, 1, 1): CTA `rank` of row `row` owns
// elements [rank * per, rank * per + per) of the row (per a multiple of
// the vector width; the last slice may be short or empty). Dynamic shared
// memory: the slice (per elements, rounded up to 16 bytes), then for each
// channel the slice touches its (scale, bias, film scale, film shift),
// loaded while the slice is in flight, and its (S, T) plane.
template <typename T, bool FS, bool SH, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
ggn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ bias, const T* __restrict__ film_scale,
                   const T* __restrict__ film_shift, int film_stride,
                   T* __restrict__ y, int groups, int cg, int t_len, int per,
                   float eps, int vec_ok) {
  constexpr int V = VecIO<T>::V;
  constexpr bool kBf16 = sizeof(T) == 2;   // SiLU in tanh form (one MUFU operation)
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kChunks];
  __shared__ float2 part;
  __shared__ float s_mu, s_rstd;

  const int cs = gridDim.x;              // the cluster spans the row
  const int rank = blockIdx.x;           // == the CTA's rank in its cluster
  const int row = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int n = cg * t_len;
  const int lo = rank * per;
  const int len = max(0, min(per, n - lo));
  const size_t base = static_cast<size_t>(row) * n + lo;
  const int ch_first = lo / t_len;
  const int ch_count = len > 0 ? (lo + len - 1) / t_len - ch_first + 1 : 0;
  T* buf = reinterpret_cast<T*>(smem);
  float4* params = reinterpret_cast<float4*>(
      smem + ((static_cast<size_t>(per) * sizeof(T) + 15) & ~static_cast<size_t>(15)));
  float2* planes = reinterpret_cast<float2*>(params + ch_count);

  // 1. the slice into shared memory, once; the channels' parameters
  //    meanwhile; the sums as the chunks land
  const int b = row / groups, c0 = (row - b * groups) * cg;
  if (vec_ok && tid == 0) {
    for (int k = 0; k < kChunks; ++k) mbar_init(&bars[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int ce = ((len + kChunks - 1) / kChunks + V - 1) / V * V;   // chunk elements
    for (int k = 0; k < kChunks; ++k) {
      const int a0 = min(len, k * ce), a1 = min(len, a0 + ce);
      const unsigned bytes = static_cast<unsigned>(a1 - a0) * sizeof(T);
      mbar_expect_tx(&bars[k], bytes);
      if (bytes) bulk_load(buf + a0, x + base + a0, bytes, &bars[k]);
    }
  }
  for (int k = tid; k < ch_count; k += nt) {
    const int c = c0 + ch_first + k;
    const size_t f = static_cast<size_t>(b) * film_stride + c;
    params[k] = make_float4(VecIO<T>::get(scale + c), VecIO<T>::get(bias + c),
                            FS ? 1.0f + VecIO<T>::get(film_scale + f) : 1.0f,
                            SH ? VecIO<T>::get(film_shift + f) : 0.0f);
  }
  float s1 = 0.f, s2 = 0.f;
  if (vec_ok) {
    __syncthreads();                     // the barriers are initialised
    const int ce = ((len + kChunks - 1) / kChunks + V - 1) / V * V;
    for (int k = 0; k < kChunks; ++k) {
      const int a0 = min(len, k * ce), a1 = min(len, a0 + ce);
      mbar_wait(&bars[k], 0);
      for (int i = a0 + tid * V; i < a1; i += nt * V) {
        float v[V];
        VecIO<T>::load(buf + i, v);
#pragma unroll
        for (int j = 0; j < V; ++j) { s1 += v[j]; s2 += v[j] * v[j]; }
      }
    }
  } else {
    for (int i = tid; i < len; i += nt) {
      const T e = x[base + i];
      buf[i] = e;
      const float v = VecIO<T>::get(&e);
      s1 += v;
      s2 += v * v;
    }
  }

  // 2. this CTA's partials, then the cluster's: lane r of warp 0 reads
  //    rank r's, lane 0 folds them in rank order
  block_sum2_any(s1, s2);
  if (tid == 0) part = make_float2(s1, s2);
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (tid < 32) {
    float2 p = make_float2(0.f, 0.f);
    if (cs > 1) {
      if (tid < cs) p = *cgs::this_cluster().map_shared_rank(&part, tid);
    } else {
      p = part;
    }
    float a = 0.f, c = 0.f;
    for (int r = 0; r < cs; ++r) {
      a += __shfl_sync(0xffffffffu, p.x, r);
      c += __shfl_sync(0xffffffffu, p.y, r);
    }
    if (tid == 0) {
      const float mu = a / static_cast<float>(n);
      const float var = fmaxf(c / static_cast<float>(n) - mu * mu, 0.f);
      s_mu = mu;
      s_rstd = 1.0f / sqrtf(var + eps);
    }
  }
  __syncthreads();
  // the partials have been read: the other CTAs may exit once this CTA's
  // arrival is in (the matching wait is the last thing before returning)
  if (cs > 1) cluster_arrive();

  // 3. the planes of the slice's channels, in groupnorm_grouped.py's order
  const float mu = s_mu, rstd = s_rstd;
  for (int k = tid; k < ch_count; k += nt) {
    const float4 q = params[k];
    float s_c = rstd * q.x;
    float t_c = q.y - mu * s_c;
    if (FS) {
      s_c *= q.z;
      t_c *= q.z;
    }
    if (SH) t_c += q.w;
    planes[k] = make_float2(s_c, t_c);
  }
  __syncthreads();

  // 4. y from the resident slice
  T* yr = y + base;
  if (vec_ok && t_len % V == 0) {        // a vector never straddles two channels
    for (int i = tid * V; i < len; i += nt * V) {
      float v[V];
      VecIO<T>::load(buf + i, v);
      const float2 st = planes[(lo + i) / t_len - ch_first];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float o = v[j] * st.x + st.y;
        if (SILU) o = kBf16 ? tanh_silu(o) : fast_silu(o);
        v[j] = o;
      }
      VecIO<T>::store(yr + i, v);
    }
  } else {
    for (int i = tid; i < len; i += nt) {
      const float2 st = planes[(lo + i) / t_len - ch_first];
      float o = VecIO<T>::get(buf + i) * st.x + st.y;
      if (SILU) o = kBf16 ? tanh_silu(o) : fast_silu(o);
      VecIO<T>::put(yr + i, o);
    }
  }
  if (cs > 1) cluster_wait();            // no CTA leaves while its part may be read
}

template <typename T, bool FS, bool SH, bool SILU>
int launch_cluster(const void* x, const void* scale, const void* bias, const void* fs,
                   const void* sh, int film_stride, void* y, int rows, int groups,
                   int cg, int t_len, int cs, int threads, int per, int smem, float eps,
                   int vec_ok, cudaStream_t st) {
  auto kernel = ggn_cluster_kernel<T, FS, SH, SILU>;
  static bool configured = false;        // attributes set once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, rows);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<const T*>(fs), static_cast<const T*>(sh),
      film_stride, static_cast<T*>(y), groups, cg, t_len, per, eps, vec_ok);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// ------------------------------------------------------------ two pass ---

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
int launch_two_pass(const void* x, const void* scale, const void* bias, const void* fs,
                    const void* sh, int film_stride, void* y, float* partials, int rows,
                    int groups, int cg, int t_len, int n_split, int apply_blocks,
                    float eps, int vec_ok, cudaStream_t st) {
  aa::launch_stats<T>(x, partials, rows, cg * t_len, n_split, vec_ok, st);
  ggn_apply_kernel<T, FS, SH, SILU><<<dim3(apply_blocks, rows), kThreads, 0, st>>>(
      static_cast<const T*>(x), partials, static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<const T*>(fs), static_cast<const T*>(sh),
      film_stride, static_cast<T*>(y), groups, cg, t_len, n_split, eps, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// The eight (FiLM scale, FiLM shift, SiLU) instantiations of a launcher.
#define AA_GGN_DISPATCH(LAUNCH, T, MODE, ...)                     \
  switch (MODE) {                                                 \
    case 0: return LAUNCH<T, false, false, false>(__VA_ARGS__);   \
    case 1: return LAUNCH<T, false, false, true>(__VA_ARGS__);    \
    case 2: return LAUNCH<T, false, true, false>(__VA_ARGS__);    \
    case 3: return LAUNCH<T, false, true, true>(__VA_ARGS__);     \
    case 4: return LAUNCH<T, true, false, false>(__VA_ARGS__);    \
    case 5: return LAUNCH<T, true, false, true>(__VA_ARGS__);     \
    case 6: return LAUNCH<T, true, true, false>(__VA_ARGS__);     \
    default: return LAUNCH<T, true, true, true>(__VA_ARGS__);     \
  }

}  // namespace

// The cluster route. plan: int[9] on the host, fixed per shape: {b, c,
// t_len, groups, cs, threads, per, smem, film_stride}; flags: bit 0 dtype
// (0 float32, 1 bfloat16), bit 1 SiLU, bit 2 vec_ok (n a multiple of the
// 16-byte vector and x 16-byte aligned; then each slice arrives by bulk
// copies). film_scale / film_shift may be null; when given they are (B, C)
// rows film_stride elements apart, in x's dtype.
extern "C" int aa_ggn_cluster(const int* plan, int flags, float eps, const void* x,
                              const void* scale, const void* bias, const void* film_scale,
                              const void* film_shift, void* y, void* stream) {
  const int b = plan[0], c = plan[1], t_len = plan[2], groups = plan[3], cs = plan[4],
            threads = plan[5], per = plan[6], smem = plan[7], film_stride = plan[8];
  if (groups <= 0 || c % groups != 0 || cs < 1 || cs > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || smem > kMaxDynamicSmem ||
      per <= 0 || static_cast<long long>(per) * cs < static_cast<long long>(c / groups) * t_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mode = (film_scale != nullptr) * 4 + (film_shift != nullptr) * 2 + ((flags >> 1) & 1);
  const int vec_ok = (flags >> 2) & 1, rows = b * groups, cg = c / groups;
  if (flags & 1) {
    AA_GGN_DISPATCH(launch_cluster, __nv_bfloat16, mode, x, scale, bias, film_scale,
                    film_shift, film_stride, y, rows, groups, cg, t_len, cs, threads, per,
                    smem, eps, vec_ok, st)
  }
  AA_GGN_DISPATCH(launch_cluster, float, mode, x, scale, bias, film_scale, film_shift,
                  film_stride, y, rows, groups, cg, t_len, cs, threads, per, smem, eps,
                  vec_ok, st)
}

// The two-pass route, for rows too long for a cluster's shared memory.
// plan: int[7] {b, c, t_len, groups, n_split, apply_blocks, film_stride};
// flags as aa_ggn_cluster's; partials: [B * groups, n_split, 2] float32
// scratch.
extern "C" int aa_ggn_two_pass(const int* plan, int flags, float eps, const void* x,
                               const void* scale, const void* bias, const void* film_scale,
                               const void* film_shift, void* y, void* partials,
                               void* stream) {
  const int b = plan[0], c = plan[1], t_len = plan[2], groups = plan[3],
            n_split = plan[4], apply_blocks = plan[5], film_stride = plan[6];
  if (groups <= 0 || c % groups != 0 || n_split < 1 || apply_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mode = (film_scale != nullptr) * 4 + (film_shift != nullptr) * 2 + ((flags >> 1) & 1);
  const int vec_ok = (flags >> 2) & 1, rows = b * groups, cg = c / groups;
  float* part = static_cast<float*>(partials);
  if (flags & 1) {
    AA_GGN_DISPATCH(launch_two_pass, __nv_bfloat16, mode, x, scale, bias, film_scale,
                    film_shift, film_stride, y, part, rows, groups, cg, t_len, n_split,
                    apply_blocks, eps, vec_ok, st)
  }
  AA_GGN_DISPATCH(launch_two_pass, float, mode, x, scale, bias, film_scale, film_shift,
                  film_stride, y, part, rows, groups, cg, t_len, n_split, apply_blocks,
                  eps, vec_ok, st)
}
