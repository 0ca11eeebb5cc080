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
// residual) and one write of each output (int8: 1 byte an element). K1,
// K2b and K2c read x twice (a statistics pass, then the apply pass), which
// caps them near 2/3 of that bound. Both passes use 16-byte vector loads
// and stores with neighbouring threads on neighbouring addresses; int8
// stores are 4 or 8 bytes a thread. The statistics pass (common.cuh) writes
// per-block (sum, sumsq) partials to a [B, n_split, 2] f32 scratch with no
// atomics, so the order of the sums is fixed and the result is
// reproducible run to run.
// K2a (gn_quant_kernel) is one persistent launch that walks the rows in
// groups whose x fits in the 50 MB L2 (32 MiB: one row of (256, 65536)
// bf16). Each block sums its slices of a group from HBM, waits on a
// per-group count (not a grid-wide barrier) until every slice of the group
// is summed, then quantises the same slices, re-reading them from L2: HBM
// moves the bound's 3 bytes an element. Each block issues the first loads
// of its apply before it waits, so the wait and the fold hide behind them.
// Taken apart on an H100, an apply reading x from HBM ran as fast without
// GELU as with it: bound by bytes, and by the wait between the passes.
// The apply keeps its instructions few all the same, since it shares the
// SM with the loads: the channel's scale, bias and qinv once a vector when
// t_len % V == 0 (the channel by a multiply-high, not a division), rstd
// folded into the scale, GELU in its sigmoid form (one ex2 and a fast
// reciprocal, not tanhf), and the int8 rounded by an FMA against 1.5 2^23
// and packed with byte permutes, with no float-to-int conversion.
// Measured by chip_smoke.py at (16, 256, 65536) bf16 on an NVIDIA H100
// 80GB HBM3 at 700 W: 0.459-0.509 ms, where the two passes it replaced
// took 0.684-0.694 ms (byte bound 0.240 ms).
// The amax of K2b and K2c: the TPU kernel carried it across its sequential
// grid; here blocks run in any order, so each block max-reduces |out| per
// channel into a shared-memory table (warp-aggregated: lanes on one channel
// reduce with __reduce_max_sync first), then max-accumulates the table into
// the (C,) output with atomicMax on the bit patterns of non-negative
// floats, whose integer order is their float order. Max is order-free, so
// the result is exact and reproducible. The statistics pass zeroes that
// output first.
//
// C interface (bound with ctypes): aa_groupnorm1_gelu (K1) and
// aa_groupnorm1_turbo (K2b, K2c) launch both passes, aa_groupnorm1_quant
// (K2a) its one launch, aa_groupnorm1_stats and aa_groupnorm1_apply K1's
// two passes apart (the split route, with a sum across time slabs between
// them), on the given stream; they allocate nothing, do not synchronise,
// and return the CUDA error.

#include "common.cuh"

namespace {

using aa::kThreads;
using aa::VecIO;

enum TurboMode { kResAmax = 1, kResAmaxQ = 2 };   // 0 is K2a, its own launch

__device__ __forceinline__ float gelu_tanh(float y) {
  return 0.5f * y * (1.0f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
}

// (mu, rstd) of batch row blockIdx.y from its statistics partials, shared
// by the whole block. n is the row's element count the sums cover (the whole
// row's across ranks when the partials were summed over time slabs).
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
// (mu, rstd), dividing by n_stats, then normalises a grid-strided share of
// the row's n local elements. K1 passes n_stats = n; the split route passes
// the whole row's count across the time slabs its partials were summed over.
template <typename T, bool GELU, bool RES>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ partials,
                const T* __restrict__ scale, const T* __restrict__ bias,
                T* __restrict__ y, int n, int n_stats, int t_len, int n_split,
                float eps, int vec_ok) {
  constexpr int V = VecIO<T>::V;
  float mu, rstd;
  row_stats(partials, n_split, n_stats, eps, mu, rstd);
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

// K2b and K2c. grid (blocks_per_row, B), dynamic shared memory C * 4 bytes
// for the amax table. Same walk over the row as gn_apply_kernel.
template <typename T, bool GELU, int MODE>
__global__ void __launch_bounds__(kThreads)
gn_turbo_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ partials,
                const T* __restrict__ scale, const T* __restrict__ bias,
                const float* __restrict__ qinv, T* __restrict__ y,
                int8_t* __restrict__ y8, unsigned* __restrict__ amax,
                int c_len, int n, int t_len, int n_split, float eps, int vec_ok) {
  constexpr int V = VecIO<T>::V;
  constexpr bool EMIT8 = MODE == kResAmaxQ;  // int8 output
  extern __shared__ unsigned s_amax[];
  float mu, rstd;
  row_stats(partials, n_split, n, eps, mu, rstd);
  for (int k = threadIdx.x; k < c_len; k += kThreads) s_amax[k] = 0u;
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const T* xr = x + base;
  const T* rr = res + base;
  T* yr = y + base;
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
      VecIO<T>::load(rr + i, r);
      int c = i / t_len;
      int t = i - c * t_len;
      float c_scale = VecIO<T>::get(scale + c), c_bias = VecIO<T>::get(bias + c);
      float c_qinv = EMIT8 ? qinv[c] : 0.f;
      float m = 0.f;
      int q[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (t == t_len) {            // crossed into the next channel
          atomicMax(s_amax + c, __float_as_uint(m));
          m = 0.f;
          t = 0;
          ++c;
          c_scale = VecIO<T>::get(scale + c);
          c_bias = VecIO<T>::get(bias + c);
          if (EMIT8) c_qinv = qinv[c];
        }
        float o = (v[k] - mu) * rstd;
        o = o * c_scale + c_bias;
        if (GELU) o = gelu_tanh(o);
        o = r[k] + o;
        m = fmaxf(m, fabsf(o));
        if (EMIT8) q[k] = quant8(o, c_qinv);
        v[k] = o;
        ++t;
      }
      VecIO<T>::store(yr + i, v);
      amax_warp(s_amax, c, m);
      if (EMIT8) I8Store<V>::store(y8r + i, q);
    }
    tail = nv * V;
  }
  for (int i = tail + first; i < n; i += stride) {
    const int c = i / t_len;
    float o = (VecIO<T>::get(xr + i) - mu) * rstd;
    o = o * VecIO<T>::get(scale + c) + VecIO<T>::get(bias + c);
    if (GELU) o = gelu_tanh(o);
    o = VecIO<T>::get(rr + i) + o;
    VecIO<T>::put(yr + i, o);
    atomicMax(s_amax + c, __float_as_uint(fabsf(o)));
    if (EMIT8) y8r[i] = static_cast<int8_t>(quant8(o, qinv[c]));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < c_len; k += kThreads) {
    const unsigned a = s_amax[k];
    if (a) atomicMax(amax + k, a);
  }
}

// ------------------------------------------------------------------ K2a ---
// GELU in its sigmoid form, 0.5 y (1 + tanh(u)) = y / (1 + exp(-2 u)) with
// u = c (y + 0.044715 y^3): exp(-2 u) = 2^(y (k1 + k2 y^2)) by one ex2 and
// the division by a fast reciprocal, a handful of instructions in place of
// tanhf's range-split evaluation, and no cancellation in 1 + tanh(u) near
// -1. Within a few f32 ulps of the tanh form wherever the int8 grid can
// see it (tests/test_torch_quant_plan.py models it against the twin).
constexpr float kGeluK1 = -2.0f * 1.4426950408889634f * 0.7978845608028654f;
constexpr float kGeluK2 = kGeluK1 * 0.044715f;

__device__ __forceinline__ float gelu_sigmoid(float y) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * fmaf(kGeluK2, y * y, kGeluK1)));
  return __fdividef(y, 1.0f + e);
}

// 16-byte loads of x with an L2 eviction priority: the statistics pass
// marks its lines last to evict (the apply pass reads them again), the
// apply pass first to evict (its read is the last). Volatile, so that a
// load issued ahead of a wait stays ahead of it.
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t p;
  if (keep)
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  else
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint4 ld_hint(const void* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void unpack(uint4 v, float (&o)[4]) {
  o[0] = __uint_as_float(v.x); o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z); o[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&o)[8]) {
  o[0] = aa::bf16_lo(v.x); o[1] = aa::bf16_hi(v.x);
  o[2] = aa::bf16_lo(v.y); o[3] = aa::bf16_hi(v.y);
  o[4] = aa::bf16_lo(v.z); o[5] = aa::bf16_hi(v.z);
  o[6] = aa::bf16_lo(v.w); o[7] = aa::bf16_hi(v.w);
}
template <typename T>
__device__ __forceinline__ void load_hint(const T* p, float (&o)[VecIO<T>::V], uint64_t policy) {
  unpack(ld_hint(p, policy), o);
}

// Rounding to int8 without a float-to-int conversion (a quarter-rate
// instruction): v qinv + 1.5 2^23, rounded once by the FMA, holds
// rint(v qinv) (half to even) in its low mantissa bits; clamped to
// +-127 around that offset, its low byte is the int8.
constexpr float kRound = 12582912.0f;

__device__ __forceinline__ uint32_t quant_bits(float v, float qinv) {
  return __float_as_uint(fminf(fmaxf(fmaf(v, qinv, kRound), kRound - 127.f), kRound + 127.f));
}

// The low bytes of four words in one word; V int8 values stored as
// streaming.
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ void store_last(int8_t* p, const uint32_t (&q)[4]) {
  __stcs(reinterpret_cast<unsigned*>(p), low_bytes(q[0], q[1], q[2], q[3]));
}
__device__ __forceinline__ void store_last(int8_t* p, const uint32_t (&q)[8]) {
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(low_bytes(q[0], q[1], q[2], q[3]),
                                                 low_bytes(q[4], q[5], q[6], q[7])));
}

// e / d for 0 <= e < 2^31 by a multiply-high and shifts (d fixed per launch).
struct FastDiv {
  uint32_t m;
  int s1, s2;
  __device__ explicit FastDiv(uint32_t d) {
    const int l = 32 - __clz(d - 1);
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
    s1 = min(l, 1);
    s2 = l - s1;
  }
  __device__ __forceinline__ int operator()(int e) const {
    const uint32_t t = __umulhi(m, static_cast<uint32_t>(e));
    return static_cast<int>((t + ((static_cast<uint32_t>(e) - t) >> s1)) >> s2);
  }
};

// int8 bits of one vector of V values starting at element e of a row: the
// channel's scale, bias and qinv taken once when no vector crosses a
// channel (WHOLE: t_len % V == 0), else checked at every element.
template <typename T, bool GELU, bool WHOLE>
__device__ __forceinline__ void quant_vector(const float (&v)[VecIO<T>::V], int e, int t_len,
                                             const FastDiv& by_t, float mu, float rstd,
                                             const T* __restrict__ scale,
                                             const T* __restrict__ bias,
                                             const float* __restrict__ qinv,
                                             uint32_t (&q)[VecIO<T>::V]) {
  int c = by_t(e);
  int t = e - c * t_len;
  float ca = rstd * VecIO<T>::get(scale + c), cb = VecIO<T>::get(bias + c), ci = qinv[c];
#pragma unroll
  for (int k = 0; k < VecIO<T>::V; ++k) {
    if (!WHOLE && t == t_len) {      // crossed into the next channel
      t = 0;
      ++c;
      ca = rstd * VecIO<T>::get(scale + c);
      cb = VecIO<T>::get(bias + c);
      ci = qinv[c];
    }
    float o = fmaf(v[k] - mu, ca, cb);   // (x - mu) rstd scale + bias
    if (GELU) o = gelu_sigmoid(o);
    q[k] = quant_bits(o, ci);
    ++t;
  }
}

constexpr int kMaxGroupRows = 64;   // rows of one L2 group (the planner's cap)
constexpr int kUnroll = 4;          // 16-byte vectors in flight per thread

// (sum, sumsq) of row[lo, hi) over the block into out[0:2], kUnroll vectors
// in flight per thread; each thread sums its elements in ascending order,
// then block_sum2 in a fixed order: the same bits every run.
template <typename T>
__device__ __forceinline__ void slice_sums(const T* __restrict__ row, int lo, int hi,
                                           int vec_ok, float* out) {
  constexpr int V = VecIO<T>::V, W = kThreads * V;
  const uint64_t keep = l2_policy(true);
  float s1 = 0.f, s2 = 0.f;
  int tail = lo;
  if (vec_ok && hi > lo) {
    const int vhi = lo + ((hi - lo) / V) * V;
    for (int i = lo + threadIdx.x * V; i < vhi; i += kUnroll * W) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u * W < vhi) {
          load_hint(row + i + u * W, v[u], keep);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) v[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k) { s1 += v[u][k]; s2 += v[u][k] * v[u][k]; }
    }
    tail = vhi;
  }
  for (int i = tail + threadIdx.x; i < hi; i += kThreads) {
    const float v = VecIO<T>::get(row + i);
    s1 += v;
    s2 += v * v;
  }
  aa::block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    out[0] = s1;
    out[1] = s2;
  }
  __syncthreads();                   // block_sum2's table is free again
}

// The first batch of slice_quant's loads (kUnroll vectors a thread from
// vector j of the row): issued before the block waits for the group's
// sums, which the loads do not need.
template <typename T>
__device__ __forceinline__ void first_batch(const T* __restrict__ xr, int j, int vhi,
                                            uint4 (&raw)[kUnroll]) {
  constexpr int V = VecIO<T>::V;
  const uint64_t last = l2_policy(false);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (j + u * kThreads < vhi) raw[u] = ld_hint(xr + (j + u * kThreads) * V, last);
}

// int8 of row[lo, hi) over the block, kUnroll vectors in flight per thread;
// with vec_ok, the first batch arrives in `raw` (first_batch).
template <typename T, bool GELU>
__device__ __forceinline__ void slice_quant(const T* __restrict__ xr, int8_t* __restrict__ yr,
                                            int lo, int hi, int t_len, const FastDiv& by_t,
                                            float mu, float rstd, const T* __restrict__ scale,
                                            const T* __restrict__ bias,
                                            const float* __restrict__ qinv, int vec_ok,
                                            uint4 (&raw)[kUnroll]) {
  constexpr int V = VecIO<T>::V;
  const uint64_t last = l2_policy(false);
  int tail = lo;
  if (vec_ok) {
    const bool whole = t_len % V == 0;      // no vector crosses a channel
    const int vhi = hi / V;
    for (int j = lo / V + threadIdx.x; j < vhi; j += kUnroll * kThreads) {
      if (j != lo / V + static_cast<int>(threadIdx.x))
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (j + u * kThreads < vhi) raw[u] = ld_hint(xr + (j + u * kThreads) * V, last);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u * kThreads >= vhi) break;
        const int e = (j + u * kThreads) * V;
        float v[V];
        unpack(raw[u], v);
        uint32_t q[V];
        if (whole)
          quant_vector<T, GELU, true>(v, e, t_len, by_t, mu, rstd, scale, bias, qinv, q);
        else
          quant_vector<T, GELU, false>(v, e, t_len, by_t, mu, rstd, scale, bias, qinv, q);
        store_last(yr + e, q);
      }
    }
    tail = vhi * V;
  }
  for (int e = tail + threadIdx.x; e < hi; e += kThreads) {
    const int c = by_t(e);
    float o = fmaf(VecIO<T>::get(xr + e) - mu, rstd * VecIO<T>::get(scale + c),
                   VecIO<T>::get(bias + c));
    if (GELU) o = gelu_sigmoid(o);
    yr[e] = static_cast<int8_t>(quant_bits(o, qinv[c]) & 0xffu);
  }
}

// K2a, one persistent launch whose blocks are all resident (a cooperative
// launch), so that a block may wait for the others. The rows are taken in
// groups of `group_rows` whose x fits in L2 (the planner in
// ops/groupnorm.py), each row cut into n_split slices, a group's slices
// dealt to the blocks. For each group a block sums its slices (from HBM)
// and counts them into done[group]; issues the first loads of its apply;
// waits until the group's count is full; folds the group's partials into
// (mu, rstd); and quantises the same slices, whose lines its own loads just
// left in L2. No grid-wide barrier: a block
// waits only for the sums it needs. HBM moves one read of x and one int8
// write, the bound's 3 bytes an element in bf16. `done` is zeroed by the
// launcher.
template <typename T, bool GELU>
__global__ void __launch_bounds__(kThreads, 4)
gn_quant_kernel(const T* __restrict__ x, float* __restrict__ partials,
                const T* __restrict__ scale, const T* __restrict__ bias,
                const float* __restrict__ qinv, int8_t* __restrict__ y8,
                unsigned* __restrict__ done, int b, int n, int t_len, int n_split,
                int group_rows, float eps, int vec_ok) {
  constexpr int V = VecIO<T>::V;
  __shared__ float s_mu[kMaxGroupRows], s_rstd[kMaxGroupRows];
  const FastDiv by_t(static_cast<uint32_t>(t_len));
  int per = (n + n_split - 1) / n_split;
  per = ((per + V - 1) / V) * V;

  for (int g0 = 0, grp = 0; g0 < b; g0 += group_rows, ++grp) {
    const int rows = min(group_rows, b - g0), items = rows * n_split;
    unsigned mine = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++mine) {
      const int row = g0 + item / n_split, sl = item % n_split;
      slice_sums<T>(x + static_cast<size_t>(row) * n, sl * per, min(n, sl * per + per),
                    vec_ok, partials + (static_cast<size_t>(row) * n_split + sl) * 2);
    }
    if (threadIdx.x == 0 && mine) {
      __threadfence();                 // the partials before the count
      atomicAdd(done + grp, mine);
    }
    // the first loads of this block's first slice, then the wait
    uint4 raw[kUnroll];
    if (vec_ok && blockIdx.x < items) {
      const int lo = (blockIdx.x % n_split) * per;
      first_batch<T>(x + static_cast<size_t>(g0 + blockIdx.x / n_split) * n,
                     lo / V + threadIdx.x, min(n, lo + per) / V, raw);
    }
    if (threadIdx.x == 0) {
      unsigned seen;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(done + grp));
        if (seen < static_cast<unsigned>(items)) __nanosleep(32);
      } while (seen < static_cast<unsigned>(items));
    }
    __syncthreads();
    // (mu, rstd) of the group's rows, each row's partials summed by the
    // whole block in a fixed order (a few loads a thread, one round trip)
    for (int i = 0; i < rows; ++i) {
      const float2* pp =
          reinterpret_cast<const float2*>(partials + static_cast<size_t>(g0 + i) * n_split * 2);
      float a = 0.f, c = 0.f;
      for (int k = threadIdx.x; k < n_split; k += kThreads) {
        const float2 ac = __ldcg(pp + k);
        a += ac.x;
        c += ac.y;
      }
      aa::block_sum2(a, c);
      if (threadIdx.x == 0) {
        const float mu = a / static_cast<float>(n);
        s_mu[i] = mu;
        s_rstd[i] = 1.0f / sqrtf(fmaxf(c / static_cast<float>(n) - mu * mu, 0.f) + eps);
      }
      __syncthreads();               // block_sum2's table is free again
    }
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int i = item / n_split, lo = (item % n_split) * per;
      const size_t base = static_cast<size_t>(g0 + i) * n;
      if (vec_ok && item != blockIdx.x)
        first_batch<T>(x + base, lo / V + threadIdx.x, min(n, lo + per) / V, raw);
      slice_quant<T, GELU>(x + base, y8 + base, lo, min(n, lo + per), t_len, by_t, s_mu[i],
                           s_rstd[i], scale, bias, qinv, vec_ok, raw);
    }
    __syncthreads();                   // s_mu, s_rstd are free for the next group
  }
}

template <typename T, bool GELU, bool RES>
void launch_apply(dim3 grid, cudaStream_t st, const void* x, const void* res,
                  const float* partials, const void* scale, const void* bias,
                  void* y, int n, int n_stats, int t_len, int n_split, float eps,
                  int vec_ok) {
  gn_apply_kernel<T, GELU, RES><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), partials,
      static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(y), n, n_stats, t_len, n_split, eps, vec_ok);
}

// The apply pass alone, on partials already in place.
template <typename T>
void launch_apply_pass(int b, int c, int t_len, int n_stats, int n_split, int apply_blocks,
                       int gelu, int has_res, float eps, int vec_ok, const void* x,
                       const void* res, const void* scale, const void* bias, void* y,
                       const float* partials, cudaStream_t st) {
  const int n = c * t_len;
  const dim3 grid(apply_blocks, b);
  if (gelu && has_res)
    launch_apply<T, true, true>(grid, st, x, res, partials, scale, bias, y, n, n_stats, t_len, n_split, eps, vec_ok);
  else if (gelu)
    launch_apply<T, true, false>(grid, st, x, res, partials, scale, bias, y, n, n_stats, t_len, n_split, eps, vec_ok);
  else if (has_res)
    launch_apply<T, false, true>(grid, st, x, res, partials, scale, bias, y, n, n_stats, t_len, n_split, eps, vec_ok);
  else
    launch_apply<T, false, false>(grid, st, x, res, partials, scale, bias, y, n, n_stats, t_len, n_split, eps, vec_ok);
}

template <typename T>
void launch_all(int b, int c, int t_len, int n_split, int apply_blocks,
                int gelu, int has_res, float eps, int vec_ok,
                const void* x, const void* res, const void* scale,
                const void* bias, void* y, float* partials, cudaStream_t st) {
  const int n = c * t_len;
  aa::launch_stats<T>(x, partials, b, n, n_split, vec_ok, st);
  launch_apply_pass<T>(b, c, t_len, n, n_split, apply_blocks, gelu, has_res, eps, vec_ok, x,
                       res, scale, bias, y, partials, st);
}

template <typename T, bool GELU, int MODE>
void launch_turbo_mode(dim3 grid, cudaStream_t st, const void* x, const void* res,
                       const float* partials, const void* scale, const void* bias,
                       const float* qinv, void* y, void* y8, unsigned* amax, int c,
                       int n, int t_len, int n_split, float eps, int vec_ok) {
  const size_t smem = static_cast<size_t>(c) * sizeof(unsigned);
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
  if (mode == kResAmax)
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
  aa::launch_stats<T>(x, partials, b, n, n_split, vec_ok, st, amax, c);
  const dim3 grid(apply_blocks, b);
  if (gelu)
    return launch_turbo_gelu<T, true>(mode, grid, st, x, res, partials, scale, bias, qinv, y, y8, amax, c, n, t_len, n_split, eps, vec_ok);
  return launch_turbo_gelu<T, false>(mode, grid, st, x, res, partials, scale, bias, qinv, y, y8, amax, c, n, t_len, n_split, eps, vec_ok);
}

// K2a's cooperative launch: as many blocks as the card holds at once (a
// block waits for the others, so all must be resident), a group's slices
// dealt one to a block: n_split = blocks / group_rows, at most max_split (the
// partials' room). The slices follow the card, so the sums repeat run to
// run on one card.
template <typename T, bool GELU>
int launch_quant_gelu(int b, int n, int t_len, int max_split, int group_rows, float eps,
                      int vec_ok, const void* x, const void* scale, const void* bias,
                      const float* qinv, void* y8, float* partials, unsigned* done,
                      cudaStream_t st) {
  auto kernel = gn_quant_kernel<T, GELU>;
  static int per_sm = 0;               // blocks of this kernel an SM holds
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = sms * per_sm;
  int n_split = resident / group_rows;
  n_split = n_split < 1 ? 1 : n_split > max_split ? max_split : n_split;
  const int grid = group_rows * n_split < resident ? group_rows * n_split : resident;
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  const T* bp = static_cast<const T*>(bias);
  int8_t* yp = static_cast<int8_t*>(y8);
  const int n_groups = (b + group_rows - 1) / group_rows;
  err = cudaMemsetAsync(done, 0, n_groups * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&xp, &partials, &sp, &bp, &qinv, &yp, &done, &b, &n, &t_len,
                  &n_split, &group_rows, &eps, &vec_ok};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kThreads), args, 0, st));
}

template <typename T>
int launch_quant(int b, int n, int t_len, int max_split, int group_rows, int gelu, float eps,
                 int vec_ok, const void* x, const void* scale, const void* bias,
                 const float* qinv, void* y8, float* partials, unsigned* done,
                 cudaStream_t st) {
  if (gelu)
    return launch_quant_gelu<T, true>(b, n, t_len, max_split, group_rows, eps, vec_ok, x,
                                      scale, bias, qinv, y8, partials, done, st);
  return launch_quant_gelu<T, false>(b, n, t_len, max_split, group_rows, eps, vec_ok, x,
                                     scale, bias, qinv, y8, partials, done, st);
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

// K1 split around a reduce across time slabs (the sequence-parallel
// decodes): aa_groupnorm1_stats writes a slab's [b, n_split, 2] (sum, sumsq)
// partials; the caller sums them over the slabs (an all_reduce across
// ranks); aa_groupnorm1_apply normalises the slab with n_stats, the whole
// row's element count. Every slab has the same shape, so n_split agrees.
extern "C" int aa_groupnorm1_stats(int dtype, const void* x, void* partials, int b, int c,
                                   int t_len, int n_split, int vec_ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (dtype == 0)
    aa::launch_stats<float>(x, part, b, c * t_len, n_split, vec_ok, st);
  else if (dtype == 1)
    aa::launch_stats<__nv_bfloat16>(x, part, b, c * t_len, n_split, vec_ok, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aa_groupnorm1_apply(int dtype, const void* x, const void* res,
                                   const void* scale, const void* bias, void* y,
                                   const void* partials, int b, int c, int t_len,
                                   int n_stats, int n_split, int apply_blocks, int gelu,
                                   int has_res, float eps, int vec_ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* part = static_cast<const float*>(partials);
  if (dtype == 0)
    launch_apply_pass<float>(b, c, t_len, n_stats, n_split, apply_blocks, gelu, has_res, eps,
                             vec_ok, x, res, scale, bias, y, part, st);
  else if (dtype == 1)
    launch_apply_pass<__nv_bfloat16>(b, c, t_len, n_stats, n_split, apply_blocks, gelu,
                                     has_res, eps, vec_ok, x, res, scale, bias, y, part, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K2b and K2c. mode: 1 = res_amax (x, res -> y, amax), 2 = res_amax_q (x,
// res -> y, amax, y8). qinv: (c,) float32 (mode 2); amax: (c,) float32,
// zeroed here by the statistics pass; y8: int8 like x (mode 2). Returns
// cudaGetLastError().
extern "C" int aa_groupnorm1_turbo(int dtype, int mode, const void* x, const void* res,
                                   const void* scale, const void* bias,
                                   const void* qinv, void* y, void* y8, void* amax,
                                   void* partials, int b, int c, int t_len,
                                   int n_split, int apply_blocks, int gelu, float eps,
                                   int vec_ok, void* stream) {
  if (mode != kResAmax && mode != kResAmaxQ) return static_cast<int>(cudaErrorInvalidValue);
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

// K2a: x -> y8 (int8 like x) on the per-channel grid qinv ((c,) float32).
// partials: [b, max_split, 2] float32 scratch (a row uses the first n_split
// pairs); done: ceil(b / group_rows) uint32 scratch, zeroed here;
// group_rows: rows per L2 group, 1 to 64. A memset and one cooperative
// launch; returns their error.
extern "C" int aa_groupnorm1_quant(int dtype, const void* x, const void* scale,
                                   const void* bias, const void* qinv, void* y8,
                                   void* partials, void* done, int b, int c, int t_len,
                                   int max_split, int group_rows, int gelu, float eps,
                                   int vec_ok, void* stream) {
  if (group_rows < 1 || group_rows > kMaxGroupRows || max_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  unsigned* dn = static_cast<unsigned*>(done);
  const float* qi = static_cast<const float*>(qinv);
  const int n = c * t_len;
  if (dtype == 0)
    return launch_quant<float>(b, n, t_len, max_split, group_rows, gelu, eps, vec_ok, x,
                               scale, bias, qi, y8, part, dn, st);
  if (dtype == 1)
    return launch_quant<__nv_bfloat16>(b, n, t_len, max_split, group_rows, gelu, eps, vec_ok,
                                       x, scale, bias, qi, y8, part, dn, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
