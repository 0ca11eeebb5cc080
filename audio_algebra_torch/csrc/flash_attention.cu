// Blocked (flash) self-attention with an additive rel-pos bias, forward,
// for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces: audio_algebra_tpu/ops/pallas/flash_attention.py:
// flash_attention_relpos (its Pallas body _fwd_kernel_t, launched by
// _fwd_impl).
//
// Computes, for q, k, v of shape (B, H, T, D) and the TRANSPOSED bias
// biasT (H, S = T, T) (biasT[h, s, t] is the bias of query t and key s):
//   o[b, h, t] = softmax_s(q[b,h,t] . k[b,h,s] * sm_scale + biasT[h,s,t]) . v[b,h]
// with the scores and the softmax statistics (running max m, normaliser l)
// in f32, P cast to v's dtype before the P.V product (f32 accumulation),
// and the output divided by l and cast to q's dtype, as the TPU kernel does.
//
// Design: one block per (batch*head, 64-query tile) with a loop over 64-key
// tiles. The K, V and bias tiles are staged in shared memory; the online
// softmax state and the output accumulator stay in registers, so no score
// ever goes to device memory. The bias tile biasT[h, s0:s0+64, t0:t0+64]
// is contiguous along t: it is loaded coalesced and read transposed from a
// padded f32 tile. Every block reads the bias of its own (batch, head), so
// the bias is read once per batch row (B times in all), not once for all.
//   bf16: four warps, 16 query rows each; Q.K^T and P.V on the tensor cores
//         through mma.sync m16n8k16 (bf16 in, f32 accumulate). The score
//         fragments are re-packed in registers as the A operand of P.V.
//   f32:  CUDA-core FMA, four threads per query row each holding D/4 of its
//         dims, so that f32 results agree with the plain version to 1e-4.
//
// Bound: HBM bytes at the main path's shapes. The least traffic is one read
// of q, k, v and the bias and one write of o: 50.3 MB at (2, 16, 1024, 64)
// bf16 with a bf16 bias, 15.0 us on an H100 SXM, against 8.7 us for its
// 8.6 GFLOP at the bf16 tensor-core peak. This kernel reads the bias once
// per batch row (33.6 MB more at that shape) and K, V once per query tile
// (mostly from L2), and is not yet pipelined (no cp.async or TMA, no wgmma).
//
// C interface (bound with ctypes): aa_flash_attention_relpos launches one
// kernel on the given stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kBQ = 64;              // query rows of a block
constexpr int kBK = 64;              // keys of a tile
constexpr int kBiasLD = kBQ + 4;     // f32 stride of the bias tile: the
                                     // transposed reads hit 32 banks
constexpr float kNegInf = -1e30f;    // the TPU kernel's initial max

// One tile of the bias: rows s0..s0+63 (keys), columns t0..t0+63 (queries)
// of biasT[h], into bs[key * kBiasLD + query] as f32.
template <typename TB>
__device__ __forceinline__ void load_bias_tile(const TB* __restrict__ bias_h, int t_len,
                                               int s0, int t0, float* bs, int tid,
                                               int n_threads) {
  constexpr int V = aa::VecIO<TB>::V;
  constexpr int kChunks = kBQ / V;
  for (int i = tid; i < kBK * kChunks; i += n_threads) {
    const int r = i / kChunks, c = (i % kChunks) * V;
    float v[V];
    aa::VecIO<TB>::load(bias_h + static_cast<size_t>(s0 + r) * t_len + t0 + c, v);
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(bs + r * kBiasLD + c + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

// Copy rows [0, rows) of a (rows, D) tile of 16-bit or 32-bit elements from
// global memory (contiguous) into shared memory with row stride ld.
template <typename E, int D>
__device__ __forceinline__ void load_tile(const E* __restrict__ src, E* dst, int ld,
                                          int rows, int tid, int n_threads) {
  constexpr int V = 16 / sizeof(E);
  constexpr int kChunks = D / V;
  for (int i = tid; i < rows * kChunks; i += n_threads) {
    const int r = i / kChunks, c = (i % kChunks) * V;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// ---------------------------------------------------------------- bf16 ---
// 128 threads; warp w owns query rows 16w..16w+15 of the tile. In the
// m16n8k16 fragments, lane = 4*g + tg: a thread holds rows g and g + 8 and
// columns 2*tg, 2*tg + 1 of each 8-wide column tile.
template <int D, typename TB>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const TB* __restrict__ bias,
               uint16_t* __restrict__ o, int heads, int t_len, float sm_scale) {
  constexpr int LD = D + 8;          // bf16 stride: fragment reads hit 32 banks
  constexpr int KD = D / 16;         // k-steps of Q.K^T
  constexpr int ND = D / 8;          // 8-wide dim tiles of the output
  constexpr int NK = kBK / 8;        // 8-wide key tiles of the scores
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ks = qs + kBQ * LD;
  uint16_t* vs = ks + kBK * LD;
  float* bs = reinterpret_cast<float*>(vs + kBK * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, h = bh % heads;
  const int t0 = blockIdx.x * kBQ;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;

  load_tile<uint16_t, D>(q + head + static_cast<size_t>(t0) * D, qs, LD, kBQ, tid, 128);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = 16 * kk + 2 * tg;
    qf[kk][0] = ld32(qs + (r0 + g) * LD + c);
    qf[kk][1] = ld32(qs + (r0 + g + 8) * LD + c);
    qf[kk][2] = ld32(qs + (r0 + g) * LD + c + 8);
    qf[kk][3] = ld32(qs + (r0 + g + 8) * LD + c + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int s0 = 0; s0 < t_len; s0 += kBK) {
    __syncthreads();                 // every warp is done with the last tile
    load_tile<uint16_t, D>(k + head + static_cast<size_t>(s0) * D, ks, LD, kBK, tid, 128);
    load_tile<uint16_t, D>(v + head + static_cast<size_t>(s0) * D, vs, LD, kBK, tid, 128);
    load_bias_tile<TB>(bias_h, t_len, s0, t0, bs, tid, 128);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint16_t* kr = ks + (8 * j + g) * LD + 16 * kk + 2 * tg;
        mma_bf16(s[j], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float* b = bs + (8 * j + 2 * tg) * kBiasLD + r0 + g;
      s[j][0] = s[j][0] * sm_scale + b[0];
      s[j][1] = s[j][1] * sm_scale + b[kBiasLD];
      s[j][2] = s[j][2] * sm_scale + b[8];
      s[j][3] = s[j][3] * sm_scale + b[kBiasLD + 8];
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + ps0;             // this thread's share of the row sums
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= al0; acc[d][1] *= al0;
      acc[d][2] *= al1; acc[d][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // the score fragments of key tiles 2kk, 2kk+1 are the A fragment of P.V
      const uint32_t pa[4] = {aa::bf16_pack(s[2 * kk][0], s[2 * kk][1]),
                              aa::bf16_pack(s[2 * kk][2], s[2 * kk][3]),
                              aa::bf16_pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              aa::bf16_pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint16_t* vr = vs + (16 * kk + 2 * tg) * LD + g;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const uint16_t* vc = vr + 8 * d;
        mma_bf16(acc[d], pa, pack16(vc[0], vc[LD]), pack16(vc[8 * LD], vc[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  uint16_t* o0 = o + head + static_cast<size_t>(t0 + r0 + g) * D + 2 * tg;
  uint16_t* o1 = o0 + 8 * D;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    *reinterpret_cast<uint32_t*>(o0 + 8 * d) = aa::bf16_pack(acc[d][0] / l0, acc[d][1] / l0);
    *reinterpret_cast<uint32_t*>(o1 + 8 * d) = aa::bf16_pack(acc[d][2] / l1, acc[d][3] / l1);
  }
}

// ----------------------------------------------------------------- f32 ---
// 256 threads: query row tid / 4 of the tile, dims quarter + 4 i of it.
template <int D, typename TB>
__global__ void __launch_bounds__(256)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const TB* __restrict__ bias,
              float* __restrict__ o, int heads, int t_len, float sm_scale) {
  constexpr int DPT = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kBK * D;
  float* bs = vs + kBK * D;

  const int tid = threadIdx.x, row = tid >> 2, quarter = tid & 3;
  const int bh = blockIdx.y, h = bh % heads;
  const int t0 = blockIdx.x * kBQ;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;

  float qr[DPT], acc[DPT];
  const float* qrow = q + head + static_cast<size_t>(t0 + row) * D + quarter;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = qrow[4 * i];
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int s0 = 0; s0 < t_len; s0 += kBK) {
    __syncthreads();
    load_tile<float, D>(k + head + static_cast<size_t>(s0) * D, ks, D, kBK, tid, 256);
    load_tile<float, D>(v + head + static_cast<size_t>(s0) * D, vs, D, kBK, tid, 256);
    load_bias_tile<TB>(bias_h, t_len, s0, t0, bs, tid, 256);
    __syncthreads();

    float s[kBK];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qr[i], ks[j * D + quarter + 4 * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = part * sm_scale + bs[j * kBiasLD + row];
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - mn);
      ps += s[j];
    }
    l = l * al + ps;
    m = mn;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= al;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(s[j], vs[j * D + quarter + 4 * i], acc[i]);
    }
  }
  float* orow = o + head + static_cast<size_t>(t0 + row) * D + quarter;
#pragma unroll
  for (int i = 0; i < DPT; ++i) orow[4 * i] = acc[i] / l;
}

template <int D, typename TB>
int launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
                int b, int heads, int t_len, float sm_scale, cudaStream_t st) {
  constexpr int LD = D + 8;
  constexpr size_t kSmem = (kBQ + 2 * kBK) * LD * sizeof(uint16_t)
                           + kBK * kBiasLD * sizeof(float);
  auto kernel = flash_fwd_bf16<D, TB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(t_len / kBQ, b * heads), 128, kSmem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const TB*>(bias),
      static_cast<uint16_t*>(o), heads, t_len, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename TB>
int launch_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
               int b, int heads, int t_len, float sm_scale, cudaStream_t st) {
  constexpr size_t kSmem = (2 * kBK * D + kBK * kBiasLD) * sizeof(float);
  auto kernel = flash_fwd_f32<D, TB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(t_len / kBQ, b * heads), 256, kSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const TB*>(bias),
      static_cast<float*>(o), heads, t_len, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB>
int dispatch(int dtype, int d, const void* q, const void* k, const void* v,
             const void* bias, void* o, int b, int heads, int t_len, float sm_scale,
             cudaStream_t st) {
#define AA_FLASH_D(DV)                                                              \
  case DV:                                                                          \
    return dtype == 1 ? launch_bf16<DV, TB>(q, k, v, bias, o, b, heads, t_len,      \
                                            sm_scale, st)                           \
                      : launch_f32<DV, TB>(q, k, v, bias, o, b, heads, t_len,       \
                                           sm_scale, st);
  switch (d) {
    AA_FLASH_D(16)
    AA_FLASH_D(32)
    AA_FLASH_D(64)
    AA_FLASH_D(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AA_FLASH_D
}

}  // namespace

// dtype (of q, k, v and o) and bias_dtype: 0 = float32, 1 = bfloat16.
// q, k, v, o: contiguous (B, H, T, D), 16-byte aligned; bias: contiguous
// (H, T, T) transposed bias. T must be a multiple of 64 and D one of 16,
// 32, 64, 128. Returns cudaGetLastError().
extern "C" int aa_flash_attention_relpos(int dtype, int bias_dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* bias, void* o, int b, int heads,
                                         int t_len, int d, float sm_scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || t_len % kBQ != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bias_dtype == 0)
    return dispatch<float>(dtype, d, q, k, v, bias, o, b, heads, t_len, sm_scale, st);
  if (bias_dtype == 1)
    return dispatch<__nv_bfloat16>(dtype, d, q, k, v, bias, o, b, heads, t_len,
                                   sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
