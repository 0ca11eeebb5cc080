// Backward of the rel-pos flash attention with respect to Q and the bias,
// for Hopper (sm_90a): kernel K4c of the port.
//
// Replaces: audio_algebra_tpu/ops/pallas/flash_attention.py:
// _bwd_dq_kernel_t (launched by _train_bwd of flash_attention_relpos_train).
//
// Computes, for q, k, v, do of shape (B, H, T, D), the TRANSPOSED bias biasT
// (H, S = T, T) and the forward's residuals l, m and delta = sum_d do * o,
// all f32 (H, B, T):
//   s[t, s]  = q[t] . k[s] * sm_scale + biasT[h, s, t]        (f32)
//   p        = exp(s - m[t]) / l[t]        (from the FINAL row max and sum)
//   ds       = p * (do[t] . v[s] - delta[t])
//   dq[t]    = sm_scale * sum_s cast(ds[t, s]) * k[s]
//   dbT[h, s, t] = sum_b ds[t, s]                      (f32, in biasT's layout)
// with ds cast to the inputs' dtype before the dq product, f32 accumulation,
// dq cast at the end, as the TPU kernel does; dbT is returned in f32 and the
// wrapper casts it to the bias's dtype.
//
// The sum over the batch. d(biasT) is shared by the batch. On the TPU the
// batch rides inside the block; here one block owns (head, 64-query tile)
// and loops over the batch rows and, inside, over the 64-key tiles. It is
// the only block that touches dbT[h, :, t0:t0+64], so it adds each batch
// row's ds tile to that strip with plain loads and stores: batch row 0
// writes, the later rows read, add and write, in ascending order. No
// atomics, no zero fill, no scratch beyond the f32 output, any batch size,
// and the result does not depend on the order in which blocks run. dq needs
// no sum across blocks either: with the key loop innermost it accumulates
// in registers and is written once per batch row. The price is a block
// count of H * T / 64 (256 at T = 1024, 128 at T = 512, for 132 SMs) and
// the strip's read and write per batch row, which go through L2.
//   bf16: four warps, 16 query rows each; the three products run on the
//         tensor cores through mma.sync m16n8k16; each thread overwrites
//         the bias values it read with its ds values, in the tile's (key,
//         query) layout, for the coalesced add to dbT.
//   f32:  CUDA-core FMA, four threads per query row, each holding D / 4 of
//         its dims in 16-byte pieces; ds goes to a second shared tile.
//
// Bound: operations in f32 (6 B H T^2 D at the f32 peak: 0.77 ms at
// (8, 16, 1024, 64) on an H100 SXM, against 0.09 ms for its bytes); bytes
// in bf16 on the tensor cores. Not pipelined (no cp.async or TMA, no wgmma).
//
// C interface (bound with ctypes): aa_flash_attention_dq launches one
// kernel on the given stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError().

#include "flash_common.cuh"

namespace {

using namespace aa_flash;

// Add the (key, query) tile `tile` (stride kBiasLD) of one batch row to
// db_h[s0:s0+64, t0:t0+64]; the first batch row writes it.
__device__ __forceinline__ void add_tile_to_db(float* __restrict__ db_h, const float* tile,
                                               int t_len, int s0, int t0, bool first,
                                               int tid, int n_threads) {
  for (int i = tid; i < kBK * (kBQ / 4); i += n_threads) {
    const int r = i / (kBQ / 4), c = (i % (kBQ / 4)) * 4;
    float4 a = *reinterpret_cast<const float4*>(tile + r * kBiasLD + c);
    float4* out = reinterpret_cast<float4*>(db_h + static_cast<size_t>(s0 + r) * t_len
                                            + t0 + c);
    if (!first) {
      const float4 o = *out;
      a.x += o.x; a.y += o.y; a.z += o.z; a.w += o.w;
    }
    *out = a;
  }
}

// ---------------------------------------------------------------- bf16 ---
// 128 threads; warp w owns query rows 16w..16w+15 of the tile, as in the
// forward kernel.
template <int D, typename TB>
__global__ void __launch_bounds__(128)
flash_dq_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const TB* __restrict__ bias,
              const uint16_t* __restrict__ dout, const float* __restrict__ l,
              const float* __restrict__ m, const float* __restrict__ delta,
              uint16_t* __restrict__ dq, float* __restrict__ db, int batch, int heads,
              int t_len, float sm_scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NK = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* dos = qs + kBQ * LD;
  uint16_t* ks = dos + kBQ * LD;
  uint16_t* vs = ks + kBK * LD;
  float* bs = reinterpret_cast<float*>(vs + kBK * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kBQ;
  const int r0 = warp * 16;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;
  float* db_h = db + static_cast<size_t>(h) * t_len * t_len;

  for (int b = 0; b < batch; ++b) {
    const size_t head = (static_cast<size_t>(b) * heads + h) * t_len * D;
    const size_t r = (static_cast<size_t>(h) * batch + b) * t_len + t0 + r0 + g;
    // the barrier that ended the last key tile makes qs and dos free
    load_tile<uint16_t, D>(q + head + static_cast<size_t>(t0) * D, qs, LD, kBQ, tid, 128);
    load_tile<uint16_t, D>(dout + head + static_cast<size_t>(t0) * D, dos, LD, kBQ, tid,
                           128);
    const float m0 = m[r], m1 = m[r + 8];
    const float il0 = 1.0f / l[r], il1 = 1.0f / l[r + 8];
    const float de0 = delta[r], de1 = delta[r + 8];

    float dqa[ND][4];
#pragma unroll
    for (int d = 0; d < ND; ++d) dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;

    for (int s0 = 0; s0 < t_len; s0 += kBK) {
      __syncthreads();               // every warp is done with the last tile
      load_tile<uint16_t, D>(k + head + static_cast<size_t>(s0) * D, ks, LD, kBK, tid, 128);
      load_tile<uint16_t, D>(v + head + static_cast<size_t>(s0) * D, vs, LD, kBK, tid, 128);
      load_bias_tile<TB>(bias_h, t_len, s0, t0, bs, tid, 128);
      __syncthreads();

      // s = Q.K^T and dp = dO.V^T: rows are queries, columns keys
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4], da[4];
        load_a_frag(qa, qs, LD, r0, 16 * kk, g, tg);
        load_a_frag(da, dos, LD, r0, 16 * kk, g, tg);
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int off = (8 * j + g) * LD + 16 * kk + 2 * tg;
          mma_bf16(s[j], qa, ld32(ks + off), ld32(ks + off + 8));
          mma_bf16(dp[j], da, ld32(vs + off), ld32(vs + off + 8));
        }
      }
      // ds into dp and, transposed, over the bias values this thread read
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        float* bp = bs + (8 * j + 2 * tg) * kBiasLD + r0 + g;
        const float p0 = expf(s[j][0] * sm_scale + bp[0] - m0) * il0;
        const float p1 = expf(s[j][1] * sm_scale + bp[kBiasLD] - m0) * il0;
        const float p2 = expf(s[j][2] * sm_scale + bp[8] - m1) * il1;
        const float p3 = expf(s[j][3] * sm_scale + bp[kBiasLD + 8] - m1) * il1;
        dp[j][0] = p0 * (dp[j][0] - de0);
        dp[j][1] = p1 * (dp[j][1] - de0);
        dp[j][2] = p2 * (dp[j][2] - de1);
        dp[j][3] = p3 * (dp[j][3] - de1);
        bp[0] = dp[j][0];
        bp[kBiasLD] = dp[j][1];
        bp[8] = dp[j][2];
        bp[kBiasLD + 8] = dp[j][3];
      }
      // dq += ds.K: the k index runs over the keys
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t da[4];
        c_to_a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
        const uint16_t* kr = ks + (16 * kk + 2 * tg) * LD + g;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const uint16_t* kc = kr + 8 * d;
          mma_bf16(dqa[d], da, pack16(kc[0], kc[LD]), pack16(kc[8 * LD], kc[9 * LD]));
        }
      }
      __syncthreads();               // the ds tile is complete
      add_tile_to_db(db_h, bs, t_len, s0, t0, b == 0, tid, 128);
    }

    const size_t out0 = head + static_cast<size_t>(t0 + r0 + g) * D + 2 * tg;
    const size_t out1 = out0 + 8 * D;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<uint32_t*>(dq + out0 + 8 * d) =
          aa::bf16_pack(dqa[d][0] * sm_scale, dqa[d][1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dq + out1 + 8 * d) =
          aa::bf16_pack(dqa[d][2] * sm_scale, dqa[d][3] * sm_scale);
    }
    __syncthreads();                 // qs, dos and bs are free for the next row
  }
}

// ----------------------------------------------------------------- f32 ---
// 256 threads: query row tid / 4 of the tile; the thread holds the dims
// 16 i + 4 quarter + {0..3} of it.
template <int D, typename TB>
__global__ void __launch_bounds__(256)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const TB* __restrict__ bias,
             const float* __restrict__ dout, const float* __restrict__ l,
             const float* __restrict__ m, const float* __restrict__ delta,
             float* __restrict__ dq, float* __restrict__ db, int batch, int heads,
             int t_len, float sm_scale) {
  constexpr int NV = D / 16;         // 16-byte pieces per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kBK * D;
  float* bs = vs + kBK * D;
  float* dss = bs + kBK * kBiasLD;

  const int tid = threadIdx.x, row = tid >> 2, quarter = tid & 3;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kBQ;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;
  float* db_h = db + static_cast<size_t>(h) * t_len * t_len;

  for (int b = 0; b < batch; ++b) {
    const size_t head = (static_cast<size_t>(b) * heads + h) * t_len * D;
    const size_t mine = head + static_cast<size_t>(t0 + row) * D + 4 * quarter;
    const size_t r = (static_cast<size_t>(h) * batch + b) * t_len + t0 + row;
    float4 qr[NV], dor[NV], dqa[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      qr[i] = *reinterpret_cast<const float4*>(q + mine + 16 * i);
      dor[i] = *reinterpret_cast<const float4*>(dout + mine + 16 * i);
      dqa[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float m_row = m[r], il = 1.0f / l[r], de = delta[r];

    for (int s0 = 0; s0 < t_len; s0 += kBK) {
      __syncthreads();
      load_tile<float, D>(k + head + static_cast<size_t>(s0) * D, ks, D, kBK, tid, 256);
      load_tile<float, D>(v + head + static_cast<size_t>(s0) * D, vs, D, kBK, tid, 256);
      load_bias_tile<TB>(bias_h, t_len, s0, t0, bs, tid, 256);
      __syncthreads();

      for (int j = 0; j < kBK; ++j) {
        const float4* kj = reinterpret_cast<const float4*>(ks + j * D + 4 * quarter);
        const float4* vj = reinterpret_cast<const float4*>(vs + j * D + 4 * quarter);
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 a = kj[4 * i], c = vj[4 * i];
          ps = fmaf(qr[i].x, a.x, ps); ps = fmaf(qr[i].y, a.y, ps);
          ps = fmaf(qr[i].z, a.z, ps); ps = fmaf(qr[i].w, a.w, ps);
          pd = fmaf(dor[i].x, c.x, pd); pd = fmaf(dor[i].y, c.y, pd);
          pd = fmaf(dor[i].z, c.z, pd); pd = fmaf(dor[i].w, c.w, pd);
        }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        pd += __shfl_xor_sync(0xffffffffu, pd, 1);
        pd += __shfl_xor_sync(0xffffffffu, pd, 2);
        const float p = expf(ps * sm_scale + bs[j * kBiasLD + row] - m_row) * il;
        const float ds = p * (pd - de);
        if (quarter == (j & 3)) dss[j * kBiasLD + row] = ds;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 a = kj[4 * i];
          dqa[i].x = fmaf(ds, a.x, dqa[i].x); dqa[i].y = fmaf(ds, a.y, dqa[i].y);
          dqa[i].z = fmaf(ds, a.z, dqa[i].z); dqa[i].w = fmaf(ds, a.w, dqa[i].w);
        }
      }
      __syncthreads();               // the ds tile is complete
      add_tile_to_db(db_h, dss, t_len, s0, t0, b == 0, tid, 256);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
      *reinterpret_cast<float4*>(dq + mine + 16 * i) =
          make_float4(dqa[i].x * sm_scale, dqa[i].y * sm_scale, dqa[i].z * sm_scale,
                      dqa[i].w * sm_scale);
  }
}

struct Args {
  const void *q, *k, *v, *bias, *dout;
  const float *l, *m, *delta;
  void* dq;
  float* db;
  int b, heads, t_len;
  float sm_scale;
  cudaStream_t st;
};

template <int D, typename TB>
int launch_bf16(const Args& a) {
  constexpr int LD = D + 8;
  constexpr size_t kSmem = 4 * kBQ * LD * sizeof(uint16_t) + kBK * kBiasLD * sizeof(float);
  auto kernel = flash_dq_bf16<D, TB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.t_len / kBQ, a.heads), 128, kSmem, a.st>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<const uint16_t*>(a.dout), a.l, a.m, a.delta,
      static_cast<uint16_t*>(a.dq), a.db, a.b, a.heads, a.t_len, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename TB>
int launch_f32(const Args& a) {
  constexpr size_t kSmem = (2 * kBK * D + 2 * kBK * kBiasLD) * sizeof(float);
  auto kernel = flash_dq_f32<D, TB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.t_len / kBQ, a.heads), 256, kSmem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<const float*>(a.dout), a.l, a.m, a.delta, static_cast<float*>(a.dq),
      a.db, a.b, a.heads, a.t_len, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB>
int dispatch(int dtype, int d, const Args& a) {
#define AA_FLASH_D(DV) \
  case DV:             \
    return dtype == 1 ? launch_bf16<DV, TB>(a) : launch_f32<DV, TB>(a);
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

// dtype (of q, k, v, dout and dq) and bias_dtype: 0 = float32, 1 = bfloat16.
// q, k, v, dout, dq: contiguous (B, H, T, D), 16-byte aligned; bias:
// contiguous (H, T, T) transposed bias; l, m, delta: contiguous f32
// (H, B, T); db: contiguous f32 (H, T, T), every element written (no fill
// needed). T must be a multiple of 64, B at least 1 and D one of 16, 32, 64,
// 128. Returns cudaGetLastError().
extern "C" int aa_flash_attention_dq(int dtype, int bias_dtype, const void* q,
                                     const void* k, const void* v, const void* bias,
                                     const void* dout, const void* l, const void* m,
                                     const void* delta, void* dq, void* db, int b,
                                     int heads, int t_len, int d, float sm_scale,
                                     void* stream) {
  if ((dtype != 0 && dtype != 1) || t_len % kBQ != 0 || b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, dout, static_cast<const float*>(l),
               static_cast<const float*>(m), static_cast<const float*>(delta), dq,
               static_cast<float*>(db), b, heads, t_len, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (bias_dtype == 0) return dispatch<float>(dtype, d, a);
  if (bias_dtype == 1) return dispatch<__nv_bfloat16>(dtype, d, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
