// Backward of the rel-pos flash attention with respect to K and V, for
// Hopper (sm_90a): kernel K4b of the port.
//
// Replaces: audio_algebra_tpu/ops/pallas/flash_attention.py:
// _bwd_dkv_kernel_t (launched by _train_bwd of flash_attention_relpos_train).
//
// Computes, for q, k, v, do of shape (B, H, T, D), the TRANSPOSED bias biasT
// (H, S = T, T) and the forward's residuals l, m and delta = sum_d do * o,
// all f32 (H, B, T):
//   sT[s, t] = k[s] . q[t] * sm_scale + biasT[h, s, t]        (f32)
//   pT       = exp(sT - m[t]) / l[t]       (from the FINAL row max and sum)
//   dv[s]    = sum_t cast(pT[s, t]) * do[t]
//   dsT      = pT * (v[s] . do[t] - delta[t])
//   dk[s]    = sm_scale * sum_t cast(dsT[s, t]) * q[t]
// with pT and dsT cast to the inputs' dtype before their products, f32
// accumulation, and dk, dv cast at the end, as the TPU kernel does. The
// probabilities are multiplied by 1 / l (one rounding from the division).
//
// Design: one block per (batch * head, 64-key tile) with a loop over the
// 64-query tiles; the block owns its rows of dk and dv, so nothing is
// summed across blocks and there are no atomics. The score tile is kept in
// the (key, query) orientation of biasT, whose tile is then read as it
// lies. The Q, dO and bias tiles and the queries' m, 1 / l and delta are
// staged in shared memory; dk and dv accumulate in registers.
//   bf16: four warps, 16 key rows each; the four products run on the
//         tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate);
//         the pT and dsT fragments are re-packed in registers as the A
//         operands of the dv and dk products.
//   f32:  CUDA-core FMA, four threads per key row, each holding D / 4 of
//         its dims in 16-byte pieces, so that f32 results agree with the
//         plain version to 2e-4.
//
// Bound: operations in f32 (8 B H T^2 D at the f32 peak: 1.03 ms at
// (8, 16, 1024, 64) on an H100 SXM, against 0.08 ms for its bytes); bytes
// in bf16 on the tensor cores. Not pipelined (no cp.async or TMA, no wgmma).
//
// C interface (bound with ctypes): aa_flash_attention_dkv launches one
// kernel on the given stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError().

#include "flash_common.cuh"

namespace {

using namespace aa_flash;

// ---------------------------------------------------------------- bf16 ---
// 128 threads; warp w owns key rows 16w..16w+15 of the tile. Fragments as
// in flash_attention.cu: lane = 4*g + tg holds rows g and g + 8 and columns
// 2*tg, 2*tg + 1 of each 8-wide column tile.
template <int D, typename TB>
__global__ void __launch_bounds__(128)
flash_dkv_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const TB* __restrict__ bias,
               const uint16_t* __restrict__ dout, const float* __restrict__ l,
               const float* __restrict__ m, const float* __restrict__ delta,
               uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int heads,
               int t_len, float sm_scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NQ = kBQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* vs = ks + kBK * LD;
  uint16_t* qs = vs + kBK * LD;
  uint16_t* dos = qs + kBQ * LD;
  float* bs = reinterpret_cast<float*>(dos + kBQ * LD);
  float* ms = bs + kBK * kBiasLD;
  float* ils = ms + kBQ;
  float* des = ils + kBQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, h = bh % heads;
  const int batch = gridDim.y / heads;
  const int s0 = blockIdx.x * kBK;
  const int r0 = warp * 16;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const size_t rows = (static_cast<size_t>(h) * batch + bh / heads) * t_len;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;

  load_tile<uint16_t, D>(k + head + static_cast<size_t>(s0) * D, ks, LD, kBK, tid, 128);
  load_tile<uint16_t, D>(v + head + static_cast<size_t>(s0) * D, vs, LD, kBK, tid, 128);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    dka[d][0] = dka[d][1] = dka[d][2] = dka[d][3] = 0.f;
    dva[d][0] = dva[d][1] = dva[d][2] = dva[d][3] = 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += kBQ) {
    __syncthreads();                 // every warp is done with the last tile
    load_tile<uint16_t, D>(q + head + static_cast<size_t>(t0) * D, qs, LD, kBQ, tid, 128);
    load_tile<uint16_t, D>(dout + head + static_cast<size_t>(t0) * D, dos, LD, kBQ, tid,
                           128);
    load_bias_tile<TB>(bias_h, t_len, s0, t0, bs, tid, 128);
    if (tid < kBQ) {
      ms[tid] = m[rows + t0 + tid];
      ils[tid] = 1.0f / l[rows + t0 + tid];
      des[tid] = delta[rows + t0 + tid];
    }
    __syncthreads();

    // sT = K.Q^T and dpT = V.dO^T: rows are keys, columns queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      load_a_frag(ka, ks, LD, r0, 16 * kk, g, tg);
      load_a_frag(va, vs, LD, r0, 16 * kk, g, tg);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int off = (8 * j + g) * LD + 16 * kk + 2 * tg;
        mma_bf16(s[j], ka, ld32(qs + off), ld32(qs + off + 8));
        mma_bf16(dp[j], va, ld32(dos + off), ld32(dos + off + 8));
      }
    }
    // pT into s, dsT into dp
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c = 8 * j + 2 * tg;
      const float* b0 = bs + (r0 + g) * kBiasLD + c;
      const float* b1 = b0 + 8 * kBiasLD;
      const float m0 = ms[c], m1 = ms[c + 1];
      const float il0 = ils[c], il1 = ils[c + 1];
      const float de0 = des[c], de1 = des[c + 1];
      s[j][0] = expf(s[j][0] * sm_scale + b0[0] - m0) * il0;
      s[j][1] = expf(s[j][1] * sm_scale + b0[1] - m1) * il1;
      s[j][2] = expf(s[j][2] * sm_scale + b1[0] - m0) * il0;
      s[j][3] = expf(s[j][3] * sm_scale + b1[1] - m1) * il1;
      dp[j][0] = s[j][0] * (dp[j][0] - de0);
      dp[j][1] = s[j][1] * (dp[j][1] - de1);
      dp[j][2] = s[j][2] * (dp[j][2] - de0);
      dp[j][3] = s[j][3] * (dp[j][3] - de1);
    }
    // dv += pT.dO and dk += dsT.Q: the k index runs over the queries
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a_frag(pa, s[2 * kk], s[2 * kk + 1]);
      c_to_a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
      const int off = (16 * kk + 2 * tg) * LD + g;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const uint16_t* dc = dos + off + 8 * d;
        const uint16_t* qc = qs + off + 8 * d;
        mma_bf16(dva[d], pa, pack16(dc[0], dc[LD]), pack16(dc[8 * LD], dc[9 * LD]));
        mma_bf16(dka[d], da, pack16(qc[0], qc[LD]), pack16(qc[8 * LD], qc[9 * LD]));
      }
    }
  }

  const size_t out0 = head + static_cast<size_t>(s0 + r0 + g) * D + 2 * tg;
  const size_t out1 = out0 + 8 * D;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    *reinterpret_cast<uint32_t*>(dk + out0 + 8 * d) =
        aa::bf16_pack(dka[d][0] * sm_scale, dka[d][1] * sm_scale);
    *reinterpret_cast<uint32_t*>(dk + out1 + 8 * d) =
        aa::bf16_pack(dka[d][2] * sm_scale, dka[d][3] * sm_scale);
    *reinterpret_cast<uint32_t*>(dv + out0 + 8 * d) = aa::bf16_pack(dva[d][0], dva[d][1]);
    *reinterpret_cast<uint32_t*>(dv + out1 + 8 * d) = aa::bf16_pack(dva[d][2], dva[d][3]);
  }
}

// ----------------------------------------------------------------- f32 ---
// 256 threads: key row tid / 4 of the tile; the thread holds the dims
// 16 i + 4 quarter + {0..3} of it, so that the four threads of a row read
// 64 contiguous bytes of a staged row at a time.
template <int D, typename TB>
__global__ void __launch_bounds__(256)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const TB* __restrict__ bias,
              const float* __restrict__ dout, const float* __restrict__ l,
              const float* __restrict__ m, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int heads, int t_len,
              float sm_scale) {
  constexpr int NV = D / 16;         // 16-byte pieces per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kBQ * D;
  float* bs = dos + kBQ * D;
  float* ms = bs + kBK * kBiasLD;
  float* ils = ms + kBQ;
  float* des = ils + kBQ;

  const int tid = threadIdx.x, row = tid >> 2, quarter = tid & 3;
  const int bh = blockIdx.y, h = bh % heads;
  const int batch = gridDim.y / heads;
  const int s0 = blockIdx.x * kBK;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const size_t rows = (static_cast<size_t>(h) * batch + bh / heads) * t_len;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;
  const size_t mine = head + static_cast<size_t>(s0 + row) * D + 4 * quarter;

  float4 kr[NV], vr[NV], dka[NV], dva[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    kr[i] = *reinterpret_cast<const float4*>(k + mine + 16 * i);
    vr[i] = *reinterpret_cast<const float4*>(v + mine + 16 * i);
    dka[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t0 = 0; t0 < t_len; t0 += kBQ) {
    __syncthreads();
    load_tile<float, D>(q + head + static_cast<size_t>(t0) * D, qs, D, kBQ, tid, 256);
    load_tile<float, D>(dout + head + static_cast<size_t>(t0) * D, dos, D, kBQ, tid, 256);
    load_bias_tile<TB>(bias_h, t_len, s0, t0, bs, tid, 256);
    if (tid < kBQ) {
      ms[tid] = m[rows + t0 + tid];
      ils[tid] = 1.0f / l[rows + t0 + tid];
      des[tid] = delta[rows + t0 + tid];
    }
    __syncthreads();

    for (int j = 0; j < kBQ; ++j) {
      const float4* qj = reinterpret_cast<const float4*>(qs + j * D + 4 * quarter);
      const float4* dj = reinterpret_cast<const float4*>(dos + j * D + 4 * quarter);
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 a = qj[4 * i], c = dj[4 * i];
        ps = fmaf(kr[i].x, a.x, ps); ps = fmaf(kr[i].y, a.y, ps);
        ps = fmaf(kr[i].z, a.z, ps); ps = fmaf(kr[i].w, a.w, ps);
        pd = fmaf(vr[i].x, c.x, pd); pd = fmaf(vr[i].y, c.y, pd);
        pd = fmaf(vr[i].z, c.z, pd); pd = fmaf(vr[i].w, c.w, pd);
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      pd += __shfl_xor_sync(0xffffffffu, pd, 1);
      pd += __shfl_xor_sync(0xffffffffu, pd, 2);
      const float p = expf(ps * sm_scale + bs[row * kBiasLD + j] - ms[j]) * ils[j];
      const float ds = p * (pd - des[j]);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 a = qj[4 * i], c = dj[4 * i];
        dva[i].x = fmaf(p, c.x, dva[i].x); dva[i].y = fmaf(p, c.y, dva[i].y);
        dva[i].z = fmaf(p, c.z, dva[i].z); dva[i].w = fmaf(p, c.w, dva[i].w);
        dka[i].x = fmaf(ds, a.x, dka[i].x); dka[i].y = fmaf(ds, a.y, dka[i].y);
        dka[i].z = fmaf(ds, a.z, dka[i].z); dka[i].w = fmaf(ds, a.w, dka[i].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    *reinterpret_cast<float4*>(dk + mine + 16 * i) =
        make_float4(dka[i].x * sm_scale, dka[i].y * sm_scale, dka[i].z * sm_scale,
                    dka[i].w * sm_scale);
    *reinterpret_cast<float4*>(dv + mine + 16 * i) = dva[i];
  }
}

struct Args {
  const void *q, *k, *v, *bias, *dout;
  const float *l, *m, *delta;
  void *dk, *dv;
  int b, heads, t_len;
  float sm_scale;
  cudaStream_t st;
};

template <int D, typename TB>
int launch_bf16(const Args& a) {
  constexpr int LD = D + 8;
  constexpr size_t kSmem = 4 * kBQ * LD * sizeof(uint16_t)
                           + (kBK * kBiasLD + 3 * kBQ) * sizeof(float);
  auto kernel = flash_dkv_bf16<D, TB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.t_len / kBK, a.b * a.heads), 128, kSmem, a.st>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<const uint16_t*>(a.dout), a.l, a.m, a.delta,
      static_cast<uint16_t*>(a.dk), static_cast<uint16_t*>(a.dv), a.heads, a.t_len,
      a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename TB>
int launch_f32(const Args& a) {
  constexpr size_t kSmem = (2 * kBQ * D + kBK * kBiasLD + 3 * kBQ) * sizeof(float);
  auto kernel = flash_dkv_f32<D, TB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.t_len / kBK, a.b * a.heads), 256, kSmem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<const float*>(a.dout), a.l, a.m, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.heads, a.t_len, a.sm_scale);
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

// dtype (of q, k, v, dout, dk and dv) and bias_dtype: 0 = float32,
// 1 = bfloat16. q, k, v, dout, dk, dv: contiguous (B, H, T, D), 16-byte
// aligned; bias: contiguous (H, T, T) transposed bias; l, m, delta:
// contiguous f32 (H, B, T). T must be a multiple of 64 and D one of 16, 32,
// 64, 128. Returns cudaGetLastError().
extern "C" int aa_flash_attention_dkv(int dtype, int bias_dtype, const void* q,
                                      const void* k, const void* v, const void* bias,
                                      const void* dout, const void* l, const void* m,
                                      const void* delta, void* dk, void* dv, int b,
                                      int heads, int t_len, int d, float sm_scale,
                                      void* stream) {
  if ((dtype != 0 && dtype != 1) || t_len % kBQ != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, dout, static_cast<const float*>(l),
               static_cast<const float*>(m), static_cast<const float*>(delta), dk, dv,
               b, heads, t_len, sm_scale, static_cast<cudaStream_t>(stream)};
  if (bias_dtype == 0) return dispatch<float>(dtype, d, a);
  if (bias_dtype == 1) return dispatch<__nv_bfloat16>(dtype, d, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
