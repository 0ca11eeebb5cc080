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
// summed across blocks and there are no atomics: the same bits every run.
// The score tile is kept in the (key, query) orientation of biasT, whose
// tile is then read as it lies. All four products (sT = K.Q^T, dpT =
// V.dO^T, dv += pT.dO, dk += dsT.Q) run on the tensor cores through
// mma.sync, and the pT and dsT accumulator fragments become the A operands
// of the dv and dk products in registers, never passing through shared
// memory.
//   bf16: four warps, 16 key rows each, m16n8k16 (bf16 in, f32
//         accumulate); Q, dO and the bias tile staged synchronously.
//   f32:  3xTF32 m16n8k8: each operand is split into its TF32 rounding hi
//         and the TF32 rounding of the remainder lo, and alo.bhi + ahi.blo
//         + ahi.bhi are accumulated in f32, which keeps f32's tolerance
//         where plain TF32 does not. Eight warps: warp w owns key rows
//         16 (w mod 4) .. + 15 and queries 32 (w / 4) .. + 31 of each query
//         tile. The block's k and v are split into hi and lo ONCE, into
//         shared memory, since the block keeps its keys for the whole
//         query loop; q and dO (B operands) are split as they are read. For
//         the dv and dk products TF32's k index is permuted (query 2 tg for
//         column tg, 2 tg + 1 for tg + 4), so that a C fragment is an A
//         fragment as it lies, and dO and Q are read with the same
//         permutation. The Q, dO and bias tiles and the queries' m, l and
//         delta arrive by cp.async into two stages (one at D = 128, where
//         two do not fit beside k and v), the next tile loading while this
//         one computes. Tile rows have a stride of D + 4 floats, so the
//         scalar fragment reads hit 32 banks both along a row (sT, dpT)
//         and down a column (dv, dk). At the end the two query halves add
//         their dk, dv partials in a fixed order through shared memory.
//
// Bound: operations. f32: the 4 products of 2 B H T^2 D at the dense TF32
// peak, three passes each (0.42 ms at (8, 16, 1024, 64) from an H100 SXM's
// published peaks at 700 W; 1.03 ms for the f32 CUDA-core peak; 0.08 ms for
// its bytes); bf16: the 4 products at the bf16 peak, or its bytes,
// whichever is larger. One block of 8 warps per SM (shared memory: 174 KB
// at D = 64). Measured by chip_smoke.py at (8, 16, 1024, 64) f32 on an
// NVIDIA H100 80GB HBM3 at 700 W: 1.68-1.70 ms, where the CUDA-core design
// it replaced took 3.41-3.44 ms.
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

// ------------------------------------------------------------ f32: 3xTF32 ---
constexpr int kThreadsTc = 256;
constexpr int kMaxSmem = 232448;
constexpr int kBiasLDS = kBQ + 8;    // staged bias row stride: the (row g, column
                                     // 2 tg) pair reads hit 32 banks, f32 or bf16

// Shared memory plan at head dim D: k and v split into hi and lo (uint32, 4
// tiles), then one or two stages of q, dO (f32), the bias tile (its own
// dtype) and the queries' m, l and delta.
template <int D, typename TB>
struct PlanDkv {
  static constexpr int LD = D + 4;
  static constexpr int kKV = 4 * kBK * LD * 4;
  static constexpr int kQD = 2 * kBQ * LD * 4;
  static constexpr int kBias = kBK * kBiasLDS * static_cast<int>(sizeof(TB));
  static constexpr int kStage = kQD + kBias + 3 * kBQ * 4;
  static constexpr int kStages = kKV + 2 * kStage <= kMaxSmem ? 2 : 1;
  static constexpr int kSmem = kKV + kStages * kStage;
  static constexpr int kRedLD = D + 8;   // the end's dk, dv partials (in the stage area)
  static_assert(kSmem <= kMaxSmem, "K4b's tiles do not fit");
  static_assert(2 * kBK * kRedLD * 4 <= kStages * kStage, "K4b's partials do not fit");
};

__device__ __forceinline__ float2 bias_pair(const float* bs, int r, int c) {
  return *reinterpret_cast<const float2*>(bs + r * kBiasLDS + c);
}

__device__ __forceinline__ float2 bias_pair(const __nv_bfloat16* bs, int r, int c) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(bs + r * kBiasLDS + c);
  return make_float2(aa::bf16_lo(w), aa::bf16_hi(w));
}

template <int D, typename TB>
__global__ void __launch_bounds__(kThreadsTc, 1)
flash_dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const TB* __restrict__ bias,
               const float* __restrict__ dout, const float* __restrict__ l,
               const float* __restrict__ m, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int heads, int t_len,
               float sm_scale) {
  using P = PlanDkv<D, TB>;
  constexpr int LD = P::LD, S = P::kStages, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* khi = reinterpret_cast<uint32_t*>(smem);
  uint32_t* klo = khi + kBK * LD;
  uint32_t* vhi = klo + kBK * LD;
  uint32_t* vlo = vhi + kBK * LD;
  unsigned char* stages = smem + P::kKV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = (warp & 3) * 16, qb = (warp >> 2) * 32;
  const int bh = blockIdx.y, h = bh % heads;
  const int batch = gridDim.y / heads;
  const int s0 = blockIdx.x * kBK;
  const int n_tiles = t_len / kBQ;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const size_t rows = (static_cast<size_t>(h) * batch + bh / heads) * t_len;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;

  // query tile n into stage n mod S: q, dO, the bias tile, then m, l, delta
  auto fetch = [&](int n) {
    const int t0 = n * kBQ;
    unsigned char* st = stages + (n % S) * P::kStage;
    float* qs = reinterpret_cast<float*>(st);
    async_tile<float, D>(q + head + static_cast<size_t>(t0) * D, qs, LD, tid, kThreadsTc);
    async_tile<float, D>(dout + head + static_cast<size_t>(t0) * D, qs + kBQ * LD, LD, tid,
                         kThreadsTc);
    TB* bs = reinterpret_cast<TB*>(st + P::kQD);
    constexpr int V = 16 / sizeof(TB), kChunks = kBQ / V;
    for (int i = tid; i < kBK * kChunks; i += kThreadsTc) {
      const int r = i / kChunks, c = (i % kChunks) * V;
      cp_async16(bs + r * kBiasLDS + c, bias_h + static_cast<size_t>(s0 + r) * t_len + t0 + c);
    }
    float* rs = reinterpret_cast<float*>(st + P::kQD + P::kBias);
    if (tid < 3 * kBQ / 4) {
      const int which = tid / (kBQ / 4), c = (tid % (kBQ / 4)) * 4;
      const float* src = which == 0 ? m : which == 1 ? l : delta;
      cp_async16(rs + which * kBQ + c, src + rows + t0 + c);
    }
    cp_async_commit();
  };
  fetch(0);

  // the block's k and v, split once
  for (int i = tid; i < kBK * (D / 4); i += kThreadsTc) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const size_t off = head + static_cast<size_t>(s0 + r) * D + c;
    const float4 a = *reinterpret_cast<const float4*>(k + off);
    const float4 b = *reinterpret_cast<const float4*>(v + off);
    const float ka[4] = {a.x, a.y, a.z, a.w}, va[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split(ka[e], khi[r * LD + c + e], klo[r * LD + c + e]);
      split(va[e], vhi[r * LD + c + e], vlo[r * LD + c + e]);
    }
  }

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    if constexpr (S == 2) {
      if (n + 1 < n_tiles) {
        fetch(n + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (n > 0) fetch(n);
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* st = stages + (n % S) * P::kStage;
    const float* qs = reinterpret_cast<const float*>(st);
    const float* dos = qs + kBQ * LD;
    const TB* bs = reinterpret_cast<const TB*>(st + P::kQD);
    const float* rs = reinterpret_cast<const float*>(st + P::kQD + P::kBias);

    // sT = K.Q^T and dpT = V.dO^T: 16 keys x 32 queries per warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int ao = (r0 + g) * LD + 8 * kk + tg;
      const int aoff[4] = {ao, ao + 8 * LD, ao + 4, ao + 8 * LD + 4};
      uint32_t kh[4], kl[4], vh[4], vl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kh[e] = khi[aoff[e]];
        kl[e] = klo[aoff[e]];
        vh[e] = vhi[aoff[e]];
        vl[e] = vlo[aoff[e]];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bo = (qb + 8 * j + g) * LD + 8 * kk + tg;
        mma_3xtf32(s[j], kh, kl, qs[bo], qs[bo + 4]);
        mma_3xtf32(dp[j], vh, vl, dos[bo], dos[bo + 4]);
      }
    }
    // pT into s, dsT into dp
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = qb + 8 * j + 2 * tg;
      const float2 b0 = bias_pair(bs, r0 + g, c), b1 = bias_pair(bs, r0 + g + 8, c);
      const float2 mm = *reinterpret_cast<const float2*>(rs + c);
      const float2 ll = *reinterpret_cast<const float2*>(rs + kBQ + c);
      const float2 de = *reinterpret_cast<const float2*>(rs + 2 * kBQ + c);
      const float il0 = 1.0f / ll.x, il1 = 1.0f / ll.y;
      s[j][0] = expf(s[j][0] * sm_scale + b0.x - mm.x) * il0;
      s[j][1] = expf(s[j][1] * sm_scale + b0.y - mm.y) * il1;
      s[j][2] = expf(s[j][2] * sm_scale + b1.x - mm.x) * il0;
      s[j][3] = expf(s[j][3] * sm_scale + b1.y - mm.y) * il1;
      dp[j][0] = s[j][0] * (dp[j][0] - de.x);
      dp[j][1] = s[j][1] * (dp[j][1] - de.y);
      dp[j][2] = s[j][2] * (dp[j][2] - de.x);
      dp[j][3] = s[j][3] * (dp[j][3] - de.y);
    }
    // dv += pT.dO and dk += dsT.Q over the warp's 32 queries: C (g, 2 tg |
    // 2 tg + 1) is A (g, tg | tg + 4), and B row tg | tg + 4 is query 2 tg |
    // 2 tg + 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
      split(dp[j][0], dh[0], dl[0]);
      split(dp[j][2], dh[1], dl[1]);
      split(dp[j][1], dh[2], dl[2]);
      split(dp[j][3], dh[3], dl[3]);
      const int bo = (qb + 8 * j + 2 * tg) * LD + g;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        mma_3xtf32(dva[d], ph, pl, dos[bo + 8 * d], dos[bo + LD + 8 * d]);
        mma_3xtf32(dka[d], dh, dl, qs[bo + 8 * d], qs[bo + LD + 8 * d]);
      }
    }
    __syncthreads();                   // the stage is free
  }

  // query half 1 hands its partials to half 0, which adds them in that order
  float* red = reinterpret_cast<float*>(stages);         // [dk, dv][64 x kRedLD]
  constexpr int RL = P::kRedLD;
  const int o0 = (r0 + g) * RL + 2 * tg, o1 = o0 + 8 * RL;
  if (qb != 0) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<float2*>(red + o0 + 8 * d) = make_float2(dka[d][0], dka[d][1]);
      *reinterpret_cast<float2*>(red + o1 + 8 * d) = make_float2(dka[d][2], dka[d][3]);
      *reinterpret_cast<float2*>(red + kBK * RL + o0 + 8 * d) = make_float2(dva[d][0], dva[d][1]);
      *reinterpret_cast<float2*>(red + kBK * RL + o1 + 8 * d) = make_float2(dva[d][2], dva[d][3]);
    }
  }
  __syncthreads();
  if (qb != 0) return;
  const size_t out0 = head + static_cast<size_t>(s0 + r0 + g) * D + 2 * tg;
  const size_t out1 = out0 + 8 * D;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const float2 k0 = *reinterpret_cast<const float2*>(red + o0 + 8 * d);
    const float2 k1 = *reinterpret_cast<const float2*>(red + o1 + 8 * d);
    const float2 v0 = *reinterpret_cast<const float2*>(red + kBK * RL + o0 + 8 * d);
    const float2 v1 = *reinterpret_cast<const float2*>(red + kBK * RL + o1 + 8 * d);
    *reinterpret_cast<float2*>(dk + out0 + 8 * d) =
        make_float2((dka[d][0] + k0.x) * sm_scale, (dka[d][1] + k0.y) * sm_scale);
    *reinterpret_cast<float2*>(dk + out1 + 8 * d) =
        make_float2((dka[d][2] + k1.x) * sm_scale, (dka[d][3] + k1.y) * sm_scale);
    *reinterpret_cast<float2*>(dv + out0 + 8 * d) =
        make_float2(dva[d][0] + v0.x, dva[d][1] + v0.y);
    *reinterpret_cast<float2*>(dv + out1 + 8 * d) =
        make_float2(dva[d][2] + v1.x, dva[d][3] + v1.y);
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
  constexpr int kSmem = PlanDkv<D, TB>::kSmem;
  auto kernel = flash_dkv_tf32<D, TB>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.t_len / kBK, a.b * a.heads), kThreadsTc, kSmem, a.st>>>(
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
