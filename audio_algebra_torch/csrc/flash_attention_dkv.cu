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
// Design: a block owns the dk and dv rows of its keys, looping over the
// 64-query tiles, so nothing is summed across blocks and there are no
// atomics: the same bits every run. The score tile is kept in the (key,
// query) orientation of biasT, whose tile is then read as it lies. All four
// products (sT = K.Q^T, dpT = V.dO^T, dv += pT.dO, dk += dsT.Q) run on the
// tensor cores through mma.sync, and the pT and dsT accumulator fragments
// become the A operands of the dv and dk products in registers, never
// passing through shared memory. Both routes run eight warps and stage the
// query tiles by cp.async into two stages.
//   bf16: m16n8k16 (bf16 in, f32 accumulate), every fragment by ldmatrix;
//         a block serves a group of batch rows of one (key tile, head), so
//         each bias tile is read once for all of them (its own comment
//         below).
//   f32:  3xTF32 m16n8k8: each operand is split into its TF32 rounding hi
//         and the TF32 rounding of the remainder lo, and alo.bhi + ahi.blo
//         + ahi.bhi are accumulated in f32, which keeps f32's tolerance
//         where plain TF32 does not. One block per (batch * head, 64-key
//         tile); warp w owns key rows
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
// its bytes); bf16: the 4 products at the bf16 peak, 0.0695 ms at (8, 16,
// 1024, 64) (0.041 ms for its 136 MB with a bf16 bias; ~0.03 ms for its 134 M
// exponentials on the MUFU pipe). One block of 8 warps per SM in f32
// (shared memory: 174 KB at D = 64). Measured by chip_smoke.py at (8, 16,
// 1024, 64) f32 on an NVIDIA H100 80GB HBM3 at 700 W: 1.68-1.70 ms, where
// the CUDA-core design it replaced took 3.41-3.44 ms.
//
// C interface (bound with ctypes): aa_flash_attention_dkv launches one
// kernel on the given stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError().

#include "flash_common.cuh"

namespace {

using namespace aa_flash;

constexpr int kThreadsTc = 256;     // eight warps, both designs
constexpr int kMaxSmem = 232448;
constexpr int kBiasLDS = kBQ + 8;    // staged bias row stride: the (row g, column
                                     // 2 tg) pair reads hit 32 banks, f32 or bf16

__device__ __forceinline__ float2 bias_pair(const float* bs, int r, int c) {
  return *reinterpret_cast<const float2*>(bs + r * kBiasLDS + c);
}

__device__ __forceinline__ float2 bias_pair(const __nv_bfloat16* bs, int r, int c) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(bs + r * kBiasLDS + c);
  return make_float2(aa::bf16_lo(w), aa::bf16_hi(w));
}

// ---------------------------------------------------------------- bf16 ---
// One block per (group of NB batch rows, tile of BK = 16 MK KS keys, head
// h), eight warps, KS = 4: warp w serves batch row
// w / (KS QH) of the group, MK m-tiles of 16 keys from 16 MK (w mod KS)
// of the block's BK, and query part (w / KS) mod QH (64 / QH queries) of
// every 64-query tile, in steps of QW = 32 queries (the scores of a step,
// MK x QW per warp, stay in registers beside the dk, dv accumulators). The
// two blocks that dispatch_bf16 takes:
//   NB 2, MK 2, QH 1 (two batch rows of 128 keys): B > 1, D <= 64 and T a
//                 multiple of 128; each Q and dO fragment serves two key
//                 m-tiles
//   NB 1, MK 1, QH 2 (one batch row of 64 keys): otherwise; at D = 128
//                 more scores do not fit beside dk, dv
// The group's k and v (NB x BK rows) are copied into shared memory once and
// stay there for the whole query loop. Each query tile's q and dO of the
// group's rows, its (BK, 64) bias tile (ONCE for the NB rows) and the
// queries' m, l and delta arrive by cp.async into one of two stages while
// the other is in use. The grid's fastest axis is the batch group, so the
// groups of one (key tile, head) run side by side and share the bias tile
// in L2 as well. Every fragment loads by ldmatrix: K and V as the A
// operands of sT = K.Q^T and dpT = V.dO^T, q and dO as their B operands,
// and transposed as the B operands of dv += pT.dO and dk += dsT.Q, whose A
// operands are the pT and dsT accumulators themselves, rounded to bf16 in
// registers. The probabilities are recomputed in base 2 (log2 e folded
// into sm_scale and into bias - m; ex2.approx). A warp owns its keys' dk
// and dv rows of its batch row outright (QH = 1), or the two query parts
// add their partials through shared memory in a fixed order at the end
// (QH = 2): no atomics, the same bits every run.
template <int D, typename TB, int NB, int MK, int QH>
struct PlanDkvBf16 {
  static constexpr int KS = 4;                            // key warps of a query part
  static constexpr int QW = 32;                           // queries of a step
  static constexpr int BK = 16 * MK * KS;                 // keys of a block
  static constexpr int LD = D + 8;                        // bf16 row stride: 16 bytes of pad
  static constexpr int kKV = 2 * NB * BK * LD * 2;        // bytes: the group's k and v
  static constexpr int kQD = 2 * NB * kBQ * LD * 2;       // q and dO of a query tile
  static constexpr int kBias = BK * kBiasLDS * static_cast<int>(sizeof(TB));
  static constexpr int kStage = kQD + kBias + 3 * NB * kBQ * 4;
  static constexpr int kStages = kKV + 2 * kStage <= kMaxSmem ? 2 : 1;
  static constexpr int kSmem = kKV + kStages * kStage;
  static constexpr int kRedLD = D + 8;                    // the QH = 2 partials, f32
  static constexpr int kThreads = NB * KS * QH * 32;
  static_assert(kThreads == kThreadsTc, "K4b bf16 runs eight warps");
  static_assert((kBQ / QH) % QW == 0 && QW % 16 == 0, "query steps of whole m16 k-steps");
  static_assert(kSmem <= kMaxSmem, "K4b bf16's tiles do not fit");
  static_assert(QH == 1 || 2 * NB * BK * kRedLD * 4 <= kStages * kStage,
                "K4b bf16's partials do not fit");
};

template <int D, typename TB, int NB, int MK, int QH>
__global__ void __launch_bounds__(PlanDkvBf16<D, TB, NB, MK, QH>::kThreads, 1)
flash_dkv_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const TB* __restrict__ bias,
               const uint16_t* __restrict__ dout, const float* __restrict__ l,
               const float* __restrict__ m, const float* __restrict__ delta,
               uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int batch, int heads,
               int t_len, float sm_scale) {
  using P = PlanDkvBf16<D, TB, NB, MK, QH>;
  constexpr int BK = P::BK, LD = P::LD, S = P::kStages, NT = P::kThreads;
  constexpr int KS = P::KS, QW = P::QW;
  constexpr int KD = D / 16;           // k-steps of sT and dpT
  constexpr int ND = D / 8;            // 8-wide dim tiles of dk, dv
  constexpr int QP = kBQ / QH;         // queries of a warp's part of a tile
  constexpr int NQ = QW / 8;           // 8-wide query tiles of a step
  constexpr int CD = D / 8;            // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* ksm = reinterpret_cast<uint16_t*>(smem);
  uint16_t* vsm = ksm + NB * BK * LD;
  unsigned char* stages = smem + P::kKV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lr = lane & 7, lmid = (lane >> 3) & 1, lhi = (lane >> 4) & 1;   // ldmatrix roles
  const int slot = warp / (KS * QH), r0 = 16 * MK * (warp % KS), qb = QP * ((warp / KS) % QH);
  const int b0 = blockIdx.x * NB, s0 = blockIdx.y * BK, h = blockIdx.z;
  const int nb = min(NB, batch - b0);                       // batch rows of this group
  const bool active = slot < nb;
  const int n_tiles = t_len / kBQ;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;
  auto head = [&](int s) {                                   // (b0 + s, h) offset
    return (static_cast<size_t>(b0 + s) * heads + h) * t_len * D;
  };
  auto rows = [&](int s) {                                   // (h, b0 + s) of (H, B, T)
    return (static_cast<size_t>(h) * batch + b0 + s) * t_len;
  };

  // the group's k and v, once
  for (int i = tid; i < NB * BK * CD; i += NT) {
    const int s = i / (BK * CD), r = (i / CD) % BK, c = (i % CD) * 8;
    if (s < nb) {
      const size_t src = head(s) + static_cast<size_t>(s0 + r) * D + c;
      cp_async16(ksm + (s * BK + r) * LD + c, k + src);
      cp_async16(vsm + (s * BK + r) * LD + c, v + src);
    }
  }
  // query tile n into stage n mod S: q, dO, the bias tile, then m, l, delta
  auto fetch = [&](int n) {
    const int t0 = n * kBQ;
    unsigned char* st = stages + (n % S) * P::kStage;
    uint16_t* qs = reinterpret_cast<uint16_t*>(st);
    uint16_t* ds = qs + NB * kBQ * LD;
    for (int i = tid; i < NB * kBQ * CD; i += NT) {
      const int s = i / (kBQ * CD), r = (i / CD) % kBQ, c = (i % CD) * 8;
      if (s < nb) {
        const size_t src = head(s) + static_cast<size_t>(t0 + r) * D + c;
        cp_async16(qs + (s * kBQ + r) * LD + c, q + src);
        cp_async16(ds + (s * kBQ + r) * LD + c, dout + src);
      }
    }
    TB* bs = reinterpret_cast<TB*>(st + P::kQD);
    constexpr int E = 16 / sizeof(TB), CB = kBQ / E;
    for (int i = tid; i < BK * CB; i += NT) {
      const int r = i / CB, c = (i % CB) * E;
      cp_async16(bs + r * kBiasLDS + c, bias_h + static_cast<size_t>(s0 + r) * t_len + t0 + c);
    }
    float* rs = reinterpret_cast<float*>(st + P::kQD + P::kBias);
    for (int i = tid; i < 3 * NB * (kBQ / 4); i += NT) {
      const int which = i / (NB * kBQ / 4), s = (i / (kBQ / 4)) % NB, c = (i % (kBQ / 4)) * 4;
      const float* src = which == 0 ? m : which == 1 ? l : delta;
      if (s < nb) cp_async16(rs + (which * NB + s) * kBQ + c, src + rows(s) + t0 + c);
    }
    cp_async_commit();
  };
  fetch(0);

  float dka[MK][ND][4], dva[MK][ND][4];
#pragma unroll
  for (int mk = 0; mk < MK; ++mk)
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[mk][d][e] = dva[mk][d][e] = 0.f;
  const float scale2 = sm_scale * kLog2e;
  const uint16_t* kw = ksm + (slot * BK + r0 + lr + 8 * lmid) * LD + 8 * lhi;   // A rows
  const uint16_t* vw = vsm + (slot * BK + r0 + lr + 8 * lmid) * LD + 8 * lhi;

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
    if (active) {
      const unsigned char* st = stages + (n % S) * P::kStage;
      const TB* bs = reinterpret_cast<const TB*>(st + P::kQD);
      const float* rs = reinterpret_cast<const float*>(st + P::kQD + P::kBias) + slot * kBQ;
#pragma unroll 1
      for (int q0 = qb; q0 < qb + QP; q0 += QW) {            // the warp's query steps
        const uint16_t* qs = reinterpret_cast<const uint16_t*>(st) + (slot * kBQ + q0) * LD;
        const uint16_t* ds = qs + NB * kBQ * LD;

        // sT = K.Q^T and dpT = V.dO^T: the warp's 16 MK keys x QW queries
        float s[MK][NQ][4], dp[MK][NQ][4];
#pragma unroll
        for (int mk = 0; mk < MK; ++mk)
#pragma unroll
          for (int j = 0; j < NQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mk][j][e] = dp[mk][j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t ka[MK][4], va[MK][4];
#pragma unroll
          for (int mk = 0; mk < MK; ++mk) {
            ldsm_x4(ka[mk], kw + 16 * mk * LD + 16 * kk);
            ldsm_x4(va[mk], vw + 16 * mk * LD + 16 * kk);
          }
#pragma unroll
          for (int jp = 0; jp < NQ / 2; ++jp) {
            const int off = (16 * jp + lr + 8 * lhi) * LD + 16 * kk + 8 * lmid;
            uint32_t qf[4], df[4];   // the B fragments of query tiles 2 jp, 2 jp + 1
            ldsm_x4(qf, qs + off);
            ldsm_x4(df, ds + off);
#pragma unroll
            for (int mk = 0; mk < MK; ++mk) {
              mma_bf16(s[mk][2 * jp], ka[mk], qf[0], qf[1]);
              mma_bf16(s[mk][2 * jp + 1], ka[mk], qf[2], qf[3]);
              mma_bf16(dp[mk][2 * jp], va[mk], df[0], df[1]);
              mma_bf16(dp[mk][2 * jp + 1], va[mk], df[2], df[3]);
            }
          }
        }
        // pT into s, dsT into dp: keys r0 + 16 mk + g (+ 8), queries q0 + 8 j
        // + 2 tg (+ 1)
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int c = q0 + 8 * j + 2 * tg;
          const float2 mm = *reinterpret_cast<const float2*>(rs + c);
          const float2 ll = *reinterpret_cast<const float2*>(rs + NB * kBQ + c);
          const float2 de = *reinterpret_cast<const float2*>(rs + 2 * NB * kBQ + c);
          const float il0 = 1.0f / ll.x, il1 = 1.0f / ll.y;
#pragma unroll
          for (int mk = 0; mk < MK; ++mk) {
            const int kr = r0 + 16 * mk + g;
            const float2 bb0 = bias_pair(bs, kr, c), bb1 = bias_pair(bs, kr + 8, c);
            float* sj = s[mk][j];
            float* dj = dp[mk][j];
            sj[0] = exp2_ftz(fmaf(sj[0], scale2, (bb0.x - mm.x) * kLog2e)) * il0;
            sj[1] = exp2_ftz(fmaf(sj[1], scale2, (bb0.y - mm.y) * kLog2e)) * il1;
            sj[2] = exp2_ftz(fmaf(sj[2], scale2, (bb1.x - mm.x) * kLog2e)) * il0;
            sj[3] = exp2_ftz(fmaf(sj[3], scale2, (bb1.y - mm.y) * kLog2e)) * il1;
            dj[0] = sj[0] * (dj[0] - de.x);
            dj[1] = sj[1] * (dj[1] - de.y);
            dj[2] = sj[2] * (dj[2] - de.x);
            dj[3] = sj[3] * (dj[3] - de.y);
          }
        }
        // dv += pT.dO and dk += dsT.Q, the k index over the step's queries:
        // the C fragments of query tiles 2 kk, 2 kk + 1 are the A fragment of
        // step kk
#pragma unroll
        for (int kk = 0; kk < NQ / 2; ++kk) {
          uint32_t pa[MK][4], da[MK][4];
#pragma unroll
          for (int mk = 0; mk < MK; ++mk) {
            pa[mk][0] = pack_bf16x2(s[mk][2 * kk][0], s[mk][2 * kk][1]);
            pa[mk][1] = pack_bf16x2(s[mk][2 * kk][2], s[mk][2 * kk][3]);
            pa[mk][2] = pack_bf16x2(s[mk][2 * kk + 1][0], s[mk][2 * kk + 1][1]);
            pa[mk][3] = pack_bf16x2(s[mk][2 * kk + 1][2], s[mk][2 * kk + 1][3]);
            da[mk][0] = pack_bf16x2(dp[mk][2 * kk][0], dp[mk][2 * kk][1]);
            da[mk][1] = pack_bf16x2(dp[mk][2 * kk][2], dp[mk][2 * kk][3]);
            da[mk][2] = pack_bf16x2(dp[mk][2 * kk + 1][0], dp[mk][2 * kk + 1][1]);
            da[mk][3] = pack_bf16x2(dp[mk][2 * kk + 1][2], dp[mk][2 * kk + 1][3]);
          }
#pragma unroll
          for (int dd = 0; dd < ND / 2; ++dd) {
            const int off = (16 * kk + lr + 8 * lmid) * LD + 16 * dd + 8 * lhi;
            uint32_t of[4], qf[4];   // dO and Q transposed: dims 16 dd .. + 15
            ldsm_x4_t(of, ds + off);
            ldsm_x4_t(qf, qs + off);
#pragma unroll
            for (int mk = 0; mk < MK; ++mk) {
              mma_bf16(dva[mk][2 * dd], pa[mk], of[0], of[1]);
              mma_bf16(dva[mk][2 * dd + 1], pa[mk], of[2], of[3]);
              mma_bf16(dka[mk][2 * dd], da[mk], qf[0], qf[1]);
              mma_bf16(dka[mk][2 * dd + 1], da[mk], qf[2], qf[3]);
            }
          }
        }
      }
    }
    __syncthreads();                   // the stage is free
  }

  constexpr int RL = P::kRedLD;
  if constexpr (QH == 2) {
    // query part 1 hands its partials to part 0, which adds them in that order
    float* red = reinterpret_cast<float*>(stages) + slot * 2 * BK * RL;
    if (active && qb != 0) {
#pragma unroll
      for (int mk = 0; mk < MK; ++mk) {
        const int o0 = (r0 + 16 * mk + g) * RL + 2 * tg, o1 = o0 + 8 * RL;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const float* ka = dka[mk][d];
          const float* va = dva[mk][d];
          *reinterpret_cast<float2*>(red + o0 + 8 * d) = make_float2(ka[0], ka[1]);
          *reinterpret_cast<float2*>(red + o1 + 8 * d) = make_float2(ka[2], ka[3]);
          *reinterpret_cast<float2*>(red + BK * RL + o0 + 8 * d) = make_float2(va[0], va[1]);
          *reinterpret_cast<float2*>(red + BK * RL + o1 + 8 * d) = make_float2(va[2], va[3]);
        }
      }
    }
    __syncthreads();
    if (!active || qb != 0) return;
#pragma unroll
    for (int mk = 0; mk < MK; ++mk) {
      const int o0 = (r0 + 16 * mk + g) * RL + 2 * tg, o1 = o0 + 8 * RL;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const float2 k0 = *reinterpret_cast<const float2*>(red + o0 + 8 * d);
        const float2 k1 = *reinterpret_cast<const float2*>(red + o1 + 8 * d);
        const float2 v0 = *reinterpret_cast<const float2*>(red + BK * RL + o0 + 8 * d);
        const float2 v1 = *reinterpret_cast<const float2*>(red + BK * RL + o1 + 8 * d);
        float* ka = dka[mk][d];
        float* va = dva[mk][d];
        ka[0] += k0.x; ka[1] += k0.y; ka[2] += k1.x; ka[3] += k1.y;
        va[0] += v0.x; va[1] += v0.y; va[2] += v1.x; va[3] += v1.y;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int mk = 0; mk < MK; ++mk) {
    const size_t out0 = head(slot) + static_cast<size_t>(s0 + r0 + 16 * mk + g) * D + 2 * tg;
    const size_t out1 = out0 + 8 * D;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const float* ka = dka[mk][d];
      const float* va = dva[mk][d];
      *reinterpret_cast<uint32_t*>(dk + out0 + 8 * d) =
          pack_bf16x2(ka[0] * sm_scale, ka[1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dk + out1 + 8 * d) =
          pack_bf16x2(ka[2] * sm_scale, ka[3] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + out0 + 8 * d) = pack_bf16x2(va[0], va[1]);
      *reinterpret_cast<uint32_t*>(dv + out1 + 8 * d) = pack_bf16x2(va[2], va[3]);
    }
  }
}

// ------------------------------------------------------------ f32: 3xTF32 ---

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

template <int D, typename TB, int NB, int MK, int QH>
int launch_bf16(const Args& a) {
  using P = PlanDkvBf16<D, TB, NB, MK, QH>;
  auto kernel = flash_dkv_bf16<D, TB, NB, MK, QH>;
  static bool configured = false;    // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  kernel<<<dim3((a.b + NB - 1) / NB, a.t_len / P::BK, a.heads), P::kThreads, P::kSmem,
           a.st>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<const uint16_t*>(a.dout), a.l, a.m, a.delta,
      static_cast<uint16_t*>(a.dk), static_cast<uint16_t*>(a.dv), a.b, a.heads, a.t_len,
      a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 route's block (the plans above flash_dkv_bf16): two batch rows
// of 128 keys where B > 1, D <= 64 and T is a multiple of 128, else one
// batch row of 64 keys.
template <int D, typename TB>
int dispatch_bf16(const Args& a) {
  if constexpr (D <= 64) {
    if (a.b > 1 && a.t_len % 128 == 0) return launch_bf16<D, TB, 2, 2, 1>(a);
  }
  return launch_bf16<D, TB, 1, 1, 2>(a);
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
    return dtype == 1 ? dispatch_bf16<DV, TB>(a) : launch_f32<DV, TB>(a);
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
  if ((dtype != 0 && dtype != 1) || t_len % kBQ != 0 || b < 1 || heads < 1 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, dout, static_cast<const float*>(l),
               static_cast<const float*>(m), static_cast<const float*>(delta), dk, dv,
               b, heads, t_len, sm_scale, static_cast<cudaStream_t>(stream)};
  if (bias_dtype == 0) return dispatch<float>(dtype, d, a);
  if (bias_dtype == 1) return dispatch<__nv_bfloat16>(dtype, d, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
