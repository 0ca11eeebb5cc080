// Blocked (flash) self-attention with an additive rel-pos bias, forward,
// for Hopper (sm_90a): kernels K3 (serving) and K4a (training, with the
// softmax residuals) of the port.
//
// Replaces: audio_algebra_tpu/ops/pallas/flash_attention.py:
// flash_attention_relpos and the forward of flash_attention_relpos_train
// (the Pallas body _fwd_kernel_t, launched by _fwd_impl).
//
// Computes, for q, k, v of shape (B, H, T, D) and the TRANSPOSED bias
// biasT (H, S = T, T) (biasT[h, s, t] is the bias of query t and key s):
//   o[b, h, t] = softmax_s(q[b,h,t] . k[b,h,s] * sm_scale + biasT[h,s,t]) . v[b,h]
// with the scores and the softmax statistics (running max m, normaliser l)
// in f32, P cast to v's dtype before the P.V product (f32 accumulation),
// and the output divided by l and cast to q's dtype, as the TPU kernel does.
// When l_out and m_out are given (K4a), the final row max m and normaliser
// l of every query are also written, as f32 (H, B, T): what the backward
// kernels recompute the probabilities from.
//
// Two designs. flash_serve_bf16 (K3 and K4a in bf16; its own comment
// below): a block serves a group of up to four batch rows of its (query
// tile, head), so each bias tile is read once for all of them, with a
// cp.async ring, ldmatrix fragments and a base-2 softmax; with l_out and
// m_out it is K4a's bf16 route, the trainer's bf16 step's forward (rather
// than a block per (batch*head, query tile) with synchronous staging, which
// reads the bias once per batch row). flash_fwd_tf32 (K4a and K3
// in f32; its own comment below): the same sharing for a group of one or
// two batch rows, both products as 3xTF32 mma.sync m16n8k8 (each operand
// split into its TF32 rounding hi and the TF32 rounding of the remainder
// lo; lo.hi + hi.lo + hi.hi accumulated in f32), which keeps f32's
// tolerance where one TF32 pass does not. Both run the softmax in base 2:
// log2 e is folded into sm_scale and into the bias as it is read, the
// exponentials are ex2.approx, and the residual m is written back in
// natural units (times ln 2), so that the backward kernels recompute
// p = exp(s - m) / l from it.
// In both the online softmax state and the output accumulator stay in
// registers: no score goes to device memory.
//
// Bound. bf16 (K3 serving): HBM bytes. The least traffic is one read of q,
// k, v and the bias and one write of o: 50.3 MB at (2, 16, 1024, 64) bf16
// with a bf16 bias, 15.0 us on an H100 SXM, against 8.7 us for its 8.6
// GFLOP at the bf16 tensor-core peak and ~9 us for its 33.5 M exponentials
// on the MUFU pipe; the serving kernel runs at ~29 % of it with one
// 256-thread block an SM (PERF.md). bf16 at the trainer's (8, 16, 1024, 64)
// (K4a): operations, its 34.4 GFLOP at the bf16 peak, 0.0347 ms, against
// 0.030 ms for its 101 MB. f32 (K4a): operations. Its two
// products of 2 B H T^2 D as three TF32 passes each at the dense TF32
// peak: 0.208 ms at (8, 16, 1024, 64) (0.513 ms for the f32 CUDA-core
// peak; 0.060 ms for its 202 MB of q, k, v, o, bias, l and m; ~0.03 ms for
// its 134 M exponentials).
//
// C interface (bound with ctypes): aa_flash_attention_relpos,
// aa_flash_fwd_tf32 (the f32 route with a block chosen by the caller) and
// aa_flash_serve_bf16 launch one kernel on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include "flash_common.cuh"

namespace {

using namespace aa_flash;

// ------------------------------------------- bf16 serving (K3, K4a) ---
// One block per (group of NB batch rows, query tile of BQ = 64 MT rows,
// head h): four warps a batch row, warp w serving batch row w / 4 of the
// group and MT m-tiles of 16 query rows from 16 MT (w % 4). Every key tile
// of the (H, S, T) bias is copied from device memory ONCE for the NB batch
// rows that use it; the grid's fastest axis is the batch group, so the
// groups of one (query tile, head) run side by side and share the tile in
// L2 as well. K, V and bias tiles arrive by cp.async into a ring of
// ST stages (2, or 3 with one barrier a key tile): the next key tile is in
// flight while the tensor cores work on this one. The bias stays in its own dtype in shared memory. Q and K
// fragments load by ldmatrix, V's B fragments by ldmatrix.trans (each K
// and V fragment serves the warp's MT m-tiles), a bf16 bias's by
// ldmatrix.trans (each register is the pair of scores it is added to).
// The softmax runs in base 2: log2 e is folded into sm_scale and into the
// bias as it is read, and the exponentials are ex2.approx. At MT = 1 Q's
// fragments are reloaded from shared memory each key tile, which keeps a
// thread at 128 registers, so that an SM holds two 256-thread blocks; at
// MT = 2 (one block an SM) they are loaded into registers once.
// With l_out and m_out (K4a) each query's final row max (in natural units)
// and normaliser are written after the output.
template <int D, typename TB, int MT, int NB, int ST = 2>
struct ServeTiles {
  static constexpr int BQ = 64 * MT;                     // query rows of a block
  static constexpr int LD = D + 8;                       // bf16 row stride of Q, K, V
  static constexpr int LDB = BQ + 16 / sizeof(TB);       // bias row stride, 16 bytes of pad
  static constexpr int kQ = NB * BQ * LD;                // uint16 elements
  static constexpr int kKV = NB * kBK * LD;
  static constexpr size_t kBiasBytes = static_cast<size_t>(kBK) * LDB * sizeof(TB);
  static constexpr size_t kStage = 2 * kKV * sizeof(uint16_t) + kBiasBytes;
  static constexpr size_t kSmem = kQ * sizeof(uint16_t) + ST * kStage;
  static constexpr int kThreads = NB * 4 * 32;           // four warps a batch row
  // blocks an SM should hold (ptxas keeps a thread's registers to 65536 /
  // (this x kThreads)): at one m-tile a warp, 2 x 256 threads at NB = 2,
  // whose shared memory fits twice; at two, one block with the registers
  static constexpr int kMinBlocks = MT == 2 ? 1 : kThreads <= 128 ? 3 : kThreads <= 256 ? 2 : 1;
};

template <int D, typename TB, int MT, int NB, int ST>
__global__ void __launch_bounds__(ServeTiles<D, TB, MT, NB, ST>::kThreads,
                                  ServeTiles<D, TB, MT, NB, ST>::kMinBlocks)
flash_serve_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const TB* __restrict__ bias,
                 uint16_t* __restrict__ o, float* __restrict__ l_out,
                 float* __restrict__ m_out, int batch, int heads, int t_len, float sm_scale) {
  using L = ServeTiles<D, TB, MT, NB, ST>;
  constexpr int BQ = L::BQ, LD = L::LD, LDB = L::LDB, NT = L::kThreads;
  constexpr int KD = D / 16;         // k-steps of Q.K^T
  constexpr int ND = D / 8;          // 8-wide dim tiles of the output
  constexpr int NK = kBK / 8;        // 8-wide key tiles of the scores
  constexpr int CD = D / 8;          // 16-byte chunks of a Q / K / V row
  constexpr int CB = BQ * static_cast<int>(sizeof(TB)) / 16;   // ... of a bias row
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);
  unsigned char* stages = smem + L::kQ * sizeof(uint16_t);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int slot = warp / 4, r0 = (warp % 4) * 16 * MT;   // batch row; first query row
  const int b0 = blockIdx.x * NB, t0 = blockIdx.y * BQ, h = blockIdx.z;
  const int nb = min(NB, batch - b0);                      // batch rows of this group
  const bool active = slot < nb;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;
  auto head = [&](int s) {                                  // (b0 + s, h) offset
    return (static_cast<size_t>(b0 + s) * heads + h) * t_len * D;
  };

  // Q of the group's rows, then each key tile's K, V (per batch row) and
  // bias (once), all by cp.async.
  for (int i = tid; i < nb * BQ * CD; i += NT) {
    const int s = i / (BQ * CD), r = (i / CD) % BQ, c = (i % CD) * 8;
    cp_async16(qs + (s * BQ + r) * LD + c, q + head(s) + static_cast<size_t>(t0 + r) * D + c);
  }
  auto issue = [&](int stage, int s0) {
    uint16_t* ks = reinterpret_cast<uint16_t*>(stages + stage * L::kStage);
    uint16_t* vs = ks + L::kKV;
    TB* bs = reinterpret_cast<TB*>(vs + L::kKV);
    for (int i = tid; i < nb * kBK * CD; i += NT) {
      const int s = i / (kBK * CD), r = (i / CD) % kBK, c = (i % CD) * 8;
      const size_t src = head(s) + static_cast<size_t>(s0 + r) * D + c;
      cp_async16(ks + (s * kBK + r) * LD + c, k + src);
      cp_async16(vs + (s * kBK + r) * LD + c, v + src);
    }
    constexpr int E = 16 / sizeof(TB);
    for (int i = tid; i < kBK * CB; i += NT) {
      const int r = i / CB, c = (i % CB) * E;
      cp_async16(bs + r * LDB + c, bias_h + static_cast<size_t>(s0 + r) * t_len + t0 + c);
    }
    cp_async_commit();
  };
  issue(0, 0);

  float acc[MT][ND][4];
  float mrow[MT][2], lrow[MT][2];    // rows g and g + 8 of each m-tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[mt][d][0] = acc[mt][d][1] = acc[mt][d][2] = acc[mt][d][3] = 0.f;
    mrow[mt][0] = mrow[mt][1] = kNegInf;
    lrow[mt][0] = lrow[mt][1] = 0.f;
  }
  const float scale2 = sm_scale * kLog2e;
  const int n_tiles = t_len / kBK;
  // ldmatrix lane roles: rows lane & 7 of the four 8 x 8 matrices
  const int lr = lane & 7, lhi = (lane >> 4) & 1, lmid = (lane >> 3) & 1;

  // two m-tiles a warp run one block an SM: Q's fragments stay in registers
  constexpr bool kQReg = MT == 2;
  uint32_t qreg[kQReg ? MT : 1][kQReg ? KD : 1][4];

  if (ST == 3 && n_tiles > 1) issue(1, kBK);
  for (int it = 0; it < n_tiles; ++it) {
    if constexpr (ST == 2) {
      if (it + 1 < n_tiles) {
        issue((it + 1) & 1, (it + 1) * kBK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    } else {                         // one barrier a tile: it also frees stage (it + 2) % 3
      if (it + 1 < n_tiles) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      if (it + 2 < n_tiles) issue((it + 2) % 3, (it + 2) * kBK);
    }
    const int stage = ST == 2 ? (it & 1) : it % 3;
    if (active) {
      const uint16_t* ks = reinterpret_cast<const uint16_t*>(stages + stage * L::kStage)
                           + slot * kBK * LD;
      const uint16_t* vs = ks + L::kKV;
      const TB* bs = reinterpret_cast<const TB*>(
          reinterpret_cast<const uint16_t*>(stages + stage * L::kStage) + 2 * L::kKV);
      if constexpr (kQReg) {
        if (it == 0) {               // Q arrived with the first key tile
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int kk = 0; kk < KD; ++kk)
              ldsm_x4(qreg[mt][kk], qs + (slot * BQ + r0 + 16 * mt + lr + 8 * lmid) * LD
                                        + 16 * kk + 8 * lhi);
        }
      }
      float s[MT][NK][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NK; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        // at one m-tile Q stays in shared memory: registers for occupancy
        uint32_t qf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (kQReg) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qf[mt][e] = qreg[mt][kk][e];
          } else {
            ldsm_x4(qf[mt], qs + (slot * BQ + r0 + 16 * mt + lr + 8 * lmid) * LD + 16 * kk
                                + 8 * lhi);
          }
        }
#pragma unroll
        for (int jp = 0; jp < NK / 2; ++jp) {
          uint32_t kb[4];            // one K fragment for every m-tile
          ldsm_x4(kb, ks + (16 * jp + lr + 8 * lhi) * LD + 16 * kk + 8 * lmid);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * jp], qf[mt], kb[0], kb[1]);
            mma_bf16(s[mt][2 * jp + 1], qf[mt], kb[2], kb[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int rq = r0 + 16 * mt;   // this m-tile's first query row in the block
        // scores in base 2, with the bias tile biasT[h, s0 + key, t0 + query]
        if constexpr (sizeof(TB) == 2) {
          const uint16_t* b16 = reinterpret_cast<const uint16_t*>(bs);
#pragma unroll
          for (int jp = 0; jp < NK / 2; ++jp) {
            uint32_t bb[4];
            ldsm_x4_t(bb, b16 + (16 * jp + lr + 8 * lhi) * LDB + rq + 8 * lmid);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float* sj = s[mt][2 * jp + e];
              sj[0] = fmaf(sj[0], scale2, aa::bf16_lo(bb[2 * e]) * kLog2e);
              sj[1] = fmaf(sj[1], scale2, aa::bf16_hi(bb[2 * e]) * kLog2e);
              sj[2] = fmaf(sj[2], scale2, aa::bf16_lo(bb[2 * e + 1]) * kLog2e);
              sj[3] = fmaf(sj[3], scale2, aa::bf16_hi(bb[2 * e + 1]) * kLog2e);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < NK; ++j) {
            const float* b = reinterpret_cast<const float*>(bs) + (8 * j + 2 * tg) * LDB + rq + g;
            s[mt][j][0] = fmaf(s[mt][j][0], scale2, b[0] * kLog2e);
            s[mt][j][1] = fmaf(s[mt][j][1], scale2, b[LDB] * kLog2e);
            s[mt][j][2] = fmaf(s[mt][j][2], scale2, b[8] * kLog2e);
            s[mt][j][3] = fmaf(s[mt][j][3], scale2, b[LDB + 8] * kLog2e);
          }
        }
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[mt][j][0], s[mt][j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[mt][j][2], s[mt][j][3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(mrow[mt][0], mx0), mn1 = fmaxf(mrow[mt][1], mx1);
        const float al0 = exp2_ftz(mrow[mt][0] - mn0), al1 = exp2_ftz(mrow[mt][1] - mn1);
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          s[mt][j][0] = exp2_ftz(s[mt][j][0] - mn0);
          s[mt][j][1] = exp2_ftz(s[mt][j][1] - mn0);
          s[mt][j][2] = exp2_ftz(s[mt][j][2] - mn1);
          s[mt][j][3] = exp2_ftz(s[mt][j][3] - mn1);
          ps0 += s[mt][j][0] + s[mt][j][1];
          ps1 += s[mt][j][2] + s[mt][j][3];
        }
        lrow[mt][0] = lrow[mt][0] * al0 + ps0;   // this thread's share of the row sums
        lrow[mt][1] = lrow[mt][1] * al1 + ps1;
        mrow[mt][0] = mn0;
        mrow[mt][1] = mn1;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          acc[mt][d][0] *= al0; acc[mt][d][1] *= al0;
          acc[mt][d][2] *= al1; acc[mt][d][3] *= al1;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16x2(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16x2(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = pack_bf16x2(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = pack_bf16x2(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t vb[4];            // one V fragment for every m-tile
          ldsm_x4_t(vb, vs + (16 * kk + lr + 8 * lmid) * LD + 16 * dp + 8 * lhi);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dp], pa[mt], vb[0], vb[1]);
            mma_bf16(acc[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
          }
        }
      }
    }
    if constexpr (ST == 2) __syncthreads();   // this stage is free for the copy after next
  }
  if (!active) return;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = lrow[mt][0], l1 = lrow[mt][1];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    uint16_t* o0 = o + head(slot) + static_cast<size_t>(t0 + r0 + 16 * mt + g) * D + 2 * tg;
    uint16_t* o1 = o0 + 8 * D;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<uint32_t*>(o0 + 8 * d) =
          pack_bf16x2(acc[mt][d][0] / l0, acc[mt][d][1] / l0);
      *reinterpret_cast<uint32_t*>(o1 + 8 * d) =
          pack_bf16x2(acc[mt][d][2] / l1, acc[mt][d][3] / l1);
    }
    if (l_out != nullptr && tg == 0) {   // K4a's residuals, (H, B, T), m in natural units
      const size_t r = (static_cast<size_t>(h) * batch + b0 + slot) * t_len
                       + t0 + r0 + 16 * mt + g;
      l_out[r] = l0;
      l_out[r + 8] = l1;
      m_out[r] = mrow[mt][0] * kLn2;
      m_out[r + 8] = mrow[mt][1] * kLn2;
    }
  }
}

// ---------------------------------------------- f32: 3xTF32 (K4a, K3) ---
// One block per (batch group of NB rows, query tile of BQ = 64 MT rows,
// head h): four warps a batch row, warp w serving batch row w / 4 of the
// group and MT m-tiles of 16 query rows from 16 MT (w % 4). Every key tile
// of the (H, S, T) bias is copied from device memory ONCE for the NB batch
// rows that use it; the grid's fastest axis is the batch group, so the
// groups of one (query tile, head) run side by side and share the tile in
// L2 as well. K, V and bias tiles arrive by cp.async into two stages (one
// where two do not fit), the next key tile in flight while the tensor
// cores work on this one.
//
// Both products run as 3xTF32 mma.sync m16n8k8 (flash_common.cuh). TF32's
// k index is permuted within each 8-wide step: for Q.K^T, dims 2 tg and
// 2 tg + 1 for columns tg and tg + 4, so that a lane reads its Q and K
// pairs as float2; for P.V, keys 2 tg and 2 tg + 1, so that the score C
// fragment is P's A fragment as it lies (no trip through shared memory),
// and V's rows are read with the same permutation. Each K and V fragment
// is split once for the warp's MT m-tiles. With one m-tile a warp and
// D <= 64, Q is read from device memory once into registers and split into
// hi and lo once; else (D = 128, or 128 query rows) the registers do not
// hold it (ptxas spills), and Q is copied once into shared memory with the
// first key tile and split at each use.
template <int D, typename TB, int MT, int NB, int BK>
struct Tf32Tiles {
  static constexpr int BQ = 64 * MT;                     // query rows of a block
  static constexpr int LDK = D + 8;                      // float2 row reads: 32 banks
  static constexpr int LDV = D + 4;                      // column reads: 32 banks
  static constexpr int LDB = BQ + 16 / sizeof(TB);       // bias row stride, 16 bytes of pad
  static constexpr int kK = NB * BK * LDK;               // floats
  static constexpr int kV = NB * BK * LDV;
  static constexpr bool kQSplit = MT == 1 && D <= 64;    // Q held as hi, lo
  static constexpr size_t kQ = kQSplit ? 0 : NB * BQ * LDK * sizeof(float);
  static constexpr size_t kStage = (kK + kV) * sizeof(float)
                                   + static_cast<size_t>(BK) * LDB * sizeof(TB);
  static constexpr int kStages = kQ + 2 * kStage <= 232448 ? 2 : 1;
  static constexpr size_t kSmem = kQ + kStages * kStage;
  static constexpr int kThreads = NB * 4 * 32;
  static_assert(kQ + kStage <= 232448, "the forward's tiles do not fit");
};

__device__ __forceinline__ float bias_value(const float* p) { return *p; }
__device__ __forceinline__ float bias_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int D, typename TB, int MT, int NB, int BK>
__global__ void __launch_bounds__(Tf32Tiles<D, TB, MT, NB, BK>::kThreads)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const TB* __restrict__ bias,
               float* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out,
               int batch, int heads, int t_len, float sm_scale) {
  using L = Tf32Tiles<D, TB, MT, NB, BK>;
  constexpr int BQ = L::BQ, LDK = L::LDK, LDV = L::LDV, LDB = L::LDB, NT = L::kThreads;
  constexpr int S = L::kStages;
  constexpr int KD = D / 8;          // k-steps of Q.K^T
  constexpr int ND = D / 8;          // 8-wide dim tiles of the output
  constexpr int NK = BK / 8;         // 8-wide key tiles of the scores
  constexpr int QS = L::kQSplit ? KD : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);              // where Q is not in registers
  unsigned char* stages = smem + L::kQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int slot = warp / 4, r0 = (warp % 4) * 16 * MT;   // batch row; first query row
  const int b0 = blockIdx.x * NB, t0 = blockIdx.y * BQ, h = blockIdx.z;
  const int nb = min(NB, batch - b0);                      // batch rows of this group
  const bool active = slot < nb;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;
  auto head = [&](int s) {                                  // (b0 + s, h) offset
    return (static_cast<size_t>(b0 + s) * heads + h) * t_len * D;
  };

  // key tile n into stage n mod S: K and V of the group's rows, the bias once
  auto fetch = [&](int n) {
    float* ks = reinterpret_cast<float*>(stages + (n % S) * L::kStage);
    float* vs = ks + L::kK;
    TB* bs = reinterpret_cast<TB*>(vs + L::kV);
    const int s0 = n * BK;
    constexpr int CD = D / 4;        // 16-byte chunks of a K / V row
    for (int i = tid; i < nb * BK * CD; i += NT) {
      const int s = i / (BK * CD), r = (i / CD) % BK, c = (i % CD) * 4;
      const size_t src = head(s) + static_cast<size_t>(s0 + r) * D + c;
      cp_async16(ks + (s * BK + r) * LDK + c, k + src);
      cp_async16(vs + (s * BK + r) * LDV + c, v + src);
    }
    constexpr int E = 16 / sizeof(TB), CB = BQ / E;
    for (int i = tid; i < BK * CB; i += NT) {
      const int r = i / CB, c = (i % CB) * E;
      cp_async16(bs + r * LDB + c, bias_h + static_cast<size_t>(s0 + r) * t_len + t0 + c);
    }
    cp_async_commit();
  };
  if constexpr (!L::kQSplit) {      // Q of the group's rows, with the first key tile
    constexpr int CD = D / 4;
    for (int i = tid; i < nb * BQ * CD; i += NT) {
      const int s = i / (BQ * CD), r = (i / CD) % BQ, c = (i % CD) * 4;
      cp_async16(qs + (s * BQ + r) * LDK + c, q + head(s) + static_cast<size_t>(t0 + r) * D + c);
    }
  }
  fetch(0);

  // Q's A fragments: rows g, g + 8 of each m-tile, dims 8 kk + 2 tg (+1)
  auto q_pair = [&](int mt, int kk, int half) -> float2 {
    const size_t row = t0 + r0 + 16 * mt + g + 8 * half;
    if constexpr (L::kQSplit)
      return *reinterpret_cast<const float2*>(q + head(slot) + row * D + 8 * kk + 2 * tg);
    else
      return *reinterpret_cast<const float2*>(qs + (slot * BQ + row - t0) * LDK + 8 * kk
                                              + 2 * tg);
  };
  uint32_t qhi[MT][QS][4], qlo[MT][QS][4];
  if constexpr (L::kQSplit) {
    if (active) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const float2 x0 = q_pair(mt, kk, 0), x1 = q_pair(mt, kk, 1);
          split(x0.x, qhi[mt][kk][0], qlo[mt][kk][0]);
          split(x1.x, qhi[mt][kk][1], qlo[mt][kk][1]);
          split(x0.y, qhi[mt][kk][2], qlo[mt][kk][2]);
          split(x1.y, qhi[mt][kk][3], qlo[mt][kk][3]);
        }
    }
  }

  float acc[MT][ND][4];
  float mrow[MT][2], lrow[MT][2];    // rows g and g + 8 of each m-tile, base 2
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[mt][d][0] = acc[mt][d][1] = acc[mt][d][2] = acc[mt][d][3] = 0.f;
    mrow[mt][0] = mrow[mt][1] = kNegInf;
    lrow[mt][0] = lrow[mt][1] = 0.f;
  }
  const float scale2 = sm_scale * kLog2e;
  const int n_tiles = t_len / BK;

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
      const float* ks = reinterpret_cast<const float*>(stages + (n % S) * L::kStage);
      const TB* bs = reinterpret_cast<const TB*>(ks + L::kK + L::kV);
      const float* vs = ks + L::kK + slot * BK * LDV;
      ks += slot * BK * LDK;

      // s = Q.K^T
      float s[MT][NK][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NK; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (L::kQSplit) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[mt][e] = qhi[mt][kk][e];
              al[mt][e] = qlo[mt][kk][e];
            }
          } else {
            const float2 x0 = q_pair(mt, kk, 0), x1 = q_pair(mt, kk, 1);
            split(x0.x, ah[mt][0], al[mt][0]);
            split(x1.x, ah[mt][1], al[mt][1]);
            split(x0.y, ah[mt][2], al[mt][2]);
            split(x1.y, ah[mt][3], al[mt][3]);
          }
        }
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float2 kb = *reinterpret_cast<const float2*>(ks + (8 * j + g) * LDK + 8 * kk
                                                             + 2 * tg);
          uint32_t bh[2], bl[2];
          split(kb.x, bh[0], bl[0]);
          split(kb.y, bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_3xtf32(s[mt][j], ah[mt], al[mt], bh, bl);
        }
      }
      // the online softmax in base 2, the bias biasT[h, s0 + key, t0 + query]
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const TB* br = bs + 2 * tg * LDB + r0 + 16 * mt + g;
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const TB* b = br + 8 * j * LDB;
          s[mt][j][0] = fmaf(s[mt][j][0], scale2, bias_value(b) * kLog2e);
          s[mt][j][1] = fmaf(s[mt][j][1], scale2, bias_value(b + LDB) * kLog2e);
          s[mt][j][2] = fmaf(s[mt][j][2], scale2, bias_value(b + 8) * kLog2e);
          s[mt][j][3] = fmaf(s[mt][j][3], scale2, bias_value(b + LDB + 8) * kLog2e);
          mx0 = fmaxf(mx0, fmaxf(s[mt][j][0], s[mt][j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[mt][j][2], s[mt][j][3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(mrow[mt][0], mx0), mn1 = fmaxf(mrow[mt][1], mx1);
        const float al0 = exp2_ftz(mrow[mt][0] - mn0), al1 = exp2_ftz(mrow[mt][1] - mn1);
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          s[mt][j][0] = exp2_ftz(s[mt][j][0] - mn0);
          s[mt][j][1] = exp2_ftz(s[mt][j][1] - mn0);
          s[mt][j][2] = exp2_ftz(s[mt][j][2] - mn1);
          s[mt][j][3] = exp2_ftz(s[mt][j][3] - mn1);
          ps0 += s[mt][j][0] + s[mt][j][1];
          ps1 += s[mt][j][2] + s[mt][j][3];
        }
        lrow[mt][0] = lrow[mt][0] * al0 + ps0;   // this thread's share of the row sums
        lrow[mt][1] = lrow[mt][1] * al1 + ps1;
        mrow[mt][0] = mn0;
        mrow[mt][1] = mn1;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          acc[mt][d][0] *= al0; acc[mt][d][1] *= al0;
          acc[mt][d][2] *= al1; acc[mt][d][3] *= al1;
        }
      }
      // acc += P.V: C (g, 2 tg | 2 tg + 1) of key tile j is A (g, tg | tg + 4),
      // and B row tg | tg + 4 is key 2 tg | 2 tg + 1
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split(s[mt][j][0], ph[mt][0], pl[mt][0]);
          split(s[mt][j][2], ph[mt][1], pl[mt][1]);
          split(s[mt][j][1], ph[mt][2], pl[mt][2]);
          split(s[mt][j][3], ph[mt][3], pl[mt][3]);
        }
        const float* vr = vs + (8 * j + 2 * tg) * LDV + g;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          uint32_t bh[2], bl[2];
          split(vr[8 * d], bh[0], bl[0]);
          split(vr[LDV + 8 * d], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt][d], ph[mt], pl[mt], bh, bl);
        }
      }
    }
    __syncthreads();                 // the stage is free for the copy after next
  }
  if (!active) return;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = lrow[mt][0], l1 = lrow[mt][1];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int row = t0 + r0 + 16 * mt + g;
    float* o0 = o + head(slot) + static_cast<size_t>(row) * D + 2 * tg;
    float* o1 = o0 + 8 * D;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<float2*>(o0 + 8 * d) = make_float2(acc[mt][d][0] / l0, acc[mt][d][1] / l0);
      *reinterpret_cast<float2*>(o1 + 8 * d) = make_float2(acc[mt][d][2] / l1, acc[mt][d][3] / l1);
    }
    if (l_out != nullptr && tg == 0) {   // residuals, (H, B, T), m in natural units
      const size_t r = (static_cast<size_t>(h) * batch + b0 + slot) * t_len + row;
      l_out[r] = l0;
      l_out[r + 8] = l1;
      m_out[r] = mrow[mt][0] * kLn2;
      m_out[r + 8] = mrow[mt][1] * kLn2;
    }
  }
}

// Two m-tiles a warp run one block an SM, so they take a third stage
// where it fits the block's shared memory (one barrier a key tile); one
// m-tile keeps two stages and two blocks an SM.
template <int D, typename TB, int MT, int NB,
          int ST = MT == 2 && ServeTiles<D, TB, MT, NB, 3>::kSmem <= 227 * 1024 ? 3 : 2>
int launch_serve(const void* q, const void* k, const void* v, const void* bias, void* o,
                 float* l_out, float* m_out, int b, int heads, int t_len, float sm_scale,
                 cudaStream_t st) {
  using L = ServeTiles<D, TB, MT, NB, ST>;
  auto kernel = flash_serve_bf16<D, TB, MT, NB, ST>;
  static bool configured = false;    // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  kernel<<<dim3((b + NB - 1) / NB, t_len / L::BQ, heads), L::kThreads, L::kSmem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const TB*>(bias),
      static_cast<uint16_t*>(o), l_out, m_out, b, heads, t_len, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// The SMs of the current device, read once.
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The query tile when the caller leaves it to the kernel (bq = 0): 128
// rows (two m-tiles a warp, one 256-thread block of up to two batch rows an
// SM) where D <= 64, unless that grid's last wave would leave more than a
// quarter of the SMs idle; else 64 (two blocks an SM). Measured on an H100
// (PERF.md): at B <= 2, 128 rows 10 % faster at T = 1024 and 3072, 12 %
// slower at 1536; at B = 8 and 16, two batch rows of 128 queries 20 % faster
// than four of 64.
template <int D>
int pick_query_tile(int b, int heads, int t_len) {
  if (D > 64 || t_len % 128 != 0) return 64;
  const int sms = sm_count();
  const int tail = (b + 1) / 2 * (t_len / 128) * heads % sms;
  return tail == 0 || 4 * tail >= 3 * sms ? 128 : 64;
}

// The batch rows a block serves: all of them up to 4 (2 at D = 128, where
// four rows' tiles do not fit a block's shared memory and registers, and
// at 128 query rows).
template <int D, typename TB>
int dispatch_serve(const void* q, const void* k, const void* v, const void* bias, void* o,
                   float* l_out, float* m_out, int b, int heads, int t_len, float sm_scale,
                   int bq, cudaStream_t st) {
  if (bq == 0) bq = pick_query_tile<D>(b, heads, t_len);
  const int nb = b == 1 ? 1 : (b == 2 || D == 128 || bq == 128) ? 2 : 4;
#define AA_SERVE(MT, NB)                                                               \
  if (bq == 64 * MT && nb == NB)                                                       \
    return launch_serve<D, TB, MT, NB>(q, k, v, bias, o, l_out, m_out, b, heads, t_len, \
                                       sm_scale, st);
  AA_SERVE(1, 1)
  AA_SERVE(1, 2)
  if constexpr (D <= 64) {
    AA_SERVE(1, 4)
    AA_SERVE(2, 1)
    AA_SERVE(2, 2)
  }
#undef AA_SERVE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 route's arguments.
struct Tf32Args {
  const void *q, *k, *v, *bias;
  void* o;
  float *l_out, *m_out;
  int b, heads, t_len;
  float sm_scale;
  cudaStream_t st;
};

template <int D, typename TB, int MT, int NB, int BK>
int launch_tf32(const Tf32Args& a) {
  using L = Tf32Tiles<D, TB, MT, NB, BK>;
  auto kernel = flash_fwd_tf32<D, TB, MT, NB, BK>;
  static bool configured = false;    // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  kernel<<<dim3((a.b + NB - 1) / NB, a.t_len / L::BQ, a.heads), L::kThreads, L::kSmem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<float*>(a.o), a.l_out, a.m_out, a.b, a.heads, a.t_len, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// The f32 route's block: nb batch rows (1 or 2), a query tile of bq rows
// (64, or 128 at D <= 64 with T a multiple of 128) and key tiles of bk
// rows (64 or 32); all three 0 let the kernel choose: two batch rows of
// 128 queries (two m-tiles a warp, each K / V fragment split once for
// both) and 32-key tiles, whose two stages fit beside Q, where B > 1 and
// D <= 64; else 64 queries and 64 keys, one batch row at B = 1. Measured
// on an H100 at (8, 16, 1024, 64) (PERF.md): 0.734 ms against 0.741
// with 64-key tiles in one stage, 0.834-0.843 with 64 queries, 1.08 with
// 64 queries and 32 keys.
template <int D, typename TB>
int dispatch_tf32(const Tf32Args& a, int nb, int bq, int bk) {
  if (nb == 0 && bq == 0 && bk == 0) {
    const bool wide = D <= 64 && a.b > 1 && a.t_len % 128 == 0;
    nb = a.b == 1 ? 1 : 2;
    bq = wide ? 128 : 64;
    bk = wide ? 32 : 64;
  }
#define AA_TF32(MT, NB, BK) \
  if (bq == 64 * MT && nb == NB && bk == BK) return launch_tf32<D, TB, MT, NB, BK>(a);
  AA_TF32(1, 1, 64)
  AA_TF32(1, 2, 64)
  AA_TF32(1, 2, 32)
  if constexpr (D <= 64) {
    if (a.t_len % 128 == 0) {
      AA_TF32(2, 1, 64)
      AA_TF32(2, 2, 64)
      AA_TF32(2, 2, 32)
    }
  }
#undef AA_TF32
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TB>
int dispatch(int dtype, int d, const Tf32Args& a, int nb, int bq, int bk) {
#define AA_FLASH_D(DV)                                                                  \
  case DV:                                                                              \
    return dtype == 1 ? dispatch_serve<DV, TB>(a.q, a.k, a.v, a.bias, a.o, a.l_out,     \
                                               a.m_out, a.b, a.heads, a.t_len,          \
                                               a.sm_scale, 0, a.st)                  \
                      : dispatch_tf32<DV, TB>(a, nb, bq, bk);
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

int forward(int dtype, int bias_dtype, const Tf32Args& a, int d, int nb, int bq, int bk) {
  if ((dtype != 0 && dtype != 1) || a.t_len % kBQ != 0 || a.b < 1 ||
      (a.l_out == nullptr) != (a.m_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bias_dtype == 0) return dispatch<float>(dtype, d, a, nb, bq, bk);
  if (bias_dtype == 1) return dispatch<__nv_bfloat16>(dtype, d, a, nb, bq, bk);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype (of q, k, v and o) and bias_dtype: 0 = float32, 1 = bfloat16.
// q, k, v, o: contiguous (B, H, T, D), 16-byte aligned; bias: contiguous
// (H, T, T) transposed bias. T must be a multiple of 64 and D one of 16,
// 32, 64, 128. l_out and m_out: both null (K3), or contiguous f32 (H, B, T)
// for the residuals (K4a). Returns cudaGetLastError().
extern "C" int aa_flash_attention_relpos(int dtype, int bias_dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* bias, void* o, void* l_out,
                                         void* m_out, int b, int heads, int t_len,
                                         int d, float sm_scale, void* stream) {
  const Tf32Args a{q, k, v, bias, o, static_cast<float*>(l_out), static_cast<float*>(m_out),
                   b, heads, t_len, sm_scale, static_cast<cudaStream_t>(stream)};
  return forward(dtype, bias_dtype, a, d, 0, 0, 0);
}

// The f32 route with its block chosen by the caller (for timing the
// variants): nb batch rows, 1 or 2; bq query rows, 64 or 128 (D <= 64, T a
// multiple of 128); bk keys a tile, 64 or 32; all three 0 for the kernel's
// own choice. Arguments otherwise as aa_flash_attention_relpos's with f32
// q, k, v, o.
extern "C" int aa_flash_fwd_tf32(int bias_dtype, const void* q, const void* k, const void* v,
                                 const void* bias, void* o, void* l_out, void* m_out, int b,
                                 int heads, int t_len, int d, float sm_scale, int nb, int bq,
                                 int bk, void* stream) {
  const Tf32Args a{q, k, v, bias, o, static_cast<float*>(l_out), static_cast<float*>(m_out),
                   b, heads, t_len, sm_scale, static_cast<cudaStream_t>(stream)};
  return forward(0, bias_dtype, a, d, nb, bq, bk);
}

// The bf16 route (K3, and K4a with l_out and m_out): q, k, v, o contiguous
// bf16 (B, H, T, D), 16-byte aligned; bias (H, T, T) transposed,
// bias_dtype 0 = float32, 1 = bfloat16; l_out, m_out both null, or
// contiguous f32 (H, B, T) for the residuals. T a multiple of 64 (of bq),
// D one of 16, 32, 64, 128; bq the query tile: 0 lets the kernel choose
// (pick_query_tile), else 64, or 128 at D <= 64. Returns
// cudaGetLastError().
extern "C" int aa_flash_serve_bf16(int bias_dtype, const void* q, const void* k,
                                   const void* v, const void* bias, void* o, void* l_out,
                                   void* m_out, int b, int heads, int t_len, int d,
                                   float sm_scale, int bq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(l_out);
  float* m = static_cast<float*>(m_out);
  if ((bias_dtype != 0 && bias_dtype != 1) || (bq != 0 && bq != 64 && bq != 128) ||
      (l == nullptr) != (m == nullptr) ||
      t_len % (bq ? bq : 64) != 0 ||
      b < 1 || heads < 1 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define AA_SERVE_D(DV)                                                                  \
  case DV:                                                                              \
    return bias_dtype == 1                                                              \
               ? dispatch_serve<DV, __nv_bfloat16>(q, k, v, bias, o, l, m, b, heads,    \
                                                   t_len, sm_scale, bq, st)         \
               : dispatch_serve<DV, float>(q, k, v, bias, o, l, m, b, heads, t_len,     \
                                           sm_scale, bq, st);
  switch (d) {
    AA_SERVE_D(16)
    AA_SERVE_D(32)
    AA_SERVE_D(64)
    AA_SERVE_D(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AA_SERVE_D
}
