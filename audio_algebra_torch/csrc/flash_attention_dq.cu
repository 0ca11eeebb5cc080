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
// Two designs, one a dtype; both walk the batch of one (head, 64-query
// tile) in a block, the only block that touches dbT[h, :, t0 : t0 + 64].
// Inside a chunk of C batch rows the key tiles are the outer loop, so each
// (key tile, query tile) of dbT is summed over the chunk's rows in
// registers, in a fixed order, and written once: the strip makes ceil(B /
// C) trips to device memory (the first chunk writes, later ones read, add
// and write), with no atomics, no fill, any B, and the same bits every
// run.
//
// bf16 (flash_dq_bf16): eight warps in two slots of four; a step is one
// key tile against one batch row in each slot. Warp w serves query rows
// 16 (w mod 4) .. + 15 against all 64 keys of the tile, for the batch rows
// of slot w / 4, so every dq partial is its warp's own: dq of the warp's
// RPW = 128 / D rows of the chunk (C = 2 RPW: 4 at D = 64) stays in
// registers across the key tiles, with no shared-memory accumulator, no
// cross-warp add and no ordering barrier. Each warp sums its rows' ds in
// its d(biasT) fragments; at the end of a key tile the two slots' sums
// meet in shared memory in dbT's (key, query) layout and every thread
// writes four float4 of slot 0's plus slot 1's (+ the earlier chunks'). The
// chunk's q and dO tiles and its rows' m, l and delta stay in shared
// memory for all its key tiles; k and v of the step's two rows and the
// (key, query) bias tile, in its own dtype, load into one of two stages
// while the other is in use, with one barrier a step and one a key tile.
// The probabilities are recomputed in base 2 (log2 e folded into sm_scale,
// the bias and m; ex2.approx), and ds is rounded to bf16 in registers as
// the A operand of dq += ds.k. The products:
//   D = 64, the trainer's: wgmma. A slot is a warpgroup of 64 queries:
//     s = q.k^T and dp = do.v^T as m64n64k16 with both operands in shared
//     memory (K-major), dq += ds.k with ds from registers and k MN-major
//     (the same tile, read down its rows). q, dO, k and v arrive by TMA in
//     the 128-byte swizzle that the descriptors name, one thread issuing
//     each step's loads, completion on mbarriers.
//   D = 16, 32, 128: mma.sync m16n8k16, every fragment by ldmatrix (k
//     transposed for dq), the tiles by cp.async (one stage at D = 128,
//     where two do not fit).
//
// f32 (flash_dq): eight warps; warp w owns query rows 16 (w mod 4) .. + 15
// and keys 32 (w / 4) .. + 31 of the tile. s, dp and the dq partial run as
// 3xTF32 m16n8k8 (each operand split into a TF32 hi part and the TF32
// rounding of its remainder, lo; hi.lo + lo.hi + hi.hi with f32
// accumulation), which keeps f32's tolerance where plain TF32 does not.
// The ds fragments feed the dq product straight from registers: the
// product's k index is permuted (key 2 tg for column tg, key 2 tg + 1 for
// tg + 4) and the K fragment is read with the same permutation. dq of the
// chunk's C rows accumulates in f32 in shared memory (C x 64 x D,
// XOR-swizzled so the fragment stores hit distinct banks; C the largest
// count up to 8 that fits beside the tiles: 4 at D = 64), the two warps of
// a query slice adding their partials in a fixed order (key half 0, a
// barrier, key half 1). The four tiles of a step (q, do of the batch row;
// k, v of the key tile) arrive by cp.async into one of two stages while
// the other is in use (one stage at D = 128, where two do not fit); the
// bias tile is read once per key tile, for every row of the chunk.
//
// Bound: operations. f32: 9 TF32 products of 2 B H T^2 D at the dense TF32
// peak (3 products, 3 passes each); bf16: 3 products at the bf16 peak
// (0.052 ms at (8, 16, 1024, 64) on an H100 SXM at 700 W). The bf16 route
// is held by its phases, not by bytes or by one unit: a step's products
// (the two slots' 24 wgmma share the tensor cores), its softmax arithmetic
// and its barriers run one after the other in every warp. The grid is H x
// T / 64 blocks of one per SM (shared memory in bf16 at D = 64: 188,480
// bytes with a bf16 bias, 204,864 with an f32 one): 256 at T = 1024, H =
// 16, two waves of 132 SMs less 8 slots.
//
// C interface (bound with ctypes): aa_flash_attention_dq launches one
// kernel on the given stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError().

#include <cuda.h>

#include "flash_common.cuh"

namespace {

using namespace aa_flash;

constexpr int kThreadsDq = 256;
constexpr int kMaxSmem = 232448;
constexpr int kBiasBytes = kBK * kBiasLD * 4;

// Shared memory plan of the f32 route at head dim D: two
// stages of the four tiles if at least two batch rows of dq accumulators
// fit beside them, else one; then the chunk C (up to 8).
constexpr int smem_left(int stages, int tile) {
  return kMaxSmem - stages * 4 * tile - kBiasBytes;
}

template <int D>
struct Plan {
  static constexpr int LD = D + 8;               // tile row stride: fragment reads hit 32 banks
  static constexpr int kTile = kBQ * LD * 4;
  static constexpr int kRow = kBQ * D * 4;       // one batch row's dq accumulator
  static constexpr int kStages = smem_left(2, kTile) >= 2 * kRow ? 2 : 1;
  static constexpr int kLeft = smem_left(kStages, kTile);
  static constexpr int kChunk = kLeft / kRow < 8 ? kLeft / kRow : 8;
  static constexpr int kSmem = kStages * 4 * kTile + kBiasBytes + kChunk * kRow;
  static_assert(kChunk >= 1 && kSmem <= kMaxSmem, "K4c's tiles do not fit");
};

// s[j] = rows r0 .. r0 + 15 of `as` dotted with rows kb + 8 j .. + 7 of
// `bs` (j < 4: 32 keys), over D, in 3xTF32. TF32's k index is permuted
// within each 8-wide step (dims 2 tg, 2 tg + 1 for tg, tg + 4), the same in
// A and B.
template <int D>
__device__ __forceinline__ void rows_dot(float (&s)[4][4], const float* as, const float* bs,
                                         int r0, int kb, int g, int tg) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(as + (r0 + g) * LD + 8 * kk + 2 * tg);
    const float2 x1 =
        *reinterpret_cast<const float2*>(as + (r0 + g + 8) * LD + 8 * kk + 2 * tg);
    uint32_t ah[4], al[4];
    split(x0.x, ah[0], al[0]);
    split(x1.x, ah[1], al[1]);
    split(x0.y, ah[2], al[2]);
    split(x1.y, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 y =
          *reinterpret_cast<const float2*>(bs + (kb + 8 * j + g) * LD + 8 * kk + 2 * tg);
      mma_3xtf32(s[j], ah, al, y.x, y.y);
    }
  }
}

// dq[d] += ds (16 rows x keys kb .. kb + 31) . k[keys, 8 d .. 8 d + 7].
template <int D>
__device__ __forceinline__ void ds_times_k(float (&dq)[D / 8][4], const float (&ds)[4][4],
                                           const float* ks, int kb, int g, int tg) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t ah[4], al[4];                       // C (g, 2 tg | 2 tg + 1) -> A (g, tg | tg + 4)
    split(ds[j][0], ah[0], al[0]);
    split(ds[j][2], ah[1], al[1]);
    split(ds[j][1], ah[2], al[2]);
    split(ds[j][3], ah[3], al[3]);
    const float* kr = ks + (kb + 8 * j + 2 * tg) * LD + g;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) mma_3xtf32(dq[d], ah, al, kr[8 * d], kr[LD + 8 * d]);
  }
}

// Column of (row, col) in a (64, D) f32 dq accumulator: 8-column groups
// XOR-swizzled by the row, so a warp's fragment rows land on distinct banks.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int kMask = D / 8 < 8 ? D / 8 - 1 : 7;
  return row * D + (col ^ ((row & kMask) << 3));
}

// acc[16 rows from r0] (+)= the fragments dqp.
template <int D>
__device__ __forceinline__ void add_dq(float* acc, const float (&dqp)[D / 8][4], bool first,
                                       int r0, int g, int tg) {
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2* p = reinterpret_cast<float2*>(acc + swz<D>(r0 + g + 8 * half, 8 * d + 2 * tg));
      float2 v = make_float2(dqp[d][2 * half], dqp[d][2 * half + 1]);
      if (!first) {
        const float2 o = *p;
        v.x += o.x;
        v.y += o.y;
      }
      *p = v;
    }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The f32 route; TB: the bias's type.
template <int D, typename TB>
__global__ void __launch_bounds__(kThreadsDq)
flash_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         const TB* __restrict__ bias, const float* __restrict__ dout,
         const float* __restrict__ l, const float* __restrict__ m,
         const float* __restrict__ delta, float* __restrict__ dq, float* __restrict__ db,
         int batch, int heads, int t_len, float sm_scale) {
  using P = Plan<D>;
  constexpr int LD = P::LD, S = P::kStages, C = P::kChunk, kTileElems = kBQ * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);           // [S][q, do, k, v][64 x LD]
  float* bs = reinterpret_cast<float*>(smem + S * 4 * P::kTile);
  float* dqs = bs + kBK * kBiasLD;                         // [C][64 x D], swizzled

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = (warp & 3) * 16, wk = warp >> 2, kb = 32 * wk;
  const int h = blockIdx.y, t0 = blockIdx.x * kBQ;
  const int n_tiles = t_len / kBK;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;
  float* db_h = db + static_cast<size_t>(h) * t_len * t_len;

  for (int b0 = 0; b0 < batch; b0 += C) {
    const int cc = min(C, batch - b0);
    const int n_steps = n_tiles * cc;
    // step n: key tile n / cc, batch row b0 + n mod cc, into stage n mod S
    auto fetch = [&](int n) {
      const size_t head = (static_cast<size_t>(b0 + n % cc) * heads + h) * t_len * D;
      const size_t s0 = static_cast<size_t>(n / cc) * kBK;
      float* dst = tiles + (n % S) * 4 * kTileElems;
      async_tile<float, D>(q + head + static_cast<size_t>(t0) * D, dst, LD, tid, kThreadsDq);
      async_tile<float, D>(dout + head + static_cast<size_t>(t0) * D, dst + kTileElems, LD, tid,
                       kThreadsDq);
      async_tile<float, D>(k + head + s0 * D, dst + 2 * kTileElems, LD, tid, kThreadsDq);
      async_tile<float, D>(v + head + s0 * D, dst + 3 * kTileElems, LD, tid, kThreadsDq);
      cp_async_commit();
    };
    if constexpr (S == 2) fetch(0);
    float dbt[4][4];
    for (int n = 0; n < n_steps; ++n) {
      const int bb = n % cc, i = n / cc, s0 = i * kBK, b = b0 + bb;
      // the last step's barrier freed the bias tile and the stage refilled here
      if (bb == 0) load_bias_tile<TB>(bias_h, t_len, s0, t0, bs, tid, kThreadsDq);
      if constexpr (S == 1) {
        fetch(n);
        cp_async_wait<0>();
      } else if (n + 1 < n_steps) {
        fetch(n + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* qs = tiles + (n % S) * 4 * kTileElems;
      const float* dos = qs + kTileElems;
      const float* ks = qs + 2 * kTileElems;
      const float* vs = qs + 3 * kTileElems;
      const size_t r = (static_cast<size_t>(h) * batch + b) * t_len + t0 + r0 + g;
      const float m0 = m[r], m1 = m[r + 8];
      const float il0 = 1.0f / l[r], il1 = 1.0f / l[r + 8];
      const float de0 = delta[r], de1 = delta[r + 8];

      float s[4][4], dp[4][4];
      rows_dot<D>(s, qs, ks, r0, kb, g, tg);
      rows_dot<D>(dp, dos, vs, r0, kb, g, tg);
      // ds into dp; its batch sum into dbt
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* bp = bs + (kb + 8 * j + 2 * tg) * kBiasLD + r0 + g;
        const float p0 = expf(s[j][0] * sm_scale + bp[0] - m0) * il0;
        const float p1 = expf(s[j][1] * sm_scale + bp[kBiasLD] - m0) * il0;
        const float p2 = expf(s[j][2] * sm_scale + bp[8] - m1) * il1;
        const float p3 = expf(s[j][3] * sm_scale + bp[kBiasLD + 8] - m1) * il1;
        dp[j][0] = p0 * (dp[j][0] - de0);
        dp[j][1] = p1 * (dp[j][1] - de0);
        dp[j][2] = p2 * (dp[j][2] - de1);
        dp[j][3] = p3 * (dp[j][3] - de1);
#pragma unroll
        for (int e = 0; e < 4; ++e) dbt[j][e] = bb == 0 ? dp[j][e] : dbt[j][e] + dp[j][e];
      }
      float dqp[D / 8][4];
#pragma unroll
      for (int d = 0; d < D / 8; ++d) dqp[d][0] = dqp[d][1] = dqp[d][2] = dqp[d][3] = 0.f;
      ds_times_k<D>(dqp, dp, ks, kb, g, tg);
      float* acc = dqs + bb * (kBQ * D);
      if (wk == 0) add_dq<D>(acc, dqp, i == 0, r0, g, tg);
      __syncthreads();                 // key half 0 before key half 1: a fixed order
      if (wk == 1) add_dq<D>(acc, dqp, false, r0, g, tg);
      if (bb == cc - 1) {
        // the chunk's sum of this (key, query) tile: the first chunk writes
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* p = db_h + static_cast<size_t>(s0 + kb + 8 * j + 2 * tg) * t_len + t0 + r0 + g;
          float* pp[4] = {p, p + t_len, p + 8, p + t_len + 8};
#pragma unroll
          for (int e = 0; e < 4; ++e) *pp[e] = b0 == 0 ? dbt[j][e] : *pp[e] + dbt[j][e];
        }
      }
      __syncthreads();                 // the stage, the bias tile and acc are free
    }
    // the chunk's dq, scaled and cast
    for (int idx = tid; idx < cc * kBQ * (D / 4); idx += kThreadsDq) {
      const int bb = idx / (kBQ * (D / 4)), rem = idx % (kBQ * (D / 4));
      const int row = rem / (D / 4), col = (rem % (D / 4)) * 4;
      float4 a = *reinterpret_cast<const float4*>(dqs + bb * (kBQ * D) + swz<D>(row, col));
      a.x *= sm_scale;
      a.y *= sm_scale;
      a.z *= sm_scale;
      a.w *= sm_scale;
      const size_t head = (static_cast<size_t>(b0 + bb) * heads + h) * t_len * D;
      store4(dq + head + static_cast<size_t>(t0 + row) * D + col, a);
    }
    __syncthreads();                   // acc is free for the next chunk
  }
}

// ------------------------------------------------- wgmma (bf16, D = 64) ---
// A (64, 64) bf16 tile in shared memory, 1024-byte aligned, rows of 128
// bytes with the 128-byte swizzle (as a TMA load with that swizzle writes
// it): the 16-byte chunk c of row r sits at chunk c ^ (r mod 8). Read as
// K-major (rows the M or N index, the k index along the row) or as
// MN-major (rows the k index), its descriptor is the same: 8-row groups
// 1024 bytes apart (SBO), the swizzle mode 128 B.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The tensor maps of the wgmma route's (64, 64) tiles of q, dO, k and v,
// each viewed as a (B H T, 64) bf16 matrix, boxes of 64 rows, 128-byte
// swizzle: a TMA load writes a tile in the layout sw128 describes.
struct TileMaps {
  CUtensorMap q, d, k, v;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}

// One arrival that also expects `bytes` of TMA data before the phase ends.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The (64, 64) tile at row `row` of `map` into dst; completes on bar.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// After wg_wait: the accumulators are read no earlier than here.
__device__ __forceinline__ void wg_hold(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (+)= A.B^T, m64n64k16: A (64 rows x 16) and B (64 rows x 16) K-major
// in shared memory; acc = 0 overwrites d. Warp w of the warpgroup holds
// rows 16 w + g (+ 8), columns 8 j + 2 tg (+ 1) in d[j], as mma.sync's C.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A.B, m64n64k16: A (64 x 16) from registers in mma.sync's A layout
// (warp w: rows 16 w ..), B (16 k-rows x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- bf16 ---
// Shared memory plan of the bf16 route at head dim D and bias type TB,
// with RPW = 128 / D batch rows a warp (dq in 64 registers a thread) and
// the products on wgmma at D = 64 (WG), on mma.sync otherwise: the chunk's
// q and dO tiles; two stages of k and v for the R =
// 2 rows of a step (one at D = 128, where two do not fit); the chunk's
// rows' m, l and delta; two bias tiles; the slots' d(biasT) sums of a key
// tile; wgmma's TMA barriers. wgmma's tiles are swizzled and 1024-byte
// aligned (kAlign bytes of slack to align the base).
template <int D, typename TB>
struct PlanDqBf16 {
  static constexpr int RPW = 128 / D;
  static constexpr bool WG = D == 64;
  static constexpr int R = 2;                               // slots: batch rows a step
  static constexpr int C = R * RPW;                         // batch rows of a chunk
  static constexpr int LD = WG ? D : D + 8;                 // tile row stride (ldmatrix: 16
                                                            // bytes of pad)
  static constexpr int kAlign = WG ? 1024 : 0;
  static constexpr int LDB = sizeof(TB) == 4 ? kBiasLD : kBQ + 8;   // bias row stride:
                                                            // the transposed reads hit 32 banks
  static constexpr int kTile = kBQ * LD * 2;                // bytes of a (64, D) tile
  static constexpr int kQD = C * 2 * kTile;
  static constexpr int kStats = C * 3 * kBQ * 4;
  static constexpr int kBias = kBK * LDB * static_cast<int>(sizeof(TB));
  static constexpr int kX = R * kBK * kBiasLD * 4;          // [slot][key][query] d(biasT) sums
  static constexpr int kStage = R * 2 * kTile;              // k, v of the step's rows
  static constexpr int kStages =
      kAlign + kQD + kStats + 2 * kStage + 2 * kBias + kX <= kMaxSmem ? 2 : 1;
  static constexpr int kKV = kStages * kStage;
  static constexpr int kBars = WG ? 64 : 0;                 // wgmma route: the TMA mbarriers
  static constexpr int kSmem = kAlign + kQD + kKV + kStats + 2 * kBias + kX + kBars;
  static_assert(kSmem <= kMaxSmem, "K4c bf16's tiles do not fit");
  static_assert(!WG || kStages == 2, "K4c's wgmma route runs two stages");
};

__device__ __forceinline__ float bias_at(const float* p) { return *p; }
__device__ __forceinline__ float bias_at(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <int D, typename TB>
__global__ void __launch_bounds__(kThreadsDq, 1)
flash_dq_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const TB* __restrict__ bias,
              const uint16_t* __restrict__ dout, const float* __restrict__ l,
              const float* __restrict__ m, const float* __restrict__ delta,
              uint16_t* __restrict__ dq, float* __restrict__ db, int batch, int heads,
              int t_len, float sm_scale, const __grid_constant__ TileMaps maps) {
  using P = PlanDqBf16<D, TB>;
  constexpr int RPW = P::RPW;
  constexpr bool WG = P::WG;
  constexpr int R = P::R, C = P::C, LD = P::LD, LDB = P::LDB, S = P::kStages;
  constexpr int KD = D / 16;           // k-steps of s and dp
  constexpr int ND = D / 8;            // 8-wide dim tiles of dq
  constexpr int CD = D / 8;            // 16-byte chunks of a row
  constexpr int kT = kBQ * LD;         // elements of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (WG)
    smem += (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  uint16_t* qd = reinterpret_cast<uint16_t*>(smem);                       // [C][q, dO][64 x LD]
  uint16_t* kv = reinterpret_cast<uint16_t*>(smem + P::kQD);              // [S][R][k, v][64 x LD]
  float* stats = reinterpret_cast<float*>(smem + P::kQD + P::kKV);        // [C][m, l, delta][64]
  TB* biasb = reinterpret_cast<TB*>(smem + P::kQD + P::kKV + P::kStats);  // [2][64 x LDB]
  float* xs = reinterpret_cast<float*>(smem + P::kQD + P::kKV + P::kStats + 2 * P::kBias);
  // wgmma route: the stages' and the chunk's q, dO TMA barriers
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::kQD + P::kKV + P::kStats + 2 * P::kBias +
                                               P::kX);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lr = lane & 7, lmid = (lane >> 3) & 1, lhi = lane >> 4;    // ldmatrix roles
  const int slot = warp >> 2, ws = warp & 3, r0 = 16 * ws;
  const int h = blockIdx.y, t0 = blockIdx.x * kBQ;
  const int n_kt = t_len / kBK;
  const TB* bias_h = bias + static_cast<size_t>(h) * t_len * t_len;
  float* db_h = db + static_cast<size_t>(h) * t_len * t_len;
  const float scale2 = sm_scale * kLog2e;
  auto head = [&](int b) { return (static_cast<size_t>(b) * heads + h) * t_len * D; };
  auto tile_row = [&](int b, int r) { return (b * heads + h) * t_len + r; };   // of a TileMap
  if constexpr (WG) {
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) mbar_init(bars + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  int ns = 0;                          // steps so far: step ns runs in stage ns mod S

  for (int b0 = 0; b0 < batch; b0 += C) {
    const int cc = min(C, batch - b0);
    // step (kt, j): rows b0 + R j + s of the chunk (slot s) against key tile
    // kt, into `stage`; the bias tile of kt comes with j = 0
    auto fetch = [&](int kt, int j, int stage) {
      uint16_t* dst = kv + stage * R * 2 * kT;
      const int s0 = kt * kBK;
      if constexpr (WG) {
        if (tid == 0) {
          const int rows = max(0, min(R, cc - R * j));
          mbar_expect(bars + stage, rows * 2 * P::kTile);
          for (int s = 0; s < rows; ++s) {
            const int row = tile_row(b0 + R * j + s, s0);
            tma_tile(dst + 2 * s * kT, &maps.k, row, bars + stage);
            tma_tile(dst + (2 * s + 1) * kT, &maps.v, row, bars + stage);
          }
        }
      } else {
        for (int i = tid; i < R * 2 * kBK * CD; i += kThreadsDq) {
          const int s = i / (2 * kBK * CD), which = (i / (kBK * CD)) & 1;
          const int r = (i / CD) % kBK, c = (i % CD) * 8;
          if (R * j + s < cc)
            cp_async16(dst + (2 * s + which) * kT + r * LD + c,
                       (which ? v : k) + head(b0 + R * j + s) +
                           static_cast<size_t>(s0 + r) * D + c);
        }
      }
      if (j == 0) {
        TB* bs = biasb + (kt & 1) * kBK * LDB;
        constexpr int E = 16 / sizeof(TB), CB = kBQ / E;
        for (int i = tid; i < kBK * CB; i += kThreadsDq) {
          const int r = i / CB, c = (i % CB) * E;
          cp_async16(bs + r * LDB + c, bias_h + static_cast<size_t>(s0 + r) * t_len + t0 + c);
        }
      }
      cp_async_commit();
    };

    __syncthreads();                   // the last chunk's tiles and exchange are free
    if constexpr (WG) {
      if (tid == 0) {
        mbar_expect(bars + 2, cc * 2 * P::kTile);
        for (int bb = 0; bb < cc; ++bb) {
          tma_tile(qd + 2 * bb * kT, &maps.q, tile_row(b0 + bb, t0), bars + 2);
          tma_tile(qd + (2 * bb + 1) * kT, &maps.d, tile_row(b0 + bb, t0), bars + 2);
        }
      }
    } else {
      for (int i = tid; i < cc * 2 * kBQ * CD; i += kThreadsDq) {
        const int bb = i / (2 * kBQ * CD), which = (i / (kBQ * CD)) & 1;
        const int r = (i / CD) % kBQ, c = (i % CD) * 8;
        cp_async16(qd + (2 * bb + which) * kT + r * LD + c,
                   (which ? dout : q) + head(b0 + bb) + static_cast<size_t>(t0 + r) * D + c);
      }
    }
    for (int i = tid; i < cc * 3 * (kBQ / 4); i += kThreadsDq) {
      const int bb = i / (3 * kBQ / 4), which = (i / (kBQ / 4)) % 3, c = (i % (kBQ / 4)) * 4;
      const float* src = which == 0 ? m : which == 1 ? l : delta;
      cp_async16(stats + (bb * 3 + which) * kBQ + c,
                 src + (static_cast<size_t>(h) * batch + b0 + bb) * t_len + t0 + c);
    }
    fetch(0, 0, ns % S);

    float dqa[RPW][ND][4];
#pragma unroll
    for (int j = 0; j < RPW; ++j)
#pragma unroll
      for (int d = 0; d < ND; ++d) dqa[j][d][0] = dqa[j][d][1] = dqa[j][d][2] = dqa[j][d][3] = 0.f;

    for (int kt = 0; kt < n_kt; ++kt) {
      const TB* bs = biasb + (kt & 1) * kBK * LDB;
      // the d(biasT) fragments of this warp's rows: key 8 jn + 2 tg (+ 1),
      // query r0 + g (+ 8)
      float dbt[8][4];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) dbt[jn][0] = dbt[jn][1] = dbt[jn][2] = dbt[jn][3] = 0.f;
      // this thread's four float4 of the (key, query) tile of d(biasT): key
      // (tid + 256 i) / 16, queries 4 ((tid + 256 i) mod 16) .. + 3; and what
      // the earlier chunks left there
      float* dbw = db_h + static_cast<size_t>(kt * kBK + (tid >> 4)) * t_len + t0 + (tid & 15) * 4;
      float4 old[4];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        // the next step's tiles load into the other stage while this one
        // computes (S = 2), or after it (S = 1)
        const int stage = ns % S;
        auto fetch_next = [&]() {
          if (j + 1 < RPW) {
            fetch(kt, j + 1, (ns + 1) % S);
          } else if (kt + 1 < n_kt) {
            fetch(kt + 1, 0, (ns + 1) % S);
          }
        };
        cp_async_wait<0>();
        if constexpr (WG) {            // q, dO of the chunk; k, v of the step (TMA)
          if (kt == 0 && j == 0) mbar_wait(bars + 2, (b0 / C) & 1);
          mbar_wait(bars + stage, (ns >> 1) & 1);
        }
        __syncthreads();               // step (kt, j) arrived; the other stage is free
        if constexpr (S == 2) fetch_next();
        if (j == RPW - 1 && b0 > 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            old[i] = *reinterpret_cast<const float4*>(dbw + static_cast<size_t>(16 * i) * t_len);
        }
        const int bb = R * j + slot;
        if (bb < cc) {
          const uint16_t* qs = qd + 2 * bb * kT;
          const uint16_t* dos = qs + kT;
          const uint16_t* ks = kv + (stage * R + slot) * 2 * kT;
          const uint16_t* vs = ks + kT;

          // s = q.k^T and dp = do.v^T: 16 queries x 64 keys a warp
          float s[8][4], dp[8][4];
          if constexpr (WG) {          // the slot's four warps: one warpgroup, 64 queries
            const uint64_t dqs = sw128_desc(qs), ddo = sw128_desc(dos);
            const uint64_t dks = sw128_desc(ks), dvs = sw128_desc(vs);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < KD; ++kk)   // + 32 bytes a k-step along the swizzled row
              wgmma_ss(s, dqs + 2 * kk, dks + 2 * kk, kk);
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) wgmma_ss(dp, ddo + 2 * kk, dvs + 2 * kk, kk);
            wg_commit();
            wg_wait();
            wg_hold(s);
            wg_hold(dp);
          } else {
#pragma unroll
            for (int jn = 0; jn < 8; ++jn)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[jn][e] = dp[jn][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
              const int ao = (r0 + lr + 8 * lmid) * LD + 16 * kk + 8 * lhi;
              uint32_t qa[4], da[4];
              ldsm_x4(qa, qs + ao);
              ldsm_x4(da, dos + ao);
#pragma unroll
              for (int jp = 0; jp < 4; ++jp) {   // the B fragments of key tiles 2 jp, 2 jp + 1
                const int bo = (16 * jp + lr + 8 * lhi) * LD + 16 * kk + 8 * lmid;
                uint32_t kf[4], vf[4];
                ldsm_x4(kf, ks + bo);
                ldsm_x4(vf, vs + bo);
                mma_bf16(s[2 * jp], qa, kf[0], kf[1]);
                mma_bf16(s[2 * jp + 1], qa, kf[2], kf[3]);
                mma_bf16(dp[2 * jp], da, vf[0], vf[1]);
                mma_bf16(dp[2 * jp + 1], da, vf[2], vf[3]);
              }
            }
          }
          // ds into dp, its row sum into dbt
          const float* st = stats + bb * 3 * kBQ + r0 + g;
          const float m0 = st[0] * kLog2e, m1 = st[8] * kLog2e;
          const float il0 = 1.0f / st[kBQ], il1 = 1.0f / st[kBQ + 8];
          const float de0 = st[2 * kBQ], de1 = st[2 * kBQ + 8];
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) {
            const TB* bp = bs + (8 * jn + 2 * tg) * LDB + r0 + g;
            const float p0 = exp2_ftz(fmaf(s[jn][0], scale2, fmaf(bias_at(bp), kLog2e, -m0))) * il0;
            const float p1 =
                exp2_ftz(fmaf(s[jn][1], scale2, fmaf(bias_at(bp + LDB), kLog2e, -m0))) * il0;
            const float p2 =
                exp2_ftz(fmaf(s[jn][2], scale2, fmaf(bias_at(bp + 8), kLog2e, -m1))) * il1;
            const float p3 =
                exp2_ftz(fmaf(s[jn][3], scale2, fmaf(bias_at(bp + LDB + 8), kLog2e, -m1))) * il1;
            dp[jn][0] = p0 * (dp[jn][0] - de0);
            dp[jn][1] = p1 * (dp[jn][1] - de0);
            dp[jn][2] = p2 * (dp[jn][2] - de1);
            dp[jn][3] = p3 * (dp[jn][3] - de1);
#pragma unroll
            for (int e = 0; e < 4; ++e) dbt[jn][e] += dp[jn][e];
          }
          // dq += ds.k over the tile's keys: the C fragments of key tiles 2 kk,
          // 2 kk + 1 are the A fragment of step kk; k (rows the keys) is B
          uint32_t a[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            a[kk][0] = pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
            a[kk][1] = pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
            a[kk][2] = pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
            a[kk][3] = pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
          }
          if constexpr (WG) {          // k MN-major: 16 keys (2048 bytes) a k-step
            const uint64_t dks = sw128_desc(ks);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(dqa[j], a[kk], dks + 128 * kk);
            wg_commit();
            wg_wait();
            wg_hold(dqa[j]);
          } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int dd = 0; dd < ND / 2; ++dd) {   // k transposed, dims 16 dd .. + 15
                const int off = (16 * kk + lr + 8 * lmid) * LD + 16 * dd + 8 * lhi;
                uint32_t kf[4];
                ldsm_x4_t(kf, ks + off);
                mma_bf16(dqa[j][2 * dd], a[kk], kf[0], kf[1]);
                mma_bf16(dqa[j][2 * dd + 1], a[kk], kf[2], kf[3]);
              }
          }
        }
        if constexpr (S == 1) {
          __syncthreads();             // the stage is free
          fetch_next();
        }
        ++ns;
      }
      // the slots' sums of the tile meet in shared memory in the (key,
      // query) layout of d(biasT); each thread writes its four float4 as
      // slot 0's sum plus slot 1's (+ the earlier chunks'), in that order
      float* xw = xs + slot * kBK * kBiasLD + r0 + g;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        float* p = xw + (8 * jn + 2 * tg) * kBiasLD;
        p[0] = dbt[jn][0];
        p[kBiasLD] = dbt[jn][1];
        p[8] = dbt[jn][2];
        p[kBiasLD + 8] = dbt[jn][3];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = (16 * i + (tid >> 4)) * kBiasLD + (tid & 15) * 4;
        const float4 a = *reinterpret_cast<const float4*>(xs + off);
        const float4 b = *reinterpret_cast<const float4*>(xs + kBK * kBiasLD + off);
        float4 sum = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
        if (b0 > 0)
          sum = make_float4(old[i].x + sum.x, old[i].y + sum.y, old[i].z + sum.z, old[i].w + sum.w);
        *reinterpret_cast<float4*>(dbw + static_cast<size_t>(16 * i) * t_len) = sum;
      }
    }
    // the chunk's dq, scaled and cast: rows r0 + g (+ 8), dims 8 d + 2 tg (+ 1)
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int bb = R * j + slot;
      if (bb >= cc) continue;
      uint16_t* out = dq + head(b0 + bb) + static_cast<size_t>(t0 + r0 + g) * D + 2 * tg;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        *reinterpret_cast<uint32_t*>(out + 8 * d) =
            pack_bf16x2(dqa[j][d][0] * sm_scale, dqa[j][d][1] * sm_scale);
        *reinterpret_cast<uint32_t*>(out + 8 * D + 8 * d) =
            pack_bf16x2(dqa[j][d][2] * sm_scale, dqa[j][d][3] * sm_scale);
      }
    }
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
int launch_f32(const Args& a) {
  constexpr int kSmem = Plan<D>::kSmem;
  auto kernel = flash_dq<D, TB>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.t_len / kBQ, a.heads), kThreadsDq, kSmem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<const float*>(a.dout), a.l, a.m, a.delta, static_cast<float*>(a.dq), a.db,
      a.b, a.heads, a.t_len, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (rows, 64) bf16 matrix in (64, 64) boxes with the 128-byte
// swizzle; false if the encoding is refused.
bool tile_map(CUtensorMap* map, const void* base, long long rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {64, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {64 * 2};
  const cuuint32_t box[2] = {64, 64}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, typename TB>
int launch_bf16(const Args& a) {
  constexpr int kSmem = PlanDqBf16<D, TB>::kSmem;
  auto kernel = flash_dq_bf16<D, TB>;
  TileMaps maps = {};
  if constexpr (PlanDqBf16<D, TB>::WG) {
    const long long rows = static_cast<long long>(a.b) * a.heads * a.t_len;
    if (!tile_map(&maps.q, a.q, rows) || !tile_map(&maps.d, a.dout, rows) ||
        !tile_map(&maps.k, a.k, rows) || !tile_map(&maps.v, a.v, rows))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.t_len / kBQ, a.heads), kThreadsDq, kSmem, a.st>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<const uint16_t*>(a.dout), a.l, a.m, a.delta, static_cast<uint16_t*>(a.dq),
      a.db, a.b, a.heads, a.t_len, a.sm_scale, maps);
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
  if ((dtype != 0 && dtype != 1) || t_len % kBQ != 0 || b < 1 || heads < 1 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, dout, static_cast<const float*>(l),
               static_cast<const float*>(m), static_cast<const float*>(delta), dq,
               static_cast<float*>(db), b, heads, t_len, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (bias_dtype == 0) return dispatch<float>(dtype, d, a);
  if (bias_dtype == 1) return dispatch<__nv_bfloat16>(dtype, d, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
