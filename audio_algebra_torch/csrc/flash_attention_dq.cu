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
// The sum over the batch. d(biasT) is shared by the batch. One block owns
// (head, 64-query tile) and is the only block that touches dbT[h, :, t0 :
// t0 + 64]. It walks the batch in chunks of C rows; inside a chunk the key
// tiles are the outer loop and the chunk's batch rows the inner one, so each
// (key tile, query tile) of dbT is summed over the chunk's rows in registers,
// in ascending b, and written once: the strip makes ceil(B / C) trips to
// device memory (the first chunk writes, later ones read, add and write),
// with no atomics, no fill, any B, and the same bits every run. dq of the C
// rows accumulates across the key tiles in f32 in shared memory (C x 64 x D,
// XOR-swizzled so the fragment stores hit distinct banks) and is written
// once per chunk. C is the largest count up to 8 that fits beside the tiles
// in 227 KB: 4 at D = 64 in f32, 8 at D = 64 in bf16.
//
// The products. Eight warps: warp w owns query rows 16 (w mod 4) .. + 15 and
// keys 32 (w / 4) .. + 31 of the tile. s = q.k^T, dp = do.v^T and the dq
// partial ds.k run on the tensor cores through mma.sync: bf16 as m16n8k16;
// f32 as 3xTF32 m16n8k8 (each operand split into a TF32 hi part and the
// TF32 rounding of its remainder, lo; hi.lo + lo.hi + hi.hi with f32
// accumulation), which keeps f32's tolerance where plain TF32 does not. The
// ds fragments feed the dq product straight from registers: for TF32 the
// product's k index is permuted (key 2 tg for column tg, key 2 tg + 1 for tg
// + 4) and the K fragment is read with the same permutation. The two warps
// of a query slice add their dq partials into shared memory in a fixed
// order (key half 0, a barrier, key half 1).
//
// Pipelining: the four tiles of a step (q, do of the batch row; k, v of the
// key tile) arrive by cp.async into one of two stages while the other is in
// use (one stage at D = 128 in f32, where two do not fit). The (key, query)
// bias tile is read once per key tile, for every row of the chunk.
//
// Bound: operations. f32: 9 TF32 products of 2 B H T^2 D at the dense TF32
// peak (3 products, 3 passes each); bf16: 3 products at the bf16 peak. The
// grid is H x T / 64 blocks of one per SM (shared memory): 256 at T = 1024,
// H = 16, two waves of 132 SMs less 8 slots.
//
// C interface (bound with ctypes): aa_flash_attention_dq launches one
// kernel on the given stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError().

#include "flash_common.cuh"

namespace {

using namespace aa_flash;

constexpr int kThreadsDq = 256;
constexpr int kMaxSmem = 232448;
constexpr int kBiasBytes = kBK * kBiasLD * 4;

// Shared memory plan for element type E at head dim D: two stages of the
// four tiles if at least two batch rows of dq accumulators fit beside them,
// else one; then the chunk C (up to 8).
constexpr int smem_left(int stages, int tile) {
  return kMaxSmem - stages * 4 * tile - kBiasBytes;
}

template <typename E, int D>
struct Plan {
  static constexpr int LD = D + 8;               // tile row stride: fragment reads hit 32 banks
  static constexpr int kTile = kBQ * LD * static_cast<int>(sizeof(E));
  static constexpr int kRow = kBQ * D * 4;       // one batch row's dq accumulator
  static constexpr int kStages = smem_left(2, kTile) >= 2 * kRow ? 2 : 1;
  static constexpr int kLeft = smem_left(kStages, kTile);
  static constexpr int kChunk = kLeft / kRow < 8 ? kLeft / kRow : 8;
  static constexpr int kSmem = kStages * 4 * kTile + kBiasBytes + kChunk * kRow;
  static_assert(kChunk >= 1 && kSmem <= kMaxSmem, "K4c's tiles do not fit");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying a (64, D) tile, contiguous rows, into shared memory (row
// stride D + 8).
template <typename E, int D>
__device__ __forceinline__ void async_tile(const E* __restrict__ src, E* dst, int tid) {
  constexpr int V = 16 / sizeof(E);
  constexpr int kChunks = D / V;
  for (int i = tid; i < kBQ * kChunks; i += kThreadsDq) {
    const int r = i / kChunks, c = (i % kChunks) * V;
    cp_async16(dst + r * (D + 8) + c, src + static_cast<size_t>(r) * D + c);
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32, the small cross terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, alo, bh0, bh1);
  mma_tf32(c, ahi, bl0, bl1);
  mma_tf32(c, ahi, bh0, bh1);
}

// s[j] = rows r0 .. r0 + 15 of `as` dotted with rows kb + 8 j .. + 7 of
// `bs` (j < 4: 32 keys), over D. TF32's k index is permuted within each
// 8-wide step (dims 2 tg, 2 tg + 1 for tg, tg + 4), the same in A and B.
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

template <int D>
__device__ __forceinline__ void rows_dot(float (&s)[4][4], const uint16_t* as,
                                         const uint16_t* bs, int r0, int kb, int g, int tg) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a_frag(a, as, LD, r0, 16 * kk, g, tg);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int off = (kb + 8 * j + g) * LD + 16 * kk + 2 * tg;
      mma_bf16(s[j], a, ld32(bs + off), ld32(bs + off + 8));
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

template <int D>
__device__ __forceinline__ void ds_times_k(float (&dq)[D / 8][4], const float (&ds)[4][4],
                                           const uint16_t* ks, int kb, int g, int tg) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t a[4];
    c_to_a_frag(a, ds[2 * kk], ds[2 * kk + 1]);
    const uint16_t* kr = ks + (kb + 16 * kk + 2 * tg) * LD + g;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      const uint16_t* kc = kr + 8 * d;
      mma_bf16(dq[d], a, pack16(kc[0], kc[LD]), pack16(kc[8 * LD], kc[9 * LD]));
    }
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

__device__ __forceinline__ void store4(uint16_t* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(aa::bf16_pack(v.x, v.y), aa::bf16_pack(v.z, v.w));
}

// E: float or uint16_t (bf16 bits); TB: the bias's type.
template <typename E, int D, typename TB>
__global__ void __launch_bounds__(kThreadsDq)
flash_dq(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
         const TB* __restrict__ bias, const E* __restrict__ dout, const float* __restrict__ l,
         const float* __restrict__ m, const float* __restrict__ delta, E* __restrict__ dq,
         float* __restrict__ db, int batch, int heads, int t_len, float sm_scale) {
  using P = Plan<E, D>;
  constexpr int LD = P::LD, S = P::kStages, C = P::kChunk, kTileElems = kBQ * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  E* tiles = reinterpret_cast<E*>(smem);                   // [S][q, do, k, v][64 x LD]
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
      E* dst = tiles + (n % S) * 4 * kTileElems;
      async_tile<E, D>(q + head + static_cast<size_t>(t0) * D, dst, tid);
      async_tile<E, D>(dout + head + static_cast<size_t>(t0) * D, dst + kTileElems, tid);
      async_tile<E, D>(k + head + s0 * D, dst + 2 * kTileElems, tid);
      async_tile<E, D>(v + head + s0 * D, dst + 3 * kTileElems, tid);
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
      const E* qs = tiles + (n % S) * 4 * kTileElems;
      const E* dos = qs + kTileElems;
      const E* ks = qs + 2 * kTileElems;
      const E* vs = qs + 3 * kTileElems;
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

struct Args {
  const void *q, *k, *v, *bias, *dout;
  const float *l, *m, *delta;
  void* dq;
  float* db;
  int b, heads, t_len;
  float sm_scale;
  cudaStream_t st;
};

template <typename E, int D, typename TB>
int launch(const Args& a) {
  constexpr int kSmem = Plan<E, D>::kSmem;
  auto kernel = flash_dq<E, D, TB>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.t_len / kBQ, a.heads), kThreadsDq, kSmem, a.st>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k), static_cast<const E*>(a.v),
      static_cast<const TB*>(a.bias), static_cast<const E*>(a.dout), a.l, a.m, a.delta,
      static_cast<E*>(a.dq), a.db, a.b, a.heads, a.t_len, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB>
int dispatch(int dtype, int d, const Args& a) {
#define AA_FLASH_D(DV) \
  case DV:             \
    return dtype == 1 ? launch<uint16_t, DV, TB>(a) : launch<float, DV, TB>(a);
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
