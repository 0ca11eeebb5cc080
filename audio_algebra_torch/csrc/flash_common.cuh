// Pieces shared by the rel-pos flash attention kernels (flash_attention.cu:
// the forward, K3 and K4a; flash_attention_dkv.cu: K4b; flash_attention_dq.cu:
// K4c): the 64 x 64 tiling, the tile loaders, cp.async, ldmatrix, the bf16
// and 3xTF32 mma.sync wrappers, and the base-2 exponential.
#pragma once

#include "common.cuh"

namespace aa_flash {

constexpr int kBQ = 64;              // query rows of a tile
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

// The A fragment (16 rows x 16 columns) of an m16n8k16 product from a
// row-major bf16 tile in shared memory: rows r0 + g and r0 + g + 8,
// columns c0 + 2 tg (+1) and c0 + 8 + 2 tg (+1).
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const uint16_t* tile, int ld,
                                            int r0, int c0, int g, int tg) {
  const uint16_t* p = tile + (r0 + g) * ld + c0 + 2 * tg;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// The A fragment of k-step kk from two neighbouring f32 C fragments (the
// 8-wide column tiles 2 kk and 2 kk + 1), rounded to bf16.
__device__ __forceinline__ void c_to_a_frag(uint32_t (&a)[4], const float (&lo)[4],
                                            const float (&hi)[4]) {
  a[0] = aa::bf16_pack(lo[0], lo[1]);
  a[1] = aa::bf16_pack(lo[2], lo[3]);
  a[2] = aa::bf16_pack(hi[0], hi[1]);
  a[3] = aa::bf16_pack(hi[2], hi[3]);
}

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

// Start copying a (64, D) tile of contiguous rows into shared memory with
// row stride ld (elements; ld * sizeof(E) a multiple of 16).
template <typename E, int D>
__device__ __forceinline__ void async_tile(const E* __restrict__ src, E* dst, int ld, int tid,
                                           int n_threads) {
  constexpr int V = 16 / sizeof(E);
  constexpr int kChunks = D / V;
  for (int i = tid; i < kBQ * kChunks; i += n_threads) {
    const int r = i / kChunks, c = (i % kChunks) * V;
    cp_async16(dst + r * ld + c, src + static_cast<size_t>(r) * D + c);
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi its TF32 rounding, lo the TF32 rounding of the remainder.
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

// c += a.b in 3xTF32 (alo.bhi + ahi.blo + ahi.bhi, the small cross terms
// first, f32 accumulation); b0, b1 are split here. m16n8k8 fragments: lane
// 4 g + tg holds A (g, tg), (g + 8, tg), (g, tg + 4), (g + 8, tg + 4), B
// (k tg, n g), (k tg + 4, n g) and C (g, 2 tg), (g, 2 tg + 1), (g + 8,
// 2 tg), (g + 8, 2 tg + 1). The first form takes B already split (a B
// fragment that serves several A fragments is split once).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(c, alo, bhi[0], bhi[1]);
  mma_tf32(c, ahi, blo[0], blo[1]);
  mma_tf32(c, ahi, bhi[0], bhi[1]);
}

__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bhi[2], blo[2];
  split(b0, bhi[0], blo[0]);
  split(b1, bhi[1], blo[1]);
  mma_3xtf32(c, ahi, alo, bhi, blo);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 2^x in one MUFU instruction (flush to zero below 2^-126).
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// (lo, hi) rounded to bf16 and packed in one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

}  // namespace aa_flash
