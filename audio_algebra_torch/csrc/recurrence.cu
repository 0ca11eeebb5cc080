// The effects bank's three recurrences for Hopper (sm_90a): kernels R1, R2
// and R3 of the port. None has a Pallas counterpart: the JAX package writes
// each as a `lax.scan` (or an associative scan), which torch does not have,
// and a Python loop over 262,144 samples would launch about a million
// kernels a call.
//
// R1 aa_sosfilt replaces audio_algebra_tpu/ops/filters.py:189-232
//   (`sosfilt` over `_biquad_assoc`; `_biquad_scan` :170-187): a cascade of
//   biquad sections in transposed direct form II over each row of (rows, T),
//       y = b0 x + s1;  s1 = b1 x - a1 y + s2;  s2 = b2 x - a2 y,
//   the output of one section the input of the next, the state zero at t = 0.
//   The coefficients (b0, b1, b2, a0, a1, a2), a0 = 1, are per row (a knob
//   sweep's rows each carry their own) or one set for every row.
// R2 aa_envelope replaces audio_algebra_tpu/ops/effects.py:97-102 (the
//   compressor's `lax.scan`): env = c env + (1 - c) |x|, c = a_att where
//   |x| > env, else a_rel, from env = 0. It is not affine, so it has no
//   associative form.
// R3 aa_freeverb_ir replaces audio_algebra_tpu/ops/effects.py:178-223
//   (`freeverb_ir`'s `lax.scan`): the impulse response of JUCE's Freeverb wet
//   path, 8 damped feedback combs summed, then 4 series allpasses.
//
// Bound (all three): the bytes, x read once and y written once (R3: the
// responses written), at the HBM rate; a few FLOP a sample are far under
// the f32 peak. A design that walks a row with one thread is held instead
// by its serial chain (T dependent steps), and the xae path's shapes have
// too few rows to fill 132 SMs that way, so R1 and R3 cut time apart.
//
// The staging that R1 and R2 share: one warp runs 32 segments of rows, a
// thread a segment, the state in registers. A thread reading its own
// segment alone would make a warp's loads stride by the segment's distance,
// so the warp stages 32 x 128 tiles through shared memory, double-buffered:
// cp.async copies the next tile segment by segment (512 contiguous bytes a
// segment, 16 a lane) while each thread runs its segment's 128 samples of the
// current one, 32 at a time moved into registers (float4 reads, row stride
// 132 words: no bank conflict), so no load sits on the chain; the warp
// stores the tile back with 16-byte stores. R2 runs a segment a row.
//
// R1, a chunked time scan. The cascade is linear in its 2N-float state s, so
// each row's time is cut into C chunks of L samples (L a power of two, at
// least 128; the last chunk may be short) and run in three launches:
//   1. ends: every (row, chunk) but each row's last runs its L samples from
//      zero state and writes only its end state z_k. Beside them, other
//      blocks of the launch form each row's Phi = A^L, the cascade's state
//      map over L samples of zero input: each unit state stepped through L
//      samples in float64, a lane a column. (Squaring A log2(L) times is
//      ill-conditioned where a pole lies near 1, the K-weighting's 38 Hz
//      high pass, as JAX's `_biquad_assoc` is: in f32 it misses that Phi
//      by over 1e-4 of its largest entry, as
//      tests/test_torch_recurrence_chunked.py shows.)
//   2. carry: a warp a row steps s_k = Phi s_{k-1} + z_{k-1} from s_0 = 0
//      in float64 and writes each chunk's start state in f32, in two
//      levels: each lane runs g = ceil((C - 1) / 32) chunks from zero, the
//      lanes' group starts go across the warp through Phi^g, and each lane
//      re-runs its chunks from its group's start: 2 g + 31 dependent steps;
//   3. output: every (row, chunk) re-runs its samples from its start state
//      and writes y.
// Passes 1 and 3 run rows x C threads instead of rows, each L dependent
// steps instead of T. ops/recurrence.py picks L from the shape
// (`chunk_plan`); with one chunk only pass 3 runs, from zero state: a
// thread a row. The cascade is instantiated for 1-8
// sections, each unrolled with its state in registers.
//
// R3: one block of 512 threads an impulse response, every delay line in
// shared memory (8 x <= 1,785 + 4 x <= 630 floats at 48 kHz, plus the
// staging below: ~80 KB, dynamic). Time goes in chunks of m samples, m no
// longer than the shortest delay line (244 at 48 kHz, at most 256). Within a
// chunk no delay line reads a slot that the chunk writes, and each sample owns
// its own slot of every line, so a chunk is two phases:
//   1. warp w < 8 runs comb w: its outputs of the chunk, read with
//      consecutive lanes on consecutive slots, are staged (`outs`); the
//      damping chain last = out (1 - damp) + last damp, first-order and
//      linear with a constant coefficient, is a warp scan: each lane steps
//      its run of 8 samples from zero (past the chunk's end, zero input),
//      the warp composes the lanes' maps (damp^8, offset) with
//      __shfl_up_sync in a fixed order (2^q runs at level q: their
//      coefficient is a power of damp^8 known in advance, so only the
//      offsets move), and each lane re-steps its run from its true start
//      value into `lasts`; the warp then writes the feedback in + last
//      feedback with consecutive lanes on consecutive slots. The runs never
//      depend on the response's length, so a shorter response is the
//      longer one's prefix bit for bit. With damp <= 0.4 (JUCE's damping x
//      0.4) the composition is well conditioned.
//   2. warps 8-15, a thread a sample: the comb sum (in the fixed order 0..7;
//      XLA's `out.sum()` may add in another order, a difference of a few f32
//      ulps of the sum) and the 4 allpasses in series.
// The two warp groups run a step apart, chunk c's phase 1 beside chunk c -
// 1's phase 2, with one barrier a step: `outs` is double-buffered between
// them, and no line is touched by both groups. Staged arrays are padded by
// a word every 32, so a lane's run reads and writes them with no bank
// conflict; predicated shared-memory accesses are written as a read or a
// write of a safe address, which the compiler keeps free of branches.
//
// C interface (bound with ctypes): each function launches on the given
// stream, allocates nothing (R1's scratch comes from the caller,
// aa_sosfilt_scratch_bytes says how much), does not synchronise, and
// returns cudaGetLastError(). R1 and R2 take rows of a length that is a
// multiple of 4, 16-byte aligned (ops/recurrence.py pads), fewer than 2^31
// elements in all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;          // segments a block (one warp), R1 and R2
constexpr int kTile = 128;         // samples a staged tile
constexpr int kLd = kTile + 4;     // a tile row's stride: 16-byte rows, no bank conflict
constexpr int kChunk = 32;         // samples a thread holds in registers at once
constexpr unsigned kFull = 0xffffffffu;

constexpr int kCombs = 8;
constexpr int kAllpasses = 4;
constexpr int kIrChunk = 256;      // R3's longest chunk: its sample warps' threads
constexpr int kIrThreads = kCombs * 32 + kIrChunk;    // comb warps, then sample warps
constexpr int kRun = kIrChunk / 32;           // samples a lane's run
constexpr int kStride = kIrChunk + kIrChunk / 32;     // a padded staging row; its last word spare
constexpr long long kMaxSmemBytes = 232448;  // shared memory one block may use on an H100
__constant__ int kCombTunings[kCombs] = {1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617};
__constant__ int kAllpassTunings[kAllpasses] = {556, 441, 341, 225};
constexpr int kCombTuningsHost[kCombs] = {1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617};
constexpr int kAllpassTuningsHost[kAllpasses] = {556, 441, 341, 225};

// The biquad cascade's state: NSEC sections in registers, the state vector
// ordered (s1, s2) section by section.
template <int NSEC>
struct Biquads {
  float b0[NSEC], b1[NSEC], b2[NSEC], a1[NSEC], a2[NSEC], s1[NSEC], s2[NSEC];

  // Coefficients `c`; the state from `st` (2 NSEC floats), or zero if null.
  __device__ void init(const float* c, const float* st) {
#pragma unroll
    for (int k = 0; k < NSEC; ++k) {
      b0[k] = c[6 * k];
      b1[k] = c[6 * k + 1];
      b2[k] = c[6 * k + 2];
      a1[k] = c[6 * k + 4];
      a2[k] = c[6 * k + 5];
      s1[k] = st ? st[2 * k] : 0.f;
      s2[k] = st ? st[2 * k + 1] : 0.f;
    }
  }

  __device__ void store_state(float* st) const {
#pragma unroll
    for (int k = 0; k < NSEC; ++k) {
      st[2 * k] = s1[k];
      st[2 * k + 1] = s2[k];
    }
  }

  __device__ __forceinline__ float operator()(float v) {
#pragma unroll
    for (int k = 0; k < NSEC; ++k) {
      const float y = b0[k] * v + s1[k];
      s1[k] = b1[k] * v - a1[k] * y + s2[k];
      s2[k] = b2[k] * v - a2[k] * y;
      v = y;
    }
    return v;
  }
};

// The compressor's attack / release envelope follower.
struct Envelope {
  float a_att, a_rel, om_att, om_rel, env;

  __device__ void init(float att, float rel) {
    a_att = att;
    a_rel = rel;
    om_att = 1.f - att;      // (1 - coeff) in f32, as the JAX scan computes it
    om_rel = 1.f - rel;
    env = 0.f;
  }

  __device__ __forceinline__ float operator()(float v) {
    const float l = fabsf(v);
    const float up = a_att * env + om_att * l;
    const float down = a_rel * env + om_rel * l;
    env = l > env ? up : down;
    return env;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Segments of rows: each row of t_len samples cut into per_row segments of
// chunk_len samples (the last may be shorter). Segment v is row v /
// per_row's chunk v % per_row; x has fewer than 2^31 elements.
struct Segs {
  int per_row, chunk_len, t_len;

  __device__ int offset(int row, int k) const { return row * t_len + k * chunk_len; }
  __device__ int length(int k) const { return min(chunk_len, t_len - k * chunk_len); }
};

// Start the copy of one tile, samples [t0, t0 + kTile) of each of the
// warp's n_seg segments from (row0, k0) on, into `dst`, 16 bytes a lane a
// segment: each segment's kTile samples are one 512-byte run. Past a
// segment's length nothing is copied (what the buffer holds there is never
// stored). WHOLE: a segment a row (per_row 1), addressed as rows.
template <bool WHOLE>
__device__ __forceinline__ void load_tile(float (*dst)[kLd], const float* __restrict__ x,
                                          const Segs& sg, int row0, int k0, int n_seg,
                                          int t0) {
  const int col = t0 + 4 * threadIdx.x;
  if (WHOLE) {
    if (col < sg.t_len) {
      for (int r = 0; r < n_seg; ++r)
        cp_async16(&dst[r][4 * threadIdx.x], x + (row0 + r) * sg.t_len + col);
    }
  } else {
    for (int r = 0, row = row0, k = k0; r < n_seg; ++r) {
      if (col < sg.length(k)) cp_async16(&dst[r][4 * threadIdx.x], x + sg.offset(row, k) + col);
      if (++k == sg.per_row) {
        k = 0;
        ++row;
      }
    }
  }
  cp_async_commit();
}

// One warp runs `step` along segments [v0, v0 + 32) of `sg` (those below
// n_total), a thread a segment, over min(chunk_len, t_len) samples, in
// tiles of 32 segments x kTile samples double-buffered in shared memory:
// the next tile's cp.async copy is in flight while a thread steps through
// its segment of the current one, kChunk samples at a time in registers.
// With STORE the warp writes each segment's outputs back to y at the same
// offsets with 16-byte stores; without, only the final state (in `step`)
// is kept. Past its length a thread steps on whatever the tile holds; its
// state there is never used. WHOLE: a segment a row (sg.per_row == 1), as
// R2 runs.
template <bool STORE, bool WHOLE, typename Step>
__device__ void scan_segments(const float* __restrict__ x, float* __restrict__ y,
                              const Segs& sg, long long v0, long long n_total, Step& step) {
  __shared__ __align__(16) float tile[2][kRows][kLd];
  const int lane = threadIdx.x;
  const int n_seg = static_cast<int>(min(static_cast<long long>(kRows), n_total - v0));
  const int row0 = static_cast<int>(v0 / sg.per_row), k0 = static_cast<int>(v0 % sg.per_row);
  const int span = min(sg.chunk_len, sg.t_len);
  load_tile<WHOLE>(tile[0], x, sg, row0, k0, n_seg, 0);
  int buf = 0;
  for (int t0 = 0; t0 < span; t0 += kTile, buf ^= 1) {
    if (t0 + kTile < span)
      load_tile<WHOLE>(tile[buf ^ 1], x, sg, row0, k0, n_seg, t0 + kTile);
    else
      cp_async_commit();                       // an empty group keeps the count
    cp_async_wait<1>();                        // this tile's copy has landed
    __syncwarp();
    if (lane < n_seg) {
      float* mine = tile[buf][lane];
      for (int c = 0; c < kTile; c += kChunk) {
        float v[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(mine + c + j);
          v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) v[j] = step(v[j]);
        if (STORE) {
#pragma unroll
          for (int j = 0; j < kChunk; j += 4)
            *reinterpret_cast<float4*>(mine + c + j) = make_float4(v[j], v[j + 1], v[j + 2],
                                                                   v[j + 3]);
        }
      }
    }
    __syncwarp();
    if (STORE) {
      const int col = t0 + 4 * lane;
      if (WHOLE) {
        if (col < sg.t_len) {
          for (int r = 0; r < n_seg; ++r)
            *reinterpret_cast<float4*>(y + (row0 + r) * sg.t_len + col) =
                *reinterpret_cast<const float4*>(&tile[buf][r][4 * lane]);
        }
      } else {
        for (int r = 0, row = row0, k = k0; r < n_seg; ++r) {
          if (col < sg.length(k))
            *reinterpret_cast<float4*>(y + sg.offset(row, k) + col) =
                *reinterpret_cast<const float4*>(&tile[buf][r][4 * lane]);
          if (++k == sg.per_row) {
            k = 0;
            ++row;
          }
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

// The carry's layout of a row's end and start states: chunk k's (k < C -
// 1) in slot (k % g) 32 + k / g, g = ceil((C - 1) / 32), so that lane l of
// the carry, running chunks [l g, l g + g), reads and writes 32 consecutive
// slots at each of its steps.
__host__ __device__ inline int carry_groups(int n_chunks) { return (n_chunks - 1 + 31) / 32; }
__device__ __forceinline__ int carry_slot(int k, int g) { return (k % g) * 32 + k / g; }

// Phi = A^L of the cascade, lane (r, j) of block `blk` stepping column j
// of row blk x 32 / (2 NSEC) + r's Phi: unit state e_j through L samples
// of zero input in float64, written to phi (row-major, 2 NSEC x 2 NSEC a
// row).
template <int NSEC>
__device__ void step_unit_states(const float* __restrict__ sos, int sos_stride,
                                 double* __restrict__ phi, int n_phi, int blk, int chunk_len) {
  constexpr int S = 2 * NSEC;
  const int row = blk * (32 / S) + threadIdx.x / S, col = threadIdx.x % S;
  if (static_cast<int>(threadIdx.x) >= 32 / S * S || row >= n_phi) return;
  const float* c = sos + static_cast<size_t>(row) * sos_stride;
  double b0[NSEC], b1[NSEC], b2[NSEC], a1[NSEC], a2[NSEC], st[S];
#pragma unroll
  for (int k = 0; k < NSEC; ++k) {
    b0[k] = c[6 * k];
    b1[k] = c[6 * k + 1];
    b2[k] = c[6 * k + 2];
    a1[k] = c[6 * k + 4];
    a2[k] = c[6 * k + 5];
  }
#pragma unroll
  for (int m = 0; m < S; ++m) st[m] = m == col ? 1.0 : 0.0;
#pragma unroll 4
  for (int t = 0; t < chunk_len; ++t) {
    double v = st[0];                         // the first section's input is zero
    st[0] = st[1] - a1[0] * v;
    st[1] = -a2[0] * v;
#pragma unroll
    for (int k = 1; k < NSEC; ++k) {
      const double y = b0[k] * v + st[2 * k];
      st[2 * k] = b1[k] * v - a1[k] * y + st[2 * k + 1];
      st[2 * k + 1] = b2[k] * v - a2[k] * y;
      v = y;
    }
  }
  double* out = phi + static_cast<size_t>(row) * S * S;
#pragma unroll
  for (int m = 0; m < S; ++m) out[m * S + col] = st[m];
}

// The blocks of pass 1 that step Phi: 32 / (2 NSEC) rows a block.
template <int NSEC>
__host__ __device__ inline int phi_blocks(int n_phi) {
  constexpr int per_block = 32 / (2 * NSEC);
  return (n_phi + per_block - 1) / per_block;
}

// R1 pass 1. The first phi_blocks(n_phi) blocks step the rows' Phi (n_phi
// = 1 where the rows share their coefficients), beside the segments'
// chains, which take longer. In the others, segment v of rows x
// (n_chunks - 1) is row v / (n_chunks - 1)'s chunk v % (n_chunks - 1), run
// from zero state; its end state goes to ends[v].
template <int NSEC>
__global__ void __launch_bounds__(kRows)
sosfilt_ends_kernel(const float* __restrict__ x, const float* __restrict__ sos,
                    float* __restrict__ ends, double* __restrict__ phi, int rows, int t_len,
                    int sos_stride, int chunk_len, int n_chunks, int n_phi) {
  constexpr int S = 2 * NSEC;
  const int n_phi_blocks = phi_blocks<NSEC>(n_phi);
  if (static_cast<int>(blockIdx.x) < n_phi_blocks) {
    step_unit_states<NSEC>(sos, sos_stride, phi, n_phi, blockIdx.x, chunk_len);
    return;
  }
  const Segs sg{n_chunks - 1, chunk_len, t_len};          // every chunk but a row's last
  const long long n_total = static_cast<long long>(rows) * sg.per_row;
  const long long v0 = static_cast<long long>(blockIdx.x - n_phi_blocks) * kRows;
  const long long v = min(v0 + threadIdx.x, n_total - 1);
  const int row = static_cast<int>(v / sg.per_row), k = static_cast<int>(v % sg.per_row);
  Biquads<NSEC> step;
  step.init(sos + static_cast<size_t>(row) * sos_stride, nullptr);
  scan_segments<false, false>(x, nullptr, sg, v0, n_total, step);
  const int g = carry_groups(n_chunks);
  if (v0 + threadIdx.x < n_total)
    step.store_state(ends + (static_cast<size_t>(row) * 32 * g + carry_slot(k, g)) * S);
}

// Z = X Y for S x S matrices in shared memory, a warp's lanes over the
// entries, in float64.
template <int S>
__device__ void mat_mul(double* __restrict__ z, const double* x, const double* y) {
  for (int e = threadIdx.x; e < S * S; e += 32) {
    const int i = e / S, j = e % S;
    double acc = 0.0;
#pragma unroll
    for (int m = 0; m < S; ++m) acc = fma(x[i * S + m], y[m * S + j], acc);
    z[e] = acc;
  }
  __syncwarp();
}

// s = P s + z in float64: P row-major S x S.
template <int S>
__device__ __forceinline__ void carry_step(double (&s)[S], const double* p, const float* z) {
  double t[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    double acc = z[i];
#pragma unroll
    for (int m = 0; m < S; ++m) acc = fma(p[i * S + m], s[m], acc);
    t[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < S; ++i) s[i] = t[i];
}

// One lane's run of n chunks of the carry, s = P s + z from the given s,
// step d's z at z + 32 S d (the carry's layout), P in registers for S <= 4
// (else read from shared memory); with STORE, s after step d goes to out +
// 32 S d (f32). The end states are loaded D steps ahead of the chain.
template <int S, bool STORE>
__device__ void carry_run(double (&s)[S], const double* __restrict__ p_smem,
                          const float* __restrict__ z, int n, float* __restrict__ out) {
  constexpr int D = S <= 4 ? 8 : 2;
  constexpr bool kRegs = S <= 4;
  constexpr int kStep = 32 * S;
  if (n <= 0) return;
  double pr[kRegs ? S * S : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int e = 0; e < S * S; ++e) pr[e] = p_smem[e];
  }
  auto step = [&](const float* zk) {
    if constexpr (kRegs)
      carry_step<S>(s, pr, zk);
    else
      carry_step<S>(s, p_smem, zk);
  };
  auto put = [&](int d) {
    if (STORE) {
#pragma unroll
      for (int i = 0; i < S; ++i) out[static_cast<size_t>(d) * kStep + i] = static_cast<float>(s[i]);
    }
  };
  float zq[D][S];
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int i = 0; i < S; ++i) zq[d][i] = z[static_cast<size_t>(min(d, n - 1)) * kStep + i];
  }
  int d0 = 0;
  for (; d0 + D <= n; d0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float cur[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        cur[i] = zq[d][i];
        zq[d][i] = z[static_cast<size_t>(min(d0 + d + D, n - 1)) * kStep + i];
      }
      step(cur);
      put(d0 + d);
    }
  }
  for (; d0 < n; ++d0) {                       // fewer than D left
    step(z + static_cast<size_t>(d0) * kStep);
    put(d0);
  }
}

// R1 pass 2: a warp a row, the chunks' start states s_k = Phi s_{k-1} +
// z_{k-1} from s_0 = 0 in float64, s_k written to starts (f32) in chunk k
// - 1's slot of the carry's layout, in two levels:
// lane l takes the g = ceil((C - 1) / 32) chunks from l g and (A) runs
// them from zero, u_l; (B) the group starts S_{l+1} = Phi^g S_l + u_l go
// across the lanes, S_0 = 0 (Phi^g by squarings in float64: Phi^g only
// decays); (C) each lane re-runs its chunks from S_l and writes their
// starts. 2 g + 31 dependent steps instead of C - 1.
template <int NSEC>
__global__ void __launch_bounds__(32)
sosfilt_carry_kernel(const double* __restrict__ phi, const float* __restrict__ ends,
                     float* __restrict__ starts, int phi_stride, int n_chunks) {
  constexpr int S = 2 * NSEC;
  __shared__ double p[S * S], r[S * S], t[S * S], spare_buf[S * S];
  const int row = blockIdx.x, lane = threadIdx.x;
  for (int e = lane; e < S * S; e += 32) {
    p[e] = phi[static_cast<size_t>(row) * phi_stride + e];
    r[e] = e / S == e % S ? 1.0 : 0.0;
    t[e] = p[e];
  }
  __syncwarp();
  const int n_ends = n_chunks - 1;
  const int g = carry_groups(n_chunks);
  // Phi^g by squaring and multiplying: rr = Phi^(g's bits so far), tt = Phi^(2^q)
  double* rr = r;
  double* tt = t;
  double* spare = spare_buf;
  for (int q = g; q > 0; q >>= 1) {
    if (q & 1) {
      mat_mul<S>(spare, rr, tt);
      double* w = rr; rr = spare; spare = w;
    }
    if (q > 1) {
      mat_mul<S>(spare, tt, tt);
      double* w = tt; tt = spare; spare = w;
    }
  }
  constexpr bool kRegs = S <= 4;
  double pg_regs[kRegs ? S * S : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int e = 0; e < S * S; ++e) pg_regs[e] = rr[e];
  }
  const size_t lane_base = (static_cast<size_t>(row) * 32 * g + lane) * S;
  const int n_mine = min(g, max(n_ends - lane * g, 0));                // this lane's chunks
  double u[S], run[S], mine[S];
#pragma unroll
  for (int i = 0; i < S; ++i) u[i] = run[i] = mine[i] = 0.0;
  carry_run<S, false>(u, p, ends + lane_base, n_mine, nullptr);       // (A)
  for (int l = 0; l < 31; ++l) {                                      // (B)
    double next[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      double acc = __shfl_sync(kFull, u[i], l);
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if constexpr (kRegs)
          acc = fma(pg_regs[i * S + m], run[m], acc);
        else
          acc = fma(rr[i * S + m], run[m], acc);
      }
      next[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      run[i] = next[i];
      if (lane == l + 1) mine[i] = next[i];
    }
  }
  carry_run<S, true>(mine, p, ends + lane_base, n_mine, starts + lane_base);   // (C)
}

// R1 pass 3 (with one chunk, the whole filter): segment v of rows x n_chunks
// is row v / n_chunks's chunk v % n_chunks, run from its start state (chunk
// 0 from zero), its outputs written to y.
template <int NSEC>
__global__ void __launch_bounds__(kRows)
sosfilt_kernel(const float* __restrict__ x, const float* __restrict__ sos,
               const float* __restrict__ starts, float* __restrict__ y, int rows, int t_len,
               int sos_stride, int chunk_len, int n_chunks) {
  const Segs sg{n_chunks, chunk_len, t_len};
  const long long n_total = static_cast<long long>(rows) * n_chunks;
  const long long v0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long v = min(v0 + threadIdx.x, n_total - 1);
  const int row = static_cast<int>(v / n_chunks), k = static_cast<int>(v % n_chunks);
  const int g = carry_groups(n_chunks);
  Biquads<NSEC> step;
  step.init(sos + static_cast<size_t>(row) * sos_stride,
            k > 0 ? starts + (static_cast<size_t>(row) * 32 * g + carry_slot(k - 1, g)) * 2 * NSEC
                  : nullptr);
  scan_segments<true, false>(x, y, sg, v0, n_total, step);
}

__global__ void __launch_bounds__(kRows)
envelope_kernel(const float* __restrict__ x, float* __restrict__ env, int rows, int t_len,
                float a_att, float a_rel) {
  Envelope step;
  step.init(a_att, a_rel);
  scan_segments<true, true>(x, env, Segs{1, t_len, t_len},
                            static_cast<long long>(blockIdx.x) * kRows, rows, step);
}

__host__ __device__ inline int delay_size(int sr, int tuning, int spread) {
  const long long s = static_cast<long long>(sr) * (tuning + spread) / 44100;
  return s > 1 ? static_cast<int>(s) : 1;
}

// Position p of a padded staging row: a word of padding every 32, so a
// lane's run (stride r) and consecutive lanes both miss bank conflicts.
__device__ __forceinline__ int padded(int p) { return p + (p >> 5); }

__global__ void __launch_bounds__(kIrThreads)
freeverb_ir_kernel(const float* __restrict__ feedback, const float* __restrict__ damp,
                   const int* __restrict__ spreads, float* __restrict__ ir, int n, int sr,
                   int chunk) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const bool comb_warp = warp < kCombs;       // warp w < 8 runs comb w; the rest, samples
  const int spread = spreads[b];
  int asize[kAllpasses], aoff[kAllpasses];
  int total = 0, my_size = 1, my_off = 0;
#pragma unroll
  for (int k = 0; k < kCombs; ++k) {
    const int size = delay_size(sr, kCombTunings[k], spread);
    if (k == warp) {
      my_size = size;
      my_off = total;
    }
    total += size;
  }
#pragma unroll
  for (int k = 0; k < kAllpasses; ++k) {
    asize[k] = delay_size(sr, kAllpassTunings[k], spread);
    aoff[k] = total;
    total += asize[k];
  }
  float* outs = smem + total;                 // [2][kCombs][kStride]: comb outputs
  float* lasts = outs + 2 * kCombs * kStride; // [kCombs][kStride]: damped feedback
  for (int i = tid; i < total; i += kIrThreads) smem[i] = 0.f;
  const float fb = feedback[b], dm = damp[b], odm = 1.f - dm;
  // Comb warps: lane l's run is positions [8 l, 8 l + 8) of a chunk (those
  // past its end are zero), a map last -> dm^8 last + off; pw[q] = (dm^8)^(2^q)
  // composes 2^q runs, a_before = (dm^8)^l the runs before this one.
  float pw[5], a_before = 1.f;
  pw[0] = 1.f;
#pragma unroll
  for (int j = 0; j < kRun; ++j) pw[0] *= dm;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    if (q > 0) pw[q] = pw[q - 1] * pw[q - 1];
    if (lane >> q & 1) a_before *= pw[q];
  }
  const int first = kRun * lane;               // the lane's run, and its staging index:
  const int run_at = first + lane / 4;         // padded(first + j) = run_at + j
  float* line = smem + my_off;                // comb `warp`'s delay line
  float* lb = lasts + (comb_warp ? warp : 0) * kStride;
  float last = 0.f;                           // comb `warp`'s state, the same in every lane
  int cpos = 0;                               // i0 mod the comb's delay
  // Sample warps: sample `at` of a chunk; (i0 + at) mod each allpass delay
  const int at = tid - kCombs * 32;
  int apos[kAllpasses];
#pragma unroll
  for (int k = 0; k < kAllpasses; ++k) apos[k] = comb_warp ? 0 : at % asize[k];
  __syncthreads();

  // Step c: the comb warps run chunk c's phase 1 while the sample warps
  // run chunk c - 1's phase 2; `outs` is double-buffered between them.
  // Position p = 32 j + lane of a chunk is staged at padded(p) = 33 j + lane.
  const int n_chunks = (n + chunk - 1) / chunk;
  for (int c = 0; c <= n_chunks; ++c) {
    if (comb_warp && c < n_chunks) {
      const int i0 = c * chunk, m = min(chunk, n - i0);
      float* ob = outs + ((c & 1) * kCombs + warp) * kStride;
      // its outputs, consecutive lanes on consecutive slots, all loaded,
      // then staged
      float o[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int p = 32 * j + lane;
        int slot = cpos + p;
        if (slot >= my_size) slot -= my_size;
        const float out = line[p < m ? slot : 0];            // no branch: read, then select
        o[j] = p < m ? out : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j) ob[33 * j + lane] = o[j];
      __syncwarp();
      // the lane's run from zero: last = out (1 - damp) + last damp
      float u[kRun];
      float off = 0.f;
#pragma unroll
      for (int j = 0; j < kRun; ++j) u[j] = (first + j < m ? ob[run_at + j] : 0.f) * odm;
#pragma unroll
      for (int j = 0; j < kRun; ++j) off = fmaf(off, dm, u[j]);
      // compose the runs' maps in lane order, 2^q runs at level q
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const float up = __shfl_up_sync(kFull, off, 1 << q);
        if (lane >= 1 << q) off = fmaf(pw[q], up, off);
      }
      float off_before = __shfl_up_sync(kFull, off, 1);
      if (lane == 0) off_before = 0.f;
      // re-step the run from its true start value into `lasts`
      float v = fmaf(a_before, last, off_before), v_end = 0.f;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        v = fmaf(v, dm, u[j]);
        lb[run_at + j] = v;
        v_end = first + j == chunk - 1 ? v : v_end;
      }
      last = __shfl_sync(kFull, v_end, (chunk - 1) / kRun);
      __syncwarp();
      // the feedback, consecutive lanes on consecutive slots (positions
      // past the chunk's end write to the staging row's spare last word)
      float d[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) d[j] = lb[33 * j + lane];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int p = 32 * j + lane;
        int slot = cpos + p;
        if (slot >= my_size) slot -= my_size;
        const float inp = i0 + p == 0 ? 1.f : 0.f;
        *(p < m ? line + slot : lb + kStride - 1) = inp + d[j] * fb;
      }
      cpos += chunk;
      if (cpos >= my_size) cpos -= my_size;
    } else if (!comb_warp && c > 0) {
      const int i0 = (c - 1) * chunk, m = min(chunk, n - i0);
      if (at < m) {
        // Each sample owns its slot of every allpass within a chunk, so its
        // four slots are read at once and the stages run in series.
        float bufout[kAllpasses], comb[kCombs];
#pragma unroll
        for (int k = 0; k < kAllpasses; ++k) bufout[k] = smem[aoff[k] + apos[k]];
        const float* sb = outs + ((c - 1) & 1) * kCombs * kStride + padded(at);
#pragma unroll
        for (int k = 0; k < kCombs; ++k) comb[k] = sb[k * kStride];
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kCombs; ++k) acc += comb[k];
#pragma unroll
        for (int k = 0; k < kAllpasses; ++k) {
          smem[aoff[k] + apos[k]] = acc + bufout[k] * 0.5f;
          acc = bufout[k] - acc;
        }
        ir[static_cast<size_t>(b) * n + i0 + at] = acc;
      }
#pragma unroll
      for (int k = 0; k < kAllpasses; ++k) {
        apos[k] += chunk;                       // chunk <= every delay
        if (apos[k] >= asize[k]) apos[k] -= asize[k];
      }
    }
    __syncthreads();
  }
}

unsigned blocks_for(long long segments) {
  return static_cast<unsigned>((segments + kRows - 1) / kRows);
}

}  // namespace

// R1's scratch when time is cut into n_chunks > 1: Phi for each row (one if
// the rows share coefficients) in float64, then the end states and the
// start states, each rows x 32 g x 2 n_sec f32 in the carry's layout.
struct SosScratch {
  double* phi = nullptr;
  float* ends = nullptr;
  float* starts = nullptr;

  static long long n_phi(int rows, int n_sec, int sos_per_row) {
    return (sos_per_row ? rows : 1) * 4LL * n_sec * n_sec;
  }
  static long long n_ends(int rows, int n_sec, int n_chunks) {   // the carry's layout
    return static_cast<long long>(rows) * 32 * carry_groups(n_chunks) * 2 * n_sec;
  }
  static long long bytes(int rows, int n_sec, int sos_per_row, int n_chunks) {
    return n_phi(rows, n_sec, sos_per_row) * 8 + 2 * n_ends(rows, n_sec, n_chunks) * 4;
  }

  SosScratch(void* base, int rows, int n_sec, int sos_per_row, int n_chunks) {
    if (!base) return;
    phi = static_cast<double*>(base);
    ends = reinterpret_cast<float*>(phi + n_phi(rows, n_sec, sos_per_row));
    starts = ends + n_ends(rows, n_sec, n_chunks);
  }
};

// (chunk length, chunk count) of a call, or chunk length 0 for an invalid
// one. chunk_len 0, or at least t_len, is one chunk a row; else a power of
// two from kTile.
static int2 sos_chunks(int t_len, int chunk_len) {
  if (chunk_len == 0 || chunk_len >= t_len) return make_int2(t_len, 1);
  if (chunk_len < kTile || (chunk_len & (chunk_len - 1))) return make_int2(0, 0);
  return make_int2(chunk_len, (t_len + chunk_len - 1) / chunk_len);
}

template <int NSEC>
cudaError_t launch_sosfilt(const float* x, const float* sos, float* y, const SosScratch& w,
                           int rows, int t_len, int sos_per_row, int chunk_len, int n_chunks,
                           cudaStream_t stream) {
  constexpr int S = 2 * NSEC;
  const int stride = sos_per_row ? 6 * NSEC : 0;
  if (n_chunks > 1) {
    const int n_phi = sos_per_row ? rows : 1;
    sosfilt_ends_kernel<NSEC>
        <<<phi_blocks<NSEC>(n_phi) + blocks_for(static_cast<long long>(rows) * (n_chunks - 1)),
           kRows, 0,
           stream>>>(x, sos, w.ends, w.phi, rows, t_len, stride, chunk_len, n_chunks, n_phi);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sosfilt_carry_kernel<NSEC><<<rows, 32, 0, stream>>>(w.phi, w.ends, w.starts,
                                                        sos_per_row ? S * S : 0, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sosfilt_kernel<NSEC><<<blocks_for(static_cast<long long>(rows) * n_chunks), kRows, 0,
                         stream>>>(x, sos, n_chunks > 1 ? w.starts : nullptr, y, rows, t_len,
                                   stride, chunk_len, n_chunks);
  return cudaGetLastError();
}

// The bytes of scratch aa_sosfilt needs for these arguments (0 with one
// chunk), or -1 if they are invalid.
extern "C" long long aa_sosfilt_scratch_bytes(int rows, int t_len, int n_sec, int sos_per_row,
                                              int chunk_len) {
  if (rows < 1 || t_len < 1 || t_len % 4 || n_sec < 1 || n_sec > 8 || chunk_len < 0 ||
      static_cast<long long>(rows) * t_len >= (1LL << 31))
    return -1;
  const int2 c = sos_chunks(t_len, chunk_len);
  if (c.x == 0) return -1;
  return c.y > 1 ? SosScratch::bytes(rows, n_sec, sos_per_row, c.y) : 0;
}

// x, y: (rows, t_len) f32; sos: (rows or 1, n_sec, 6); scratch: at least
// aa_sosfilt_scratch_bytes, 8-byte aligned (unused with one chunk).
extern "C" int aa_sosfilt(const float* x, const float* sos, float* y, void* scratch, int rows,
                          int t_len, int n_sec, int sos_per_row, int chunk_len, void* stream) {
  if (aa_sosfilt_scratch_bytes(rows, t_len, n_sec, sos_per_row, chunk_len) < 0)
    return cudaErrorInvalidValue;
  const int2 c = sos_chunks(t_len, chunk_len);
  if (c.y > 1 && !scratch) return cudaErrorInvalidValue;
  const SosScratch w(scratch, rows, n_sec, sos_per_row, c.y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AA_SOSFILT_CASE(N)                                                                 \
  case N:                                                                                  \
    return launch_sosfilt<N>(x, sos, y, w, rows, t_len, sos_per_row, c.x, c.y, s);
  switch (n_sec) {
    AA_SOSFILT_CASE(1)
    AA_SOSFILT_CASE(2)
    AA_SOSFILT_CASE(3)
    AA_SOSFILT_CASE(4)
    AA_SOSFILT_CASE(5)
    AA_SOSFILT_CASE(6)
    AA_SOSFILT_CASE(7)
    AA_SOSFILT_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef AA_SOSFILT_CASE
}

extern "C" int aa_envelope(const float* x, float* env, int rows, int t_len, float a_att,
                           float a_rel, void* stream) {
  if (rows < 1 || t_len < 1 || t_len % 4 || static_cast<long long>(rows) * t_len >= (1LL << 31))
    return cudaErrorInvalidValue;
  envelope_kernel<<<blocks_for(rows), kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      x, env, rows, t_len, a_att, a_rel);
  return cudaGetLastError();
}

// The chunk length and shared memory of a launch whose spreads lie in
// [min_spread, max_spread] (the delay sizes grow with the spread).
static int freeverb_chunk(int sr, int min_spread) {
  int m = kIrChunk;
  for (int k = 0; k < kAllpasses; ++k)
    m = min(m, delay_size(sr, kAllpassTuningsHost[k], min_spread));
  for (int k = 0; k < kCombs; ++k) m = min(m, delay_size(sr, kCombTuningsHost[k], min_spread));
  return m;
}

static long long freeverb_smem_bytes(int sr, int max_spread) {
  long long total = 3LL * kCombs * kStride;
  for (int k = 0; k < kCombs; ++k) total += delay_size(sr, kCombTuningsHost[k], max_spread);
  for (int k = 0; k < kAllpasses; ++k) total += delay_size(sr, kAllpassTuningsHost[k], max_spread);
  return total * static_cast<long long>(sizeof(float));
}

extern "C" int aa_freeverb_ir(const float* feedback, const float* damp, const int* spreads,
                              float* ir, int n_ir, int n, int sr, int min_spread,
                              int max_spread, void* stream) {
  if (n_ir < 1 || n < 1 || sr < 1 || min_spread < 0) return cudaErrorInvalidValue;
  const long long smem = freeverb_smem_bytes(sr, max_spread);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      freeverb_ir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  freeverb_ir_kernel<<<n_ir, kIrThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      feedback, damp, spreads, ir, n, sr, freeverb_chunk(sr, min_spread));
  return cudaGetLastError();
}
