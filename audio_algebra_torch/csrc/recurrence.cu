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
//   associative form; but for a level l the step e -> c e + (1 - c) l is
//   piecewise affine in e with two pieces, continuous (both give l at e =
//   l) and monotone with slopes in (0, 1). So a chunk's map is affine for a
//   fixed branch pattern, and an error in a chunk's start never grows
//   within it: R2 cuts time apart by Newton rounds over chunks (below).
// R3 aa_freeverb_ir replaces audio_algebra_tpu/ops/effects.py:178-223
//   (`freeverb_ir`'s `lax.scan`): the impulse response of JUCE's Freeverb wet
//   path, 8 damped feedback combs summed, then 4 series allpasses.
//
// Bound (all three): the bytes, x read once and y written once (R3: the
// responses written), at the HBM rate; a few FLOP a sample are far under
// the f32 peak. A design that walks a row with one thread is held instead
// by its serial chain (T dependent steps), and the xae path's shapes have
// too few rows to fill 132 SMs that way, so all three cut time apart.
//
// The staging that R1 and R2 share: one warp runs 32 segments of rows, a
// thread a segment, the state in registers. A thread reading its own
// segment alone would make a warp's loads stride by the segment's distance,
// so the warp stages 32 x 128 tiles through shared memory, double-buffered:
// cp.async copies the next tile segment by segment (512 contiguous bytes a
// segment, 16 a lane) while each thread runs its segment's 128 samples of the
// current one, 32 at a time moved into registers (float4 reads, row stride
// 132 words: no bank conflict), so no load sits on the chain; the warp
// stores the tile back with 16-byte stores. R2's one-chunk route runs a
// segment a row; its chunked route gives each warp of a block its own tile.
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
// R2, Newton rounds over chunks (the DEER scheme of Lim et al., ICLR 2024,
// at chunk granularity). Each row's time is cut into C chunks of L samples
// (ops/recurrence.envelope_plan: L a power of two from 128, C <= 2,048), a
// row to a cluster of up to 8 blocks of up to 8 warps, a thread a chunk, in
// one launch, each block's chunks held in its shared memory where they fit
// (`envelope_blocks`). Every chunk runs from a guessed start (0), keeping its end and
// the product of the coefficients it took (counted as attack steps: a_att^n
// a_rel^(L - n), in float64). A float64 scan of the affine maps s_{k+1} =
// E_k + P_k (s_k - g_k) carries new starts across the row; every chunk
// re-runs from them and its end is compared with the next chunk's start.
// After round r the first r chunks are exact (chunk 0 starts at its true
// 0), so the rounds end; in practice a few do (PERF.md). A chunk that
// passes the check within tolerance tau has an output within tau |s| of
// the walk from the exact start, since the step is 1-Lipschitz. After
// kEnvMaxRounds carries a row still failing is walked serially from its
// first failing chunk: at worst the serial walk's cost. The rounds, the
// check and the carry run on the device between cluster barriers, so the
// wrapper never waits on the host. Where rows alone fill the card or a row
// is at most 128 samples, one chunk: envelope_kernel, a thread a row.
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
// aa_sosfilt_scratch_bytes says how much; R2's round counts go to the
// caller's stats), does not synchronise, and returns cudaGetLastError().
// R1 and R2 take rows of a length that is a multiple of 4, 16-byte aligned
// (ops/recurrence.py pads), fewer than 2^31 elements in all.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cgs = cooperative_groups;

namespace {

constexpr int kRows = 32;          // segments a block (one warp), R1 and R2
constexpr int kTile = 128;         // samples a staged tile
constexpr int kLd = kTile + 4;     // a tile row's stride: 16-byte rows, no bank conflict
constexpr int kChunk = 32;         // samples a thread holds in registers at once
constexpr unsigned kFull = 0xffffffffu;
// R2's chunked route: warps a block (a streamed block's: a tile each),
// blocks a cluster (a row)
constexpr int kEnvWarps = 8;
constexpr int kEnvStreamWarps = 4;
constexpr int kEnvMaxCluster = 8;
constexpr int kEnvMaxRounds = 32;                 // carries before the repair
constexpr float kEnvTol = 1.0f / 524288.0f;       // 2^-19, relative, at the chunk ends
constexpr float kEnvFloor = 1e-30f;               // |s| below it compared as 1e-30
constexpr int kNone = 0x7fffffff;                 // no failing chunk
constexpr long long kEnvResidentBytes = 200 * 1024;   // a block's dynamic shared memory at most

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
  const int lane = threadIdx.x % 32;
  const int col = t0 + 4 * lane;
  if (WHOLE) {
    if (col < sg.t_len) {
      for (int r = 0; r < n_seg; ++r)
        cp_async16(&dst[r][4 * lane], x + (row0 + r) * sg.t_len + col);
    }
  } else {
    for (int r = 0, row = row0, k = k0; r < n_seg; ++r) {
      if (col < sg.length(k)) cp_async16(&dst[r][4 * lane], x + sg.offset(row, k) + col);
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
// tiles of 32 segments x kTile samples double-buffered in the warp's
// `tile` (shared memory, [2][kRows][kLd]): the next tile's cp.async copy is
// in flight while a thread steps through its segment of the current one,
// kChunk samples at a time in registers. With STORE the warp writes each
// segment's outputs back to y at the same offsets with 16-byte stores;
// without, only the final state (in `step`) is kept. Past its length a
// thread steps on whatever the tile holds; its state there is never used.
// WHOLE: a segment a row (sg.per_row == 1), as R2's one-chunk route runs.
template <bool STORE, bool WHOLE, typename Step>
__device__ void scan_segments(float (*tile)[kRows][kLd], const float* __restrict__ x,
                              float* __restrict__ y, const Segs& sg, long long v0,
                              long long n_total, Step& step) {
  const int lane = threadIdx.x % 32;
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
  __shared__ __align__(16) float tile[2][kRows][kLd];
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
  scan_segments<false, false>(tile, x, nullptr, sg, v0, n_total, step);
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
  __shared__ __align__(16) float tile[2][kRows][kLd];
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
  scan_segments<true, false>(tile, x, y, sg, v0, n_total, step);
}

__global__ void __launch_bounds__(kRows)
envelope_kernel(const float* __restrict__ x, float* __restrict__ env, int rows, int t_len,
                float a_att, float a_rel) {
  __shared__ __align__(16) float tile[2][kRows][kLd];
  Envelope step;
  step.init(a_att, a_rel);
  scan_segments<true, true>(tile, x, env, Segs{1, t_len, t_len},
                            static_cast<long long>(blockIdx.x) * kRows, rows, step);
}

// The envelope step, counting the attack steps it takes (the chunk's slope
// is a_att^n_att a_rel^(L - n_att)); the step itself is Envelope's.
struct EnvelopeCount {
  Envelope e;
  int n_att;

  __device__ void init(float att, float rel, float start) {
    e.init(att, rel);
    e.env = start;
    n_att = 0;
  }

  __device__ __forceinline__ float operator()(float v) {
    n_att += fabsf(v) > e.env;
    return e(v);
  }
};

// An affine map d -> a d + b, in float64; then(f, g) is g after f.
struct Affine {
  double a, b;
};

__device__ __forceinline__ Affine then(const Affine& f, const Affine& g) {
  return {g.a * f.a, fma(g.a, f.b, g.b)};
}

// What a block of R2's chunked route publishes each pass for the blocks
// after it: its chunks' carry maps composed (the link from the block
// before left out), its first chunk's start, its last chunk's end and
// slope, and its first chunk that failed against a predecessor in the
// block.
struct BlockSum {
  Affine total;
  double last_slope;
  float first_start, last_end;
  int first_fail;
};

// R2's resident staging: a warp's 32 chunks held whole in its part of the
// shared memory, chunk r of the warp in row r (stride L + 4 words: a lane's
// float4 reads of its own row then miss bank conflicts, as kLd does).
// Copied in once, 16 bytes a lane of one chunk at a time; past a short last
// chunk's end a row holds whatever was there, and the thread's state there
// is never used.
__device__ void load_resident(float* __restrict__ buf, int ld, const float* __restrict__ x,
                              const Segs& sg, int row, int k0, int n_seg) {
  const int lane = threadIdx.x % 32;
  for (int r = 0; r < n_seg; ++r) {
    const float* src = x + sg.offset(row, k0 + r);
    const int len = sg.length(k0 + r);
    for (int c = 4 * lane; c < len; c += 128) cp_async16(buf + r * ld + c, src + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
}

// Each lane runs `step` along its resident chunk (chunk_len samples, kChunk
// at a time in registers); with STORE the outputs replace the inputs in
// place, and after each kChunk columns the warp copies them out to y with
// 16-byte stores (8 lanes a chunk's 128 bytes, 4 chunks a store), which
// then drain while the next columns run.
template <bool STORE, typename Step>
__device__ void run_resident(float* __restrict__ buf, int ld, float* __restrict__ y,
                             const Segs& sg, int row, int k0, int n_seg, Step& step) {
  const int lane = threadIdx.x % 32;
  float* mine = buf + lane * ld;
  for (int c = 0; c < sg.chunk_len; c += kChunk) {
    if (lane < n_seg) {
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
    if (STORE) {
      __syncwarp();
      const int col = c + 4 * (lane % 8);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 4 * i + lane / 8;
        if (r < n_seg && col < sg.length(k0 + r))
          *reinterpret_cast<float4*>(y + sg.offset(row, k0 + r) + col) =
              *reinterpret_cast<const float4*>(buf + r * ld + col);
      }
    }
  }
}

// A warp's run over its chunks from the starts in `step`: RESIDENT from
// its chunks in shared memory (`smem`: its rows), else streamed from x
// through its double-buffered tile (`smem`: [2][kRows][kLd]).
template <bool RESIDENT, bool STORE, typename Step>
__device__ __forceinline__ void run_chunks(float* smem, int ld, const float* __restrict__ x,
                                           float* __restrict__ y, const Segs& sg, int row,
                                           int k0, Step& step) {
  const int n_seg = min(32, sg.per_row - k0);
  if (n_seg <= 0) return;
  if constexpr (RESIDENT) {
    run_resident<STORE>(smem, ld, y, sg, row, k0, n_seg, step);
  } else {
    const long long v0 = static_cast<long long>(row) * sg.per_row + k0;
    scan_segments<STORE, false>(reinterpret_cast<float (*)[kRows][kLd]>(smem), x, y, sg, v0,
                                v0 + n_seg, step);
  }
}

// R2's chunked route: a cluster of blocks a row (grid rows x n_blocks,
// clusters of n_blocks), a thread a chunk, chunk k = rank x blockDim.x +
// threadIdx.x of the row. RESIDENT: each warp copies its 32 chunks into its
// part of the dynamic shared memory once and every run reads them there
// (streamed from L2 through scan_segments' tiles instead, a run's waits on
// the copies took about half its time); else streamed, for rows too long
// for the cluster's shared memory. The rounds:
//   run    every chunk from its start s_k (at first the guess 0), keeping
//          its end E_k and its count of attack steps;
//   check  chunk k > 0 passes where |E_{k-1} - s_k| <= kEnvTol max(|s_k|,
//          kEnvFloor); written as !(d > tol), so a NaN passes and carries
//          on as the serial walk's does. All pass: done;
//   carry  d_k = s'_k - s_k from d_0 = 0, d_k = P_{k-1} d_{k-1} + (E_{k-1}
//          - s_k), P_{k-1} the product of chunk k - 1's coefficients: an
//          inclusive scan of affine maps in float64, over the warp by
//          shuffles, over the block's warps and the cluster's blocks (the
//          blocks' totals read through distributed shared memory), then
//          s_k := s'_k in f32.
// One cluster barrier a round: each block composes its own links first
// and publishes the sum (BlockSum, double-buffered by the pass's parity:
// a block writes a slot again only after the next barrier, when every
// reader is done), and the links between blocks are composed after the
// barrier. The runs store nothing (stores in every run cost more than one
// more pass); after the last round every chunk runs once more from the
// same starts and writes its outputs. After
// kEnvMaxRounds carries, the rows still failing are repaired: the thread of
// the first failing chunk walks from there to the row's end from its
// predecessor's end (checked exact), over those outputs. stats[row] = the
// carries run, stats[rows + row] = 1 if the repair ran.
template <bool RESIDENT>
__global__ void __launch_bounds__(kEnvWarps * 32)
envelope_rounds_kernel(const float* __restrict__ x, float* __restrict__ env,
                       int* __restrict__ stats, int rows, int t_len, int chunk_len,
                       int n_chunks, float a_att, float a_rel) {
  extern __shared__ __align__(16) float smem_env[];   // a warp's rows, or its tile
  __shared__ float ends[kEnvWarps * 32];
  __shared__ int counts[kEnvWarps * 32];
  __shared__ Affine warp_total[kEnvWarps];
  __shared__ int warp_first[kEnvWarps];
  __shared__ BlockSum sums[2];                         // by the pass's parity
  cgs::cluster_group cluster = cgs::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / n_blocks;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_threads = blockDim.x, n_warps = n_threads / 32;
  const int k = rank * n_threads + tid;                // this thread's chunk
  const int k0 = rank * n_threads + warp * 32;         // its warp's first
  const bool inner = tid > 0 && k < n_chunks;          // its predecessor in the block
  const Segs sg{n_chunks, chunk_len, t_len};
  const int ld = chunk_len + 4;                        // a resident row's stride
  float* mine = smem_env + warp * (RESIDENT ? 32 * ld : 2 * kRows * kLd);
  if (RESIDENT && k0 < n_chunks) load_resident(mine, ld, x, sg, row, k0, min(32, n_chunks - k0));
  const double ln_att = log(static_cast<double>(a_att));
  const double ln_rel = log(static_cast<double>(a_rel));
  auto slope = [&](int n_att) { return exp(n_att * ln_att + (chunk_len - n_att) * ln_rel); };
  auto fails = [](float end, float s) {                // a NaN passes
    return fabsf(end - s) > kEnvTol * fmaxf(fabsf(s), kEnvFloor);
  };
  auto gap = [](float end, float s) {                  // exact where equal (no inf - inf)
    return end == s ? 0.0 : static_cast<double>(end) - s;
  };

  float start = 0.f;                 // s_k: the first guess is zero
  float prev_end = 0.f;              // E_{k-1} of the last run
  int rounds = 0, first = kNone;
  for (int pass = 0;; ++pass) {
    EnvelopeCount step;
    step.init(a_att, a_rel, start);
    run_chunks<RESIDENT, false>(mine, ld, x, nullptr, sg, row, k0, step);
    ends[tid] = step.e.env;
    counts[tid] = step.n_att;
    __syncthreads();
    // the links within the block; the block's first chunk's link, from the
    // block before, is composed after the cluster barrier
    Affine m{1.0, 0.0};
    if (inner) {
      prev_end = ends[tid - 1];
      m = {slope(counts[tid - 1]), gap(prev_end, start)};
    }
    const unsigned failed = __ballot_sync(kFull, inner && fails(prev_end, start));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Affine up{__shfl_up_sync(kFull, m.a, o), __shfl_up_sync(kFull, m.b, o)};
      if (lane >= o) m = then(up, m);
    }
    if (lane == 31) warp_total[warp] = m;
    if (lane == 0) warp_first[warp] = failed ? k0 + __ffs(failed) - 1 : kNone;
    __syncthreads();
    Affine before{1.0, 0.0}, total{1.0, 0.0};
    int block_first = kNone;
    for (int w = 0; w < n_warps; ++w) {
      if (w < warp) before = then(before, warp_total[w]);
      total = then(total, warp_total[w]);
      block_first = min(block_first, warp_first[w]);
    }
    const Affine m_local = then(before, m);   // d_k from d at the block's first chunk
    if (tid == 0)
      sums[pass & 1] = {total, slope(counts[n_threads - 1]), start, ends[n_threads - 1],
                        block_first};
    cluster.sync();                                    // every block's sum
    // lane r reads block r's sum; each thread then walks the blocks in order:
    // d at block r's first chunk = P_last(r - 1) d_last(r - 1) + (E_last(r -
    // 1) - s_first(r)), and that link's check
    BlockSum theirs{{1.0, 0.0}, 1.0, 0.f, 0.f, kNone};
    if (lane < n_blocks) theirs = *cluster.map_shared_rank(&sums[pass & 1], lane);
    double d_first = 0.0, d_mine = 0.0;
    double a_prev = 1.0, b_prev = 0.0, slope_prev = 1.0;
    float end_prev = 0.f;
    first = kNone;
#pragma unroll
    for (int r = 0; r < kEnvMaxCluster; ++r) {
      const double ta = __shfl_sync(kFull, theirs.total.a, r);
      const double tb = __shfl_sync(kFull, theirs.total.b, r);
      const double sl = __shfl_sync(kFull, theirs.last_slope, r);
      const float s_first = __shfl_sync(kFull, theirs.first_start, r);
      const float e_last = __shfl_sync(kFull, theirs.last_end, r);
      first = min(first, __shfl_sync(kFull, theirs.first_fail, r));
      if (r > 0 && r < n_blocks) {
        d_first = slope_prev * fma(a_prev, d_first, b_prev) + gap(end_prev, s_first);
        if (fails(end_prev, s_first)) first = min(first, r * n_threads);
        if (r == rank && tid == 0) prev_end = end_prev;
      }
      if (r == rank) d_mine = d_first;
      a_prev = ta;
      b_prev = tb;
      slope_prev = sl;
      end_prev = e_last;
    }
    if (first == kNone || rounds == kEnvMaxRounds) break;
    start = static_cast<float>(start + fma(m_local.a, d_mine, m_local.b));
    ++rounds;
  }
  EnvelopeCount step;                // the outputs, from the last run's starts
  step.init(a_att, a_rel, start);
  run_chunks<RESIDENT, true>(mine, ld, x, env, sg, row, k0, step);
  const bool repair = first != kNone;
  if (repair) {
    cluster.sync();                                    // the chunks' outputs first
    if (k == first) {
      Envelope walk;
      walk.init(a_att, a_rel);
      walk.env = prev_end;
      const int base = row * t_len;
      for (int t = k * chunk_len; t < t_len; ++t) env[base + t] = walk(x[base + t]);
    }
  }
  if (rank == 0 && tid == 0) {
    stats[row] = rounds;
    stats[rows + row] = repair;
  }
  cluster.sync();                    // no block leaves while its sums may be read
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

// R2's chunked route: one cluster launch, a cluster of ceil(C / (32
// warps)) blocks a row (at most kEnvMaxCluster), resident or streamed as
// ops/recurrence.envelope_blocks picks: resident, a warp's 32 chunks in
// (L + 4) x 32 words; streamed, a warp's double-buffered tile. A cluster of
// at most 8 blocks of 256 threads and 201 KB fits a GPC of the H100; a
// launch that does not fit returns its error.
template <bool RESIDENT>
static cudaError_t launch_envelope_rounds(const float* x, float* env, int* stats, int rows,
                                          int t_len, int chunk_len, int n_chunks, int warps,
                                          size_t smem, float a_att, float a_rel,
                                          cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(envelope_rounds_kernel<RESIDENT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(kEnvResidentBytes));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int threads = 32 * warps;
  const int n_blocks = (n_chunks + threads - 1) / threads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * n_blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n_blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, envelope_rounds_kernel<RESIDENT>, x, env, stats, rows, t_len,
                            chunk_len, n_chunks, a_att, a_rel);
}

// x, env: (rows, t_len) f32. chunk_len 0, or at least t_len, is one chunk a
// row (envelope_kernel, a thread a row; the rest unused); else a power of
// two from kTile, the chunked route in blocks of `warps` warps (resident:
// 1 to kEnvWarps; streamed: 1 to kEnvStreamWarps), at most kEnvMaxCluster
// blocks a row, which writes stats: int[2 rows], the carries a row ran,
// then 1 where its repair ran.
extern "C" int aa_envelope(const float* x, float* env, int* stats, int rows, int t_len,
                           int chunk_len, int warps, int resident, float a_att, float a_rel,
                           void* stream) {
  if (rows < 1 || t_len < 1 || t_len % 4 || chunk_len < 0 ||
      static_cast<long long>(rows) * t_len >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int2 c = sos_chunks(t_len, chunk_len);
  if (c.x == 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c.y == 1) {
    envelope_kernel<<<blocks_for(rows), kRows, 0, s>>>(x, env, rows, t_len, a_att, a_rel);
    return cudaGetLastError();
  }
  const size_t smem = resident ? 32ULL * warps * (c.x + 4) * sizeof(float)
                               : static_cast<size_t>(warps) * 2 * kRows * kLd * sizeof(float);
  if (!stats || warps < 1 || warps > (resident ? kEnvWarps : kEnvStreamWarps) ||
      c.y > 32 * warps * kEnvMaxCluster || smem > static_cast<size_t>(kEnvResidentBytes))
    return cudaErrorInvalidValue;
  if (resident)
    return launch_envelope_rounds<true>(x, env, stats, rows, t_len, c.x, c.y, warps, smem,
                                        a_att, a_rel, s);
  return launch_envelope_rounds<false>(x, env, stats, rows, t_len, c.x, c.y, warps, smem, a_att,
                                       a_rel, s);
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
