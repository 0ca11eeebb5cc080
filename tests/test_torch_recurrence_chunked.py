"""Numpy models of the decompositions that R1 and R3 run on the card
(csrc/recurrence.cu), against the JAX package's scans on the CPU.

R1, the chunked time scan: each row's time cut into C chunks of L samples;
every chunk run from zero state for its end state (f32), the chunks' start
states carried in float64 through Phi = A^L (each unit state stepped
through L samples in float64; in two levels, as the carry kernel runs it),
every chunk re-run from its start state (f32). Held against JAX's sequential `_biquad_scan` in f32 and
scipy's float64 `sosfilt`: no further from float64 than twice the
sequential scan's own distance.

R2, Newton rounds over chunks: each row's time cut into C chunks of L
samples; every chunk run in f32 from a start (at first 0) for its end and
its count of attack steps; each chunk's start checked against its
predecessor's end (relative tolerance ENV_TOL); the starts carried in
float64 by the kernel's scan of affine maps (lanes by doubling, then warps
and the blocks' links in order); after ENV_MAX_ROUNDS carries a serial
walk from the first failing chunk. Held against JAX's compressor `lax.scan` in f32 and a
float64 serial walk: no further from float64, elementwise, than twice the
serial f32 walk (or 1e-6 of the row's peak).

R3, the damping chain as a warp scan inside Freeverb's chunk loop: each of
32 lanes steps its run of ceil(chunk / 32) samples from zero, the lanes'
maps (damp^run, offset) composed in the kernel's shuffle order, each run
re-stepped from its true start. Held against JAX's `freeverb_ir`.

The kernels themselves are held against their twins on the card by
chip_smoke.py's recurrence phase and tests/test_torch_kernels_cuda.py.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from audio_algebra_tpu.ops import effects as jfx
from audio_algebra_tpu.ops import filters as jflt
from audio_algebra_tpu.ops.loudness import _k_weighting_sos
from audio_algebra_torch.ops import recurrence as rec

F32 = np.float32


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30)))


# ------------------------------------------------------------------- R1 ---

def _cascade_f32(sos, x, state):
    """The kernel's cascade in f32 over segments: sos (S, n, 6), x (S, L),
    state (S, 2n) ordered (s1, s2) a section -> (y, end state)."""
    s1, s2 = state[:, 0::2].copy(), state[:, 1::2].copy()
    b0, b1, b2, a1, a2 = (sos[:, :, i] for i in (0, 1, 2, 4, 5))
    y = np.empty_like(x)
    for t in range(x.shape[1]):
        v = x[:, t]
        for k in range(sos.shape[1]):
            out = b0[:, k] * v + s1[:, k]
            s1[:, k] = b1[:, k] * v - a1[:, k] * out + s2[:, k]
            s2[:, k] = b2[:, k] * v - a2[:, k] * out
            v = out
        y[:, t] = v
    end = np.empty_like(state)
    end[:, 0::2], end[:, 1::2] = s1, s2
    return y, end


def _phi_stepped(sos_row, chunk_len, dtype=np.float64):
    """Phi = A^L as the kernel forms it: each unit state e_j (column j)
    stepped through L samples of zero input, in float64."""
    n = sos_row.shape[0]
    st = np.eye(2 * n, dtype=dtype)                 # st[:, j]: unit state e_j
    b0, b1, b2, _, a1, a2 = (sos_row[:, i].astype(dtype) for i in range(6))
    for _ in range(chunk_len):
        v = np.zeros(2 * n, dtype)
        for k in range(n):
            y = b0[k] * v + st[2 * k]
            st[2 * k], st[2 * k + 1] = b1[k] * v - a1[k] * y + st[2 * k + 1], b2[k] * v - a2[k] * y
            v = y
    return st


def _carry_serial(phi, ends):
    """s_0 = 0, s_k = Phi s_{k-1} + z_{k-1}: (C, S) from ends (C - 1, S)."""
    s = np.zeros((len(ends) + 1, phi.shape[0]))
    for k in range(1, len(s)):
        s[k] = phi @ s[k - 1] + ends[k - 1]
    return s


def _carry_two_level(phi, ends, lanes=32):
    """The carry kernel's levels: lane l runs its g chunks from zero (u_l),
    the group starts S_{l+1} = Phi^g S_l + u_l go across the lanes (Phi^g by
    squaring and multiplying in float64), each lane re-runs its chunks from
    S_l."""
    n_ends, n = len(ends), phi.shape[0]
    g = -(-n_ends // lanes)
    phig, base, q = np.eye(n), phi.copy(), g
    while q:
        if q & 1:
            phig = phig @ base
        base, q = base @ base, q >> 1
    groups = [range(min(l * g, n_ends), min(l * g + g, n_ends)) for l in range(lanes)]
    u = []
    for ks in groups:
        v = np.zeros(n)
        for k in ks:
            v = phi @ v + ends[k]
        u.append(v)
    s = np.zeros((n_ends + 1, n))
    start = np.zeros(n)
    for l, ks in enumerate(groups):
        v = start
        for k in ks:
            v = phi @ v + ends[k]
            s[k + 1] = v
        start = phig @ start + u[l]
    return s


def chunked_sosfilt(sos, x, chunk_len):
    """The three passes: sos (rows or 1, n, 6) f32, x (rows, T) f32."""
    rows, t_len = x.shape
    sos = np.broadcast_to(sos, (rows, *sos.shape[1:])).astype(F32)
    n_state = 2 * sos.shape[1]
    chunks = -(-t_len // chunk_len)
    padded = np.zeros((rows, chunks * chunk_len), F32)
    padded[:, :t_len] = x
    segs = padded.reshape(rows, chunks, chunk_len)
    # 1. ends: every chunk but the last from zero state
    _, ends = _cascade_f32(np.repeat(sos, chunks - 1, 0),
                           segs[:, :-1].reshape(-1, chunk_len),
                           np.zeros((rows * (chunks - 1), n_state), F32))
    ends = ends.reshape(rows, chunks - 1, n_state).astype(np.float64)
    # 2. carry in float64, in the kernel's two levels
    starts = np.zeros((rows, chunks, n_state), F32)
    for r in range(rows):
        starts[r] = _carry_two_level(_phi_stepped(sos[r], chunk_len), ends[r])
    # 3. output: every chunk from its start state
    y, _ = _cascade_f32(np.repeat(sos, chunks, 0), segs.reshape(-1, chunk_len),
                        starts.reshape(-1, n_state))
    return y.reshape(rows, -1)[:, :t_len]


def _butter_cascade(n_sec, rows, per_row):
    cuts = np.linspace(1500.0, 12000.0, rows if per_row else 1)
    one = [np.asarray(jflt.butter_sos(2, float(c), 48000, "lowpass"), F32) for c in cuts]
    return np.stack([np.concatenate([s] * n_sec) for s in one])        # (R|1, n_sec, 6)


@jax.jit
def _jax_scan_jit(sos, x):
    for i in range(sos.shape[1]):
        x = jflt._biquad_scan(x, sos[:, i, :3], sos[:, i, 3:])
    return x


def _jax_scan(sos, x):
    """JAX's sequential `_biquad_scan`, section by section, per-row
    coefficients broadcast over the rows."""
    return np.asarray(_jax_scan_jit(jnp.asarray(sos), jnp.asarray(x)))


def _f64(sos, x):
    return np.stack([scipy.signal.sosfilt(sos[min(r, len(sos) - 1)].astype(np.float64),
                                          x[r].astype(np.float64)) for r in range(len(x))])


def _held(model, scan, f64):
    """The model as close to float64 as twice the sequential scan (f32's
    floor 1e-6 below that), and as close to the scan."""
    own = rel_rms(scan, f64)
    assert rel_rms(model, f64) <= max(2 * own, 1e-6), (rel_rms(model, f64), own)
    assert rel_rms(model, scan) <= max(2 * own, 1e-6), (rel_rms(model, scan), own)


@pytest.mark.parametrize("n_sec", [1, 2, 8])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("t_len,chunk_len", [(1000, 128), (1000, 64), (37, 1), (300, 512)])
def test_chunked_sosfilt_model_matches_jax_scan_and_f64(n_sec, per_row, t_len, chunk_len):
    """Ragged last chunks (1000 = 7 x 128 + 104, 15 x 64 + 40), L = 1 (a
    chunk a sample: the carry alone), L > T (one chunk: the zero-state run)."""
    rows = 3
    x = (0.3 * np.random.default_rng(n_sec + t_len).standard_normal((rows, t_len))).astype(F32)
    sos = _butter_cascade(n_sec, rows, per_row)
    model = chunked_sosfilt(sos, x, chunk_len)
    _held(model, _jax_scan(np.broadcast_to(sos, (rows, *sos.shape[1:])), x), _f64(sos, x))


def test_chunked_sosfilt_model_k_weighting():
    """K-weighting at 48 kHz (its 38 Hz high pass has a pole near 1, where
    JAX's f32 associative scan drifts) over 65,536 samples, L = 1024."""
    sos = np.asarray(_k_weighting_sos(48000), F32)[None]                # (1, 2, 6)
    x = (0.3 * np.random.default_rng(7).standard_normal((2, 65536))).astype(F32)
    model = chunked_sosfilt(sos, x, 1024)
    scan = np.asarray(jflt.sosfilt(jnp.asarray(sos[0]), jnp.asarray(x), method="scan"))
    _held(model, scan, _f64(sos, x))


@pytest.mark.parametrize("chunk_len", [128, 2048])
def test_phi_stepped_in_float64(chunk_len):
    """The carry's Phi, stepped in float64, against the same steps in long
    double, at the K-weighting and an 8-section cascade. Squaring A in f32
    instead (log-depth, as JAX's `_biquad_assoc` composes) misses the
    K-weighting's Phi by a large share of its largest entry."""
    kw = np.asarray(_k_weighting_sos(48000), F32)
    for sos_row in (kw, _butter_cascade(8, 1, False)[0]):
        ref = _phi_stepped(sos_row, chunk_len, np.longdouble)
        scale = float(np.abs(ref).max())
        assert float(np.abs(_phi_stepped(sos_row, chunk_len) - ref).max()) <= 1e-11 * scale
    squared = _phi_stepped(kw, 1).astype(F32)
    for _ in range(chunk_len.bit_length() - 1):
        squared = squared @ squared
    ref = _phi_stepped(kw, chunk_len, np.longdouble)
    assert float(np.abs(squared - ref).max()) > 1e-4 * float(np.abs(ref).max())


@pytest.mark.parametrize("n_ends", [1, 31, 32, 33, 100, 2812])
def test_two_level_carry_equals_the_serial_carry(n_ends):
    """Loudness's carry (L = 512, up to its 2,812 end states) in the
    kernel's two levels against one chain, in float64: within 1e-11 of the
    largest state, far below the f32 rounding of the start states that the
    carry writes."""
    phi = _phi_stepped(np.asarray(_k_weighting_sos(48000), F32), 512)
    ends = np.random.default_rng(n_ends).standard_normal((n_ends, 4))
    serial = _carry_serial(phi, ends)
    assert np.abs(_carry_two_level(phi, ends) - serial).max() <= 1e-11 * np.abs(serial).max()


@pytest.mark.parametrize("rows,t_len,want", [
    (128, 262144, (512, 512)),       # the xae TPT filters
    (2, 1440000, (512, 2813)),       # loudness of a 30 s track at 48 kHz
    (16, 65536, (128, 512)),         # the apps' filter sweeps
    (1024, 32768, (512, 64)),        # the phaser's segments
    (33, 1000, (128, 8)),
    (3, 128, (128, 1)),              # at most MIN_CHUNK: one chunk
    (40000, 4096, (4096, 1)),        # rows alone fill the card: one chunk
])
def test_chunk_plan(rows, t_len, want):
    length, chunks = rec.chunk_plan(rows, t_len)
    assert (length, chunks) == want
    if chunks > 1:
        assert length & (length - 1) == 0 and rec.MIN_CHUNK <= length <= rec.MAX_CHUNK
        assert (chunks - 1) * length < t_len <= chunks * length
        assert rows * chunks <= rec.MAX_SEGMENTS and chunks <= 8 * length


# ------------------------------------------------------------------- R2 ---

A_ATT, A_REL = F32(math.exp(-1.0 / 48.0)), F32(math.exp(-1.0 / 4800.0))   # 1 ms / 100 ms
ENV_T = 20_000               # ragged at every L below: a last chunk of 32 or 544
ENV_KINDS = ("noise", "burst", "gate", "crescendo", "dc", "dc_0.3", "zeros", "nan")


def _env_inputs() -> np.ndarray:
    """One row a kind, ENV_T samples: white noise; a burst of 4,000 samples
    then silence; a decaying 220 Hz tone gated on for 1,024 samples from
    every multiple of 2,048 (the level jumps at chunk starts for L <= 1024)
    and silent between; a 440 Hz sine under a linear ramp; DC at 0.5 (ties
    held exactly) and at 0.3 (ties jitter by an ulp); zeros; noise with a
    NaN at sample 12,345."""
    rng = np.random.default_rng(17)
    t = np.arange(ENV_T)
    noise = 0.3 * rng.standard_normal(ENV_T)
    burst = np.where(t < 4000, 0.8 * rng.standard_normal(ENV_T), 0.0)
    gate = np.where(t % 2048 < 1024,
                    0.8 * np.sin(2 * np.pi * 220 * t / 48000) * np.exp(-(t % 2048) / 600), 0.0)
    crescendo = np.sin(2 * np.pi * 440 * t / 48000) * t / ENV_T
    nan = 0.3 * rng.standard_normal(ENV_T)
    nan[12345] = np.nan
    rows = [noise, burst, gate, crescendo, np.full(ENV_T, 0.5), np.full(ENV_T, 0.3),
            np.zeros(ENV_T), nan]
    return np.stack(rows).astype(F32)


def _fma32(a, b, c):
    """a b + c rounded once to f32 (the f32 product is exact in float64)."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(F32)


def _env_run(level, env):
    """The kernel's step in f32 along rows of `level` (n, m) from `env` (n,):
    c = a_att where l > env, else a_rel; env = c env + (1 - c) l with the
    product c env fused into the sum -> (outputs, ends, attack steps)."""
    om_att, om_rel = F32(1) - A_ATT, F32(1) - A_REL
    env = np.asarray(env, F32).copy()
    out = np.empty(level.shape, F32)
    n_att = np.zeros(level.shape[0], np.int64)
    for t in range(level.shape[1]):
        lv = level[:, t]
        att = lv > env
        env = np.where(att, _fma32(A_ATT, env, om_att * lv), _fma32(A_REL, env, om_rel * lv))
        n_att += att
        out[:, t] = env
    return out, env, n_att


def _then(f, g):
    """The affine map g after f, each (a, b) for d -> a d + b."""
    return g[0] * f[0], g[0] * f[1] + g[1]


def _carry_scan(a, b, warps):
    """The kernel's inclusive scan of the maps (a_k, b_k) over a row's C
    chunks in float64, applied to d_0 = 0, in its order: within each block
    of `warps` warps (its first chunk's map, the link from the block
    before, left out) lanes of 32 by doubling (the shuffles), then the
    warps in order; then the blocks' links in order, d at block r's first
    chunk = a_first(r) (T_{r-1} applied to d at block r - 1's first chunk)
    + b_first(r), T the block's composed maps. Chunks past C carry the
    identity."""
    n = len(a)
    threads = 32 * warps
    pad = -n % threads
    a = np.concatenate([a, np.ones(pad)]).reshape(-1, warps, 32)
    b = np.concatenate([b, np.zeros(pad)]).reshape(-1, warps, 32)
    link = (a[:, 0, 0].copy(), b[:, 0, 0].copy())
    a[:, 0, 0], b[:, 0, 0] = 1.0, 0.0
    for o in (1, 2, 4, 8, 16):
        up = (np.concatenate([np.ones(a.shape[:2] + (o,)), a[..., :-o]], -1),
              np.concatenate([np.zeros(b.shape[:2] + (o,)), b[..., :-o]], -1))
        a, b = _then(up, (a, b))
    local_a, local_b = np.empty_like(a), np.empty_like(b)
    totals = []
    for blk in range(len(a)):
        before = (1.0, 0.0)
        for w in range(warps):
            local_a[blk, w], local_b[blk, w] = _then(before, (a[blk, w], b[blk, w]))
            before = _then(before, (a[blk, w, 31], b[blk, w, 31]))
        totals.append(before)
    d_first = [0.0]
    for r in range(1, len(a)):
        ta, tb = totals[r - 1]
        d_first.append(link[0][r] * (ta * d_first[-1] + tb) + link[1][r])
    d = local_a * np.asarray(d_first)[:, None, None] + local_b
    return d.reshape(-1)[:n]


def chunked_envelope(x, chunk_len, max_rounds=rec.ENV_MAX_ROUNDS):
    """R2's rounds on one row x (T,) f32 -> (envelope, carries, repaired)."""
    t_len, L = len(x), chunk_len
    chunks = -(-t_len // L)
    level = np.zeros(chunks * L, F32)
    level[:t_len] = np.abs(x)
    segs = level.reshape(chunks, L)
    ln_att, ln_rel = math.log(float(A_ATT)), math.log(float(A_REL))
    warps = rec.envelope_blocks(L, chunks)[1]
    chained = np.arange(chunks) > 0
    start = np.zeros(chunks, F32)
    rounds = 0
    with np.errstate(invalid="ignore"):
        while True:
            _, ends, n_att = _env_run(segs, start)
            prev_end = np.concatenate([[F32(0)], ends[:-1]]).astype(F32)
            prev_n = np.concatenate([[0], n_att[:-1]])
            tol = F32(rec.ENV_TOL) * np.maximum(np.abs(start), F32(rec.ENV_FLOOR))
            fail = chained & (np.abs(prev_end - start) > tol)         # a NaN passes
            if not fail.any() or rounds == max_rounds:
                break
            a = np.where(chained, np.exp(prev_n * ln_att + (L - prev_n) * ln_rel), 1.0)
            b = np.where(chained & (prev_end != start), prev_end.astype(np.float64) - start, 0.0)
            start = (start + _carry_scan(a, b, warps)).astype(F32)
            rounds += 1
        out = _env_run(segs, start)[0].reshape(-1)[:t_len]
        if fail.any():                              # the repair: a serial walk
            k = int(np.argmax(fail))
            out[k * L:] = _env_run(level[None, k * L:t_len], prev_end[k:k + 1])[0][0]
    return out, rounds, bool(fail.any())


@jax.jit
def _jax_envelope(x):
    """The compressor's scan (audio_algebra_tpu/ops/effects.py:97-102)."""
    lt = jnp.moveaxis(jnp.abs(x), -1, 0)

    def step(env, level):
        coeff = jnp.where(level > env, float(A_ATT), float(A_REL))
        env2 = coeff * env + (1 - coeff) * level
        return env2, env2

    return jnp.moveaxis(jax.lax.scan(step, jnp.zeros(lt.shape[1:], lt.dtype), lt)[1], 0, -1)


def _env_f64(x):
    """The float64 walk of one row with the coefficients the kernel is given
    (f32): what remains is the arithmetic's error, not the coefficients'
    rounding (which moves a release by ~1e-5 of the peak over 5,000
    samples, in every f32 implementation alike)."""
    att, rel = float(A_ATT), float(A_REL)
    env, out = 0.0, []
    for lv in np.abs(x.astype(np.float64)).tolist():
        c = att if lv > env else rel
        env = c * env + (1 - c) * lv
        out.append(env)
    return np.asarray(out)


@functools.lru_cache(maxsize=1)
def _env_references():
    """Every kind's serial f32 walk, JAX's scan and the float64 walk."""
    x = _env_inputs()
    serial = _env_run(np.abs(x), np.zeros(len(x)))[0]
    jax_out = np.asarray(_jax_envelope(jnp.asarray(x)))
    return x, serial, jax_out, np.stack([_env_f64(row) for row in x])


def _max_err(got, f64):
    finite = np.isfinite(f64)
    return float(np.abs(got[finite].astype(np.float64) - f64[finite]).max(initial=0.0))


def _env_held(got, serial, f64):
    """NaN exactly where the serial walk has it; elsewhere no further from
    float64 than twice the serial walk (or 1e-6 of the row's peak)."""
    assert np.array_equal(np.isnan(got), np.isnan(serial))
    assert np.array_equal(np.isnan(serial), np.isnan(f64))
    peak = float(np.nanmax(np.abs(f64)))
    limit = max(2 * _max_err(serial, f64), 1e-6 * peak)
    assert _max_err(got, f64) <= limit, (_max_err(got, f64), _max_err(serial, f64), peak)


@pytest.mark.parametrize("chunk_len", [128, 256, 1024])
@pytest.mark.parametrize("kind", ENV_KINDS)
def test_envelope_rounds_model_matches_jax_scan_and_f64(kind, chunk_len):
    """The rounds end within ENV_MAX_ROUNDS carries with no repair, DC within
    2 carries and zeros with none; the result as close to float64 as the
    serial walk allows, and to JAX's f32 scan as twice JAX's own distance
    from float64."""
    x, serial, jax_out, f64 = _env_references()
    r = ENV_KINDS.index(kind)
    got, rounds, repaired = chunked_envelope(x[r], chunk_len)
    assert rounds <= rec.ENV_MAX_ROUNDS and not repaired
    if kind.startswith("dc"):
        assert rounds <= 2
    if kind == "zeros":
        assert rounds == 0 and not got.any()
    _env_held(got, serial[r], f64[r])
    finite = np.isfinite(f64[r])
    assert np.array_equal(np.isnan(jax_out[r]), np.isnan(got))
    own = rel_rms(jax_out[r][finite], f64[r][finite])
    assert rel_rms(got[finite], jax_out[r][finite]) <= max(2 * own, 1e-6)
    if kind == "nan":
        assert np.isnan(got[12345:]).all() and np.isfinite(got[:12345]).all()


@pytest.mark.parametrize("max_rounds", [0, 1, 3])
def test_envelope_repair_walks_from_the_first_failing_chunk(max_rounds):
    """With the carries capped below what the gated row needs, the repair
    walks it serially from the first chunk that failed: the result holds
    as the converged rounds' does."""
    x, serial, _, f64 = _env_references()
    r = ENV_KINDS.index("gate")
    got, rounds, repaired = chunked_envelope(x[r], 256, max_rounds=max_rounds)
    assert rounds == max_rounds and repaired
    _env_held(got, serial[r], f64[r])


@pytest.mark.parametrize("n_chunks,warps", [(2, 1), (31, 1), (33, 1), (128, 1), (300, 2),
                                            (704, 4), (2048, 8)])
def test_envelope_carry_scan_equals_the_serial_carry(n_chunks, warps):
    """The kernel's scan order (lanes by doubling, warps, the blocks' links)
    against one chain d_k = a_k d_{k-1} + b_k in float64: within 1e-12 of
    the largest d, far below the f32 rounding of the starts."""
    rng = np.random.default_rng(n_chunks)
    a = np.exp(-rng.uniform(0.05, 6.0, n_chunks))
    a[0] = 1.0
    b = rng.standard_normal(n_chunks)
    b[0] = 0.0
    serial = np.zeros(n_chunks)
    for k in range(1, n_chunks):
        serial[k] = a[k] * serial[k - 1] + b[k]
    got = _carry_scan(a, b, warps)
    assert np.abs(got - serial).max() <= 1e-12 * np.abs(serial).max()


@pytest.mark.parametrize("rows,t_len,want,blocks", [
    (4, 262144, (128, 2048), (True, 8)),    # the compressor on the xae path: 2 clips x stereo
    (40, 2000, (128, 16), (True, 1)),
    (4, 16036, (128, 126), (True, 1)),      # a ragged last chunk of 36
    (2, 1440000, (2048, 704), (False, 4)),  # a 30 s track at 48 kHz: streamed
    (128, 262144, (512, 512), (True, 2)),   # rows x C capped at MAX_SEGMENTS
    (2048, 65536, (2048, 32), (False, 1)),  # a warp a row
    (4, 96, (96, 1), None),                 # at most MIN_CHUNK: one chunk
    (3000, 4096, (4096, 1), None),          # rows alone fill the card: one chunk
])
def test_envelope_plan(rows, t_len, want, blocks):
    length, chunks = rec.envelope_plan(rows, t_len)
    assert (length, chunks) == want
    if chunks > 1:
        assert length & (length - 1) == 0 and length >= rec.MIN_CHUNK
        assert (chunks - 1) * length < t_len <= chunks * length
        assert chunks <= rec.MAX_ENV_CHUNKS and rows * chunks <= rec.MAX_SEGMENTS
        resident, warps = rec.envelope_blocks(length, chunks)
        assert (resident, warps) == blocks
        assert chunks <= 32 * warps * rec.ENV_MAX_CLUSTER
        smem = 32 * warps * (length + 4) * 4 if resident else warps * rec.ENV_TILE_BYTES
        assert smem <= rec.ENV_SMEM_BYTES


# ------------------------------------------------------------------- R3 ---

def freeverb_ir_warp_scan(feedback, damp, n, sr, spread):
    """R3's chunk loop with the damping chain as the kernel's warp scan, in
    f32: chunks no longer than the shortest delay (at most 256), 32 lanes,
    each a run of 8 samples (zero past the chunk's end), the runs' maps
    composed 2^q at level q with the coefficient (damp^8)^(2^q)."""
    fb, dm = F32(feedback), F32(damp)
    odm = F32(1) - dm
    combs, aps = rec.delay_sizes(sr, spread)
    chunk = min(256, *combs, *aps)
    run = 8
    pw = [F32(1)]
    for _ in range(run):
        pw[0] = F32(pw[0] * dm)
    for q in range(1, 5):
        pw.append(F32(pw[-1] * pw[-1]))
    lanes = np.arange(32)
    a_before = np.ones(32, F32)
    for q in range(5):
        a_before = np.where(lanes >> q & 1, a_before * pw[q], a_before).astype(F32)
    lines = [np.zeros(d, F32) for d in combs]
    apl = [np.zeros(d, F32) for d in aps]
    lasts = [F32(0)] * len(combs)
    ir = np.zeros(n, F32)
    pos = lanes[:, None] * run + np.arange(run)[None, :]          # lane, j
    for i0 in range(0, n, chunk):
        m = min(chunk, n - i0)
        outs = np.zeros((len(combs), chunk), F32)
        for w, d in enumerate(combs):
            slots = (i0 + np.arange(m)) % d
            outs[w, :m] = lines[w][slots]
            u = np.where(pos < m, np.pad(outs[w], (0, 32 * run - chunk))[pos], F32(0)) * odm
            off = np.zeros(32, F32)
            for j in range(run):
                off = off * dm + u[:, j]
            for q in range(5):
                up = np.roll(off, 1 << q)
                off = np.where(lanes >= 1 << q, pw[q] * up + off, off).astype(F32)
            off_before = np.concatenate([[F32(0)], off[:-1]]).astype(F32)
            v = a_before * lasts[w] + off_before
            damped = np.empty((32, run), F32)
            for j in range(run):
                v = v * dm + u[:, j]
                damped[:, j] = v
            lasts[w] = damped.reshape(-1)[chunk - 1]
            inp = np.where(i0 + np.arange(m) == 0, F32(1), F32(0))
            lines[w][slots] = inp + damped.reshape(-1)[:m] * fb
        acc = np.zeros(m, F32)
        for w in range(len(combs)):
            acc = acc + outs[w, :m]
        for k, d in enumerate(aps):
            slots = (i0 + np.arange(m)) % d
            bufout = apl[k][slots].copy()
            apl[k][slots] = acc + bufout * F32(0.5)
            acc = bufout - acc
        ir[i0:i0 + m] = acc
    return ir


@pytest.mark.parametrize("sr", [48000, 44100])
@pytest.mark.parametrize("spread", [0, 23])
def test_freeverb_warp_scan_model_matches_jax(sr, spread):
    fb = F32(0.9) * F32(0.28) + F32(0.7)
    dm = F32(0.5) * F32(0.4)
    model = freeverb_ir_warp_scan(fb, dm, 4096, sr, spread)
    want = np.asarray(jfx.freeverb_ir(float(fb), float(dm), 4096, sr, spread))
    assert rel_rms(model, want) < 1e-6
    assert np.array_equal(freeverb_ir_warp_scan(fb, dm, 1000, sr, spread), model[:1000])
