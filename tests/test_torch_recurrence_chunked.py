"""Numpy models of the decompositions that R1 and R3 run on the card
(csrc/recurrence.cu), against the JAX package's scans on the CPU.

R1, the chunked time scan: each row's time cut into C chunks of L samples;
every chunk run from zero state for its end state (f32), the chunks' start
states carried in float64 through Phi = A^L (each unit state stepped
through L samples in float64; in two levels, as the carry kernel runs it),
every chunk re-run from its start state (f32). Held against JAX's sequential `_biquad_scan` in f32 and
scipy's float64 `sosfilt`: no further from float64 than twice the
sequential scan's own distance.

R3, the damping chain as a warp scan inside Freeverb's chunk loop: each of
32 lanes steps its run of ceil(chunk / 32) samples from zero, the lanes'
maps (damp^run, offset) composed in the kernel's shuffle order, each run
re-stepped from its true start. Held against JAX's `freeverb_ir`.

The kernels themselves are held against their twins on the card by
chip_smoke.py's recurrence phase and tests/test_torch_kernels_cuda.py.
"""
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
