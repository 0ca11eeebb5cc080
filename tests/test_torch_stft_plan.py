"""K6's route planner (ops/stft_kernel.plan) and numpy models of the
transforms csrc/stft.cu runs on its FFT, chirp-z and cluster routes.

The planner gives the FFT to every even n_fft from 16 to 8192 whose half m
has no prime factor above 13, powers of two keep their radix-2 / radix-4
then radix-8 stages; every other n_fft from 16 takes the L-point DFT
(L = m, or n_fft when odd) as a power-of-two transform of M points (M = L,
or M >= 2 L - 1 through Bluestein's chirp-z), in one block up to 4096
points (the chirp route) or across a cluster of M / 4096 CTAs up to 65536
(the cluster route); n_fft below 16 and larger frames take the DFT
product. The Stockham model follows the FFT route's kernel stage by stage,
driven by the planner's radices: butterfly i of a frame (k = i mod p) reads
points i + r m / R, multiplies point r by tw[r k n_fft / (p R)], takes its
R-point DFT (odd radices by the kernel's pairing of points n and R - n,
with f32 roots) and writes output s to (i - k) R + k + s p; then the real
split into the m + 1 bins, in pairs, as the kernel stores them. The chirp
and cluster models run the same power-of-two stages, the wrapper's f32
chirp and B' tables, the cluster's four-step split (DIF for the first
transform, DIT for the second) and the split of packed frames. All in f32
(complex64), from the wrapper's f32 tables.

Tolerances: against np.fft.rfft of the same windowed frames (float64), 1e-5
of the peak (f32 rounding over log m stages); against the JAX package's
Pallas kernel in interpret mode or its XLA stft, atol 5e-4 + rtol 1e-4, the
JAX package's own for its kernel (test_pallas_kernels.py), as
tests/test_torch_stft.py."""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest

from audio_algebra_tpu.ops.pallas.stft_kernel import pallas_stft
from audio_algebra_torch.ops import stft_kernel as tk
from audio_algebra_torch.ops.stft import hann_window

jstft = importlib.import_module("audio_algebra_tpu.ops.stft")   # ops/ exports a function `stft`

ATOL, RTOL = 5e-4, 1e-4
REL = 1e-5
PRIMES = (2, 3, 5, 7, 11, 13)


def _factors(m: int) -> list[int]:
    out, p = [], 2
    while m > 1:
        while m % p == 0:
            out.append(p)
            m //= p
        p += 1
    return out


def _smooth(m: int) -> bool:
    return all(f <= 13 for f in _factors(m))


FFT_N_FFT = [n for n in range(16, 8192, 2) if _smooth(n // 2)]   # 8192: the cluster route


def _butterfly(u: np.ndarray) -> np.ndarray:
    """The R-point forward DFT of u (R, ...) in complex64: a DFT matrix for
    2, 4, 8 (roots 1, -i, sqrt 1/2), the kernel's pairing for odd R."""
    radix = u.shape[0]
    if radix % 2 == 0:
        w = np.exp(-2j * np.pi * np.outer(np.arange(radix), np.arange(radix)) / radix)
        return np.tensordot(w.astype(np.complex64), u, axes=1).astype(np.complex64)
    half = (radix - 1) // 2
    j = np.arange(1, half + 1)
    c = np.cos(2 * np.pi * j / radix).astype(np.float32)
    s = np.sin(2 * np.pi * j / radix).astype(np.float32)
    tp = [u[n] + u[radix - n] for n in range(1, half + 1)]
    tm = [u[n] - u[radix - n] for n in range(1, half + 1)]
    y = np.empty_like(u)
    y[0] = u[0] + sum(tp)
    for k in range(1, half + 1):
        a, b = u[0].copy(), np.zeros_like(u[0])
        for n in range(1, half + 1):
            jj = (n * k) % radix
            idx = jj if jj <= half else radix - jj
            sj = s[idx - 1] if jj <= half else -s[idx - 1]
            a = a + tp[n - 1] * c[idx - 1]
            b = b + tm[n - 1] * sj
        y[k] = a - 1j * b
        y[radix - k] = a + 1j * b
    return y.astype(np.complex64)


def stockham_stages(z: np.ndarray, radices) -> np.ndarray:
    """The m-point FFT over the last axis of z (..., m) in complex64 through
    the given mixed-radix Stockham stages as the kernels run them, twiddles
    from the f32 table of 2 m entries."""
    m = z.shape[-1]
    tw = tk._twiddles(2 * m)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    p = 1
    for radix in radices:
        q = m // radix
        i = np.arange(q)
        k = i % p
        step = 2 * m // (p * radix)
        u = np.stack([z[..., i + r * q] for r in range(radix)])            # (R, ..., q)
        if p > 1:
            w = np.stack([tw[r * k * step] for r in range(radix)])
            u = u * w.reshape((radix,) + (1,) * (z.ndim - 1) + (q,))
        y = _butterfly(u)
        out = np.empty_like(z)
        for r in range(radix):
            out[..., (i - k) * radix + k + r * p] = y[r]
        z = out
        p *= radix
    assert p == m
    return z


def stockham_model(frames: np.ndarray, n_fft: int) -> np.ndarray:
    """(F, n_fft) windowed f32 frames -> (n_fft / 2 + 1, F) complex64 bins,
    through the stages of tk.plan(n_fft) as the kernel runs them."""
    route, radices = tk.plan(n_fft)
    assert route == "fft"
    m = n_fft // 2
    tw = tk._twiddles(n_fft)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    z = stockham_stages((frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64), radices)
    bins = np.empty((frames.shape[0], m + 1), np.complex64)
    for k in range(m // 2 + 1):
        zk, cz = z[:, k], np.conj(z[:, (m - k) % m])
        a = np.complex64(0.5) * (zk + cz)
        b = np.complex64(-0.5j) * (zk - cz)
        wb = tw[k] * b
        bins[:, k] = a + wb
        if 2 * k != m:
            bins[:, m - k] = np.conj(a - wb)
    return bins.T


def _windowed_frames(x: np.ndarray, n_fft: int, hop: int, center: bool) -> np.ndarray:
    """(rows, F, n_fft) frames of the reflect-padded rows, times the
    window in f32, as the kernel forms them."""
    if center:
        x = np.pad(x, ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")
    n_frames = 1 + (x.shape[-1] - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return (x[:, idx] * hann_window(n_fft).numpy()).astype(np.float32)


def _expected_route(n_fft: int) -> tuple[str, int]:
    """The route and transform points the planner should give: the FFT for
    an even n_fft in [16, 8192) with a 13-smooth half; else, from 16, the
    L-point DFT as an M-point power-of-two transform (M = L for a power of
    two L of an even n_fft, else the least power of two >= 2 L - 1), on
    the chirp route up to 4096 points (8192's 4096 points of its own, one
    frame a block there, on the cluster route) and the cluster route up to
    65536 (an even n_fft above 8192 whose 13-smooth half splits into 2 or 4
    parts of at most 4096 points there without chirp); the DFT product
    below 16 and beyond."""
    if n_fft < 16:
        return "dft", 0
    if n_fft % 2 == 0 and n_fft < 8192 and _smooth(n_fft // 2):
        return "fft", n_fft // 2
    length = n_fft // 2 if n_fft % 2 == 0 else n_fft
    if n_fft % 2 == 0 and _smooth(length) and length & (length - 1) and any(
            length % f == 0 and length // f <= 4096 for f in (2, 4)):
        return "cluster", length                     # mixed-radix parts, no chirp
    points = length if n_fft % 2 == 0 and length & (length - 1) == 0 else \
        1 << math.ceil(math.log2(2 * length - 1))
    if points <= 4096 and n_fft != 8192:
        return "chirp", points
    return ("cluster", points) if points <= 65536 else ("dft", 0)


def test_plan_gives_the_fft_to_every_smooth_even_n_fft():
    """Every even n_fft in [16, 8192) with a 13-smooth half takes the FFT,
    and its radices multiply to the half; nothing else does. From 1 to
    20000 only n_fft below 16 take the DFT product; every other n_fft takes
    the chirp or cluster route, whose radices multiply to the transform's
    points."""
    for n_fft in range(1, 20001):
        plan = tk.plan(n_fft)
        route, points = _expected_route(n_fft)
        assert plan.route == route, (n_fft, plan)
        assert (plan.route == "dft") == (n_fft < 16), n_fft
        if route == "fft":
            assert int(np.prod(plan.radices)) == n_fft // 2
            assert set(plan.radices) <= {2, 3, 4, 5, 7, 8, 11, 13}
            assert len(plan.radices) <= 12           # FFT_MAX_STAGES in stft.cu
        elif route == "dft":
            assert plan.radices == ()
        else:
            assert tk.plan_points(plan) == points
            if tk.mixed_cluster(plan):               # 2 or 4 parts, each's stages
                assert plan.radices[0] in (2, 4) and points // plan.radices[0] <= 4096
                assert set(plan.radices[1:]) <= {2, 3, 4, 5, 7, 8, 11, 13}
            elif route == "cluster":                 # C CTAs, then 4096 points each
                assert plan.radices[1:] == (8, 8, 8, 8) and plan.radices[0] in (1, 2, 4, 8, 16)
    # every n_fft the JAX package's Pallas kernel takes (multiples of 128
    # whose bases fit its 10 MB VMEM gate: up to 1408), and common settings
    # outside it
    for n_fft in (*range(128, 1409, 128), 400, 960, 1000, 1536, 1920, 6144, 8190):
        assert tk.plan(n_fft).route == "fft", n_fft
    # the largest frames: powers of two to 131072, other even n_fft to
    # 65536, odd to 32767; beyond, the DFT product
    for n_fft, route in ((8192, "cluster"), (131072, "cluster"), (65536, "cluster"),
                         (65534, "cluster"),
                         (32767, "cluster"), (32769, "dft"), (65538, "dft"),
                         (262144, "dft"), (15, "dft"), (14, "dft")):
        assert tk.plan(n_fft).route == route, n_fft


@pytest.mark.parametrize("n_fft,route", [
    (1001, "chirp"), (8191, "cluster"), (1018, "chirp"), (2 * 17, "chirp"),
    (2 * 4093, "cluster"), (8194, "cluster"), (16384, "cluster"), (14, "dft")])
def test_plan_sends_the_rest_to_the_dft_product(n_fft, route):
    """Odd n_fft, a prime factor of the half above 13 (17, 509, 4093), above
    8192, or below 16: the chirp-z route where the transform fits one
    block, the cluster route where it does not, the DFT product below 16."""
    assert tk.plan(n_fft).route == route
    assert _expected_route(n_fft)[0] == route


def test_plan_keeps_the_power_of_two_schedule():
    """Powers of two: one radix-2 or radix-4 stage where log2 m is not a
    multiple of 3, then radix-8 stages (the schedule the kernel ran before
    odd radices); 8192 runs the same four radix-8 stages of 4096 points on
    the cluster route, one CTA a frame."""
    assert tk.plan(8192) == tk.StftPlan("cluster", (1, 8, 8, 8, 8))
    for log_n in range(4, 13):
        log_m = log_n - 1
        head = {0: [8], 1: [2], 2: [4]}[log_m % 3]
        p = head[0]
        stages = list(head)
        while p < 1 << log_m:
            stages.append(8)
            p *= 8
        assert tk.plan(1 << log_n).radices == tuple(stages), log_n


@pytest.mark.parametrize("largest", PRIMES)
def test_stockham_model_matches_rfft(largest):
    """The model of the kernel's schedule against np.fft.rfft for every
    planned n_fft whose half has `largest` as its largest prime factor."""
    rng = np.random.default_rng(largest)
    n_ffts = [n for n in FFT_N_FFT if max(_factors(n // 2)) == largest]
    assert n_ffts
    for n_fft in n_ffts:
        frames = (0.5 * rng.standard_normal((3, n_fft))).astype(np.float32)
        got = stockham_model(frames, n_fft)
        want = np.fft.rfft(frames.astype(np.float64), axis=-1).T
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < REL, (n_fft, tk.plan(n_fft), err)


@pytest.mark.parametrize("n_fft,hop", [(384, 128), (640, 128), (1152, 128), (1408, 128)])
def test_stockham_model_matches_jax_kernel(n_fft, hop):
    """Non-power-of-two n_fft that the JAX package's Pallas kernel takes
    (multiples of 128), in interpret mode, against the model of the
    kernel's FFT on the same rows."""
    x = (0.5 * np.random.default_rng(n_fft).standard_normal((2, 8192))).astype(np.float32)
    want = np.asarray(pallas_stft(jnp.asarray(x), n_fft, hop, center=True, interpret=True))
    got = np.stack([stockham_model(f, n_fft) for f in _windowed_frames(x, n_fft, hop, True)])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ---- the chirp-z and cluster routes ----------------------------------------
# Both take the L-point DFT (L = tk.dft_length(n_fft)) of z, the packed even
# and odd samples of a frame (even n_fft) or two frames packed as real and
# imaginary parts (odd n_fft), as a power-of-two transform of M points.


def _c64(table: np.ndarray) -> np.ndarray:
    return (table[..., 0] + 1j * table[..., 1]).astype(np.complex64)


def pow2_model(z: np.ndarray) -> np.ndarray:
    """The forward FFT over the last axis (2^k points) of z (..., M) through
    the kernels' power-of-two stages (`tk._pow2_radices`)."""
    return stockham_stages(z, tk._pow2_radices(z.shape[-1].bit_length() - 1))


def _packed(frames: np.ndarray, n_fft: int) -> np.ndarray:
    """(F, n_fft) windowed frames -> (T, L) complex64 transforms."""
    if n_fft % 2 == 0:
        return (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)
    if len(frames) % 2:
        frames = np.concatenate([frames, np.zeros_like(frames[:1])])
    return (frames[0::2] + 1j * frames[1::2]).astype(np.complex64)


def _split_model(z: np.ndarray, n_fft: int, n_frames: int) -> np.ndarray:
    """(T, L) spectra -> (n_fft / 2 + 1, F) bins as the kernels' store_bins
    takes them: the real split of the packed samples (even n_fft) or the two
    packed frames apart (odd)."""
    length = z.shape[-1]
    k = np.arange(length // 2 + 1)
    zk, cz = z[:, k], np.conj(z[:, (length - k) % length])
    if n_fft % 2:
        a = np.complex64(0.5) * (zk + cz)
        b = np.complex64(-0.5j) * (zk - cz)
        return np.stack([a, b], axis=1).reshape(-1, len(k))[:n_frames].T
    tw = _c64(tk._twiddles(n_fft))
    a = np.complex64(0.5) * (zk + cz)
    wb = tw[k] * (np.complex64(-0.5j) * (zk - cz))
    bins = np.empty((len(z), length + 1), np.complex64)
    bins[:, k] = a + wb
    bins[:, length - k] = np.conj(a - wb)
    bins[:, k] = a + wb                    # k = L / 2 writes X[L / 2] once, as the kernel
    return bins[:n_frames].T


def _chirp_input(frames: np.ndarray, n_fft: int, points: int):
    """The zero-padded chirp-multiplied transforms (T, M) and the tables."""
    length = tk.dft_length(n_fft)
    chirp, bhat = (_c64(t) for t in tk._chirp_tables(n_fft, points))
    a = np.zeros((len(_packed(frames, n_fft)), points), np.complex64)
    a[:, :length] = _packed(frames, n_fft) * chirp
    return a, chirp, bhat


def chirp_model(frames: np.ndarray, n_fft: int) -> np.ndarray:
    """(F, n_fft) windowed f32 frames -> (n_fft / 2 + 1, F) complex64 bins
    through the chirp route as the kernel runs it: a = z w zero-padded to M,
    A = FFT(a), R = FFT(conj(A B')), Z = w conj R, the split."""
    route, radices = tk.plan(n_fft)
    assert route == "chirp"
    points, length = tk.plan_points(tk.plan(n_fft)), tk.dft_length(n_fft)
    a, chirp, bhat = _chirp_input(frames, n_fft, points)
    r = pow2_model(np.conj(pow2_model(a) * bhat))
    return _split_model(chirp * np.conj(r[:, :length]), n_fft, len(frames))


def _dft_across(u: np.ndarray, axis: int) -> np.ndarray:
    """The C-point DFT over `axis` in complex64 (the cluster's DFT across
    its CTAs)."""
    c = u.shape[axis]
    w = np.exp(-2j * np.pi * np.outer(np.arange(c), np.arange(c)) / c).astype(np.complex64)
    return np.moveaxis(np.tensordot(w, np.moveaxis(u, axis, 0), axes=1), 0, axis
                       ).astype(np.complex64)


def cluster_model(frames: np.ndarray, n_fft: int, part: int = 4096,
                  points: int | None = None) -> np.ndarray:
    """(F, n_fft) windowed f32 frames -> (n_fft / 2 + 1, F) complex64 bins
    through the cluster route's four-step split with C = M / part CTAs of
    `part` points (4096 on the card, or the plan's mixed-radix part; a
    smaller part models a small cluster at a small n_fft). DIF: the C-point
    DFTs across the CTAs of x[part n1 + p], times W_M^(p k1), then each
    CTA's FFT (power-of-two stages, or the plan's mixed radices): X[k1 + C
    k2] at CTA k1, position k2. A chirp-z length: A by DIF, conj(A B') in
    that layout, R by DIT (each CTA's FFT of its points c + C p, W_M^(c kp),
    the DFTs across), Z = w conj R."""
    stages = None
    if points is None:
        plan = tk.plan(n_fft)
        points = tk.plan_points(plan)
        if tk.mixed_cluster(plan):
            part, stages = points // plan.radices[0], plan.radices[1:]
    length = tk.dft_length(n_fft)
    c = points // part
    tw_n = _c64(tk._twiddles(points))
    p = np.arange(part)
    if length == points:
        a = _packed(frames, n_fft)
    else:
        a, chirp, bhat = _chirp_input(frames, n_fft, points)
    y = _dft_across(a.reshape(-1, c, part), 1)                           # [t, k1, p]
    y = y * tw_n[np.outer(np.arange(c), p)]
    y = stockham_stages(y, stages) if stages else pow2_model(y)         # X[k1 + C k2]
    if length == points:
        return _split_model(y.transpose(0, 2, 1).reshape(-1, points), n_fft, len(frames))
    v = np.conj(y * bhat[np.arange(c)[:, None] + c * p[None, :]])        # x'[c + C p]
    v = pow2_model(v) * tw_n[np.outer(np.arange(c), p)]                 # [t, c, kp]
    r = _dft_across(v, 1).reshape(-1, points)                           # X[kp + part kc]
    return _split_model(chirp * np.conj(r[:, :length]), n_fft, len(frames))


def _rfft_err(model, n_fft: int, seed: int, **kw) -> float:
    frames = (0.5 * np.random.default_rng(seed).standard_normal((3, n_fft))).astype(np.float32)
    got = model(frames, n_fft, **kw)
    want = np.fft.rfft(frames.astype(np.float64), axis=-1).T
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n_fft", [1018, 1102, 999, 1001, 34, 17, 2018, 2047])
def test_chirp_model_matches_rfft(n_fft):
    """The chirp route's transform (even n_fft: a half with a prime factor
    above 13; odd: two frames a transform, three frames leave one alone)
    against np.fft.rfft."""
    assert tk.plan(n_fft).route == "chirp"
    err = _rfft_err(chirp_model, n_fft, n_fft)
    assert err < REL, (n_fft, tk.plan(n_fft), err)


@pytest.mark.parametrize("n_fft", [16384, 10000, 8194, 4097, 2049, 20001, 8192, 24000, 9000])
def test_cluster_model_matches_rfft(n_fft):
    """The cluster route on one to three frames: 16384 (no chirp, 2 CTAs),
    8194 (even chirp-z, 4 CTAs), 4097 and 2049 (odd, 4 and 2 CTAs), 20001
    (16 CTAs), 8192 (one CTA, no exchange), and mixed-radix parts without
    chirp: 10000 (2 x 2500), 24000 (4 x 3000), 9000 (2 x 2250) against
    np.fft.rfft."""
    assert tk.plan(n_fft).route == "cluster"
    err = _rfft_err(cluster_model, n_fft, n_fft)
    assert err < REL, (n_fft, tk.plan(n_fft), err)


@pytest.mark.parametrize("n_fft,part,points", [(2048, 256, 1024), (1018, 256, 1024),
                                               (999, 512, 2048)])
def test_small_cluster_model_matches_rfft(n_fft, part, points):
    """The four-step split's index math at 4 CTAs of a smaller part: a
    power-of-two half without chirp, an even and an odd chirp-z length."""
    assert _rfft_err(cluster_model, n_fft, n_fft + part, part=part, points=points) < REL


def _jax_case(n_fft, hop, t_len, rows=2):
    x = (0.5 * np.random.default_rng(n_fft + hop).standard_normal((rows, t_len))
         ).astype(np.float32)
    want = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, center=True))
    return _windowed_frames(x, n_fft, hop, True), want


@pytest.mark.parametrize("n_fft,hop", [(1018, 250), (1102, 441), (999, 250), (1001, 160),
                                       (34, 8)])
def test_chirp_model_matches_jax(n_fft, hop):
    """The chirp route's model against the JAX package's stft (its matmul
    route: these n_fft are outside its Pallas kernel) on the same rows."""
    frames, want = _jax_case(n_fft, hop, 4 * n_fft + 77)
    got = np.stack([chirp_model(f, n_fft) for f in frames])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_fft,hop,part,points", [(8194, 4096, 4096, None),
                                                   (4097, 1024, 4096, None),
                                                   (2048, 512, 256, 1024),
                                                   (9000, 4500, 4096, None)])
def test_cluster_model_matches_jax(n_fft, hop, part, points):
    """The cluster route's model against the JAX package's stft: one large
    frame and its neighbours at 4 CTAs of 4096 points (8194 / 4096 even
    chirp-z, 4097 / 1024 odd), the power-of-two four-step at 4 CTAs of
    256 points (2048 / 512), and 9000 / 4500 on 2 mixed-radix parts of
    2250 points."""
    frames, want = _jax_case(n_fft, hop, n_fft // 2 + 3, rows=1)
    got = np.stack([cluster_model(f, n_fft, part, points) for f in frames])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
