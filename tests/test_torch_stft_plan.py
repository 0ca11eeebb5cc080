"""K6's route planner (ops/stft_kernel.plan) and a numpy model of the
mixed-radix Stockham schedule that csrc/stft.cu runs on the FFT route.

The planner gives the FFT to every even n_fft from 16 to 8192 whose half m
has no prime factor above 13, powers of two keep their radix-2 / radix-4
then radix-8 stages, and everything else takes the DFT product. The model
follows the kernel stage by stage, driven by the planner's radices: butterfly
i of a frame (k = i mod p) reads points i + r m / R, multiplies point r by
tw[r k n_fft / (p R)], takes its R-point DFT (odd radices by the kernel's
pairing of points n and R - n, with f32 roots) and writes output s to
(i - k) R + k + s p; then the real split into the m + 1 bins, in pairs, as
the kernel stores them. All in f32 (complex64), from the wrapper's f32
twiddle table.

Tolerances: against np.fft.rfft of the same windowed frames (float64), 1e-5
of the peak (f32 rounding over log m stages); against the JAX package's
Pallas kernel in interpret mode, atol 5e-4 + rtol 1e-4, the JAX package's
own for its kernel (test_pallas_kernels.py), as tests/test_torch_stft.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from audio_algebra_tpu.ops.pallas.stft_kernel import pallas_stft
from audio_algebra_torch.ops import stft_kernel as tk
from audio_algebra_torch.ops.stft import hann_window

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


FFT_N_FFT = [n for n in range(16, 8193, 2) if _smooth(n // 2)]


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


def stockham_model(frames: np.ndarray, n_fft: int) -> np.ndarray:
    """(F, n_fft) windowed f32 frames -> (n_fft / 2 + 1, F) complex64 bins,
    through the stages of tk.plan(n_fft) as the kernel runs them."""
    route, radices = tk.plan(n_fft)
    assert route == "fft"
    m = n_fft // 2
    tw = tk._twiddles(n_fft)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    z = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)     # (F, m)
    p = 1
    for radix in radices:
        q = m // radix
        i = np.arange(q)
        k = i % p
        step = n_fft // (p * radix)
        u = np.stack([z[:, i + r * q] for r in range(radix)])              # (R, F, q)
        if p > 1:
            u = u * np.stack([tw[r * k * step] for r in range(radix)])[:, None, :]
        y = _butterfly(u)
        out = np.empty_like(z)
        for r in range(radix):
            out[:, (i - k) * radix + k + r * p] = y[r]
        z = out
        p *= radix
    assert p == m
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


def test_plan_gives_the_fft_to_every_smooth_even_n_fft():
    """Every even n_fft in [16, 8192] with a 13-smooth half takes the FFT,
    and its radices multiply to the half; nothing else does."""
    for n_fft in range(1, 8200):
        plan = tk.plan(n_fft)
        want = n_fft % 2 == 0 and 16 <= n_fft <= 8192 and _smooth(n_fft // 2)
        assert (plan.route == "fft") == want, (n_fft, plan)
        if want:
            assert int(np.prod(plan.radices)) == n_fft // 2
            assert set(plan.radices) <= {2, 3, 4, 5, 7, 8, 11, 13}
            assert len(plan.radices) <= 12           # FFT_MAX_STAGES in stft.cu
        else:
            assert plan.radices == ()
    # every n_fft the JAX package's Pallas kernel takes (multiples of 128
    # whose bases fit its 10 MB VMEM gate: up to 1408), and common settings
    # outside it
    for n_fft in (*range(128, 1409, 128), 400, 960, 1000, 1536, 1920, 8192):
        assert tk.plan(n_fft).route == "fft", n_fft


@pytest.mark.parametrize("n_fft", [1001, 8191, 1018, 2 * 17, 2 * 4093, 8194, 16384, 14])
def test_plan_sends_the_rest_to_the_dft_product(n_fft):
    """Odd n_fft, a prime factor of the half above 13 (17, 509, 4093), above
    8192, or below 16."""
    assert tk.plan(n_fft) == tk.StftPlan("dft", ())


def test_plan_keeps_the_power_of_two_schedule():
    """Powers of two: one radix-2 or radix-4 stage where log2 m is not a
    multiple of 3, then radix-8 stages (the schedule the kernel ran before
    odd radices)."""
    for log_n in range(4, 14):
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
