"""The PyTorch port's STFT front end (ops/stft.py) and kernel K6's wrapper
(ops/stft_kernel.py) against the JAX package on the CPU: the port's stft
(which takes K6's plain twin on a CPU tensor) against JAX's Pallas kernel
in interpret mode and against JAX's XLA stft, istft, spectrogram in each
power mode, and Griffin-Lim given JAX's initial angles.

Tolerances: the STFT at atol 5e-4 + rtol 1e-4, the JAX package's own for
its kernel (test_pallas_kernels.py); the rest relative to the output's
peak, where only the f32 order of sums differs."""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.ops.pallas.stft_kernel import pallas_stft
from audio_algebra_torch.ops import stft as tstft
from audio_algebra_torch.ops import stft_kernel as tk

jstft = importlib.import_module("audio_algebra_tpu.ops.stft")   # ops/ exports a function `stft`
ATOL, RTOL = 5e-4, 1e-4
REL = 1e-5


def _signal(shape, seed=0):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("shape,n_fft,hop,center", [
    ((2, 16384), 1024, 256, True), ((1, 2, 8192), 512, 128, True),
    ((3, 4096), 1024, 256, True), ((2, 8192), 1024, 256, False),
    # n_fft the JAX kernel takes that are not powers of two: the card's
    # mixed-radix FFT route (tests/test_torch_stft_plan.py models it)
    ((2, 8192), 384, 128, True), ((2, 8192), 640, 128, True),
    ((2, 8192), 1152, 128, True), ((2, 8192), 1408, 128, True)])
def test_stft_matches_jax_kernel_and_xla(shape, n_fft, hop, center):
    x = _signal(shape)
    got = tstft.stft(torch.from_numpy(x), n_fft, hop, center=center).numpy()
    assert got.dtype == np.complex64
    kernel = np.asarray(pallas_stft(jnp.asarray(x), n_fft, hop, center=center,
                                    interpret=True))
    xla = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, center=center))
    for want in (kernel, xla):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_stft_hop_480_matches_jax():
    """CLAP's mel hop: JAX takes XLA (480 is not a multiple of 128 lanes)."""
    x = _signal((1, 48000), 1)
    got = tstft.stft(torch.from_numpy(x), 1024, 480).numpy()
    want = np.asarray(jstft.stft(jnp.asarray(x), 1024, 480))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_stft_routes_through_the_kernel_wrapper(monkeypatch):
    """The default window goes through K6's wrapper, which on the CPU is
    the twin; a custom window takes the plain formulation."""
    seen = []
    monkeypatch.setattr(tk, "stft_fused", lambda *a: seen.append(a) or tk.stft_ref(*a))
    x = torch.from_numpy(_signal((1, 4096), 2))
    tstft.stft(x, 512, 128)
    assert len(seen) == 1
    tstft.stft(x, 512, 128, window=tstft.hann_window(512))
    assert len(seen) == 1
    assert tk.launches == 0          # no CUDA kernel on a CPU tensor


def test_bases_and_window_match_jax():
    np.testing.assert_array_equal(tstft.hann_window(1024).numpy(),
                                  np.asarray(jstft.hann_window(1024)))
    for a, b in zip(tstft._dft_bases(512) + tstft._idft_bases(512),
                    jstft._dft_bases(512) + jstft._idft_bases(512)):
        np.testing.assert_array_equal(a, b)
    padded = tk._padded_bases(1024)
    assert padded.shape == (2, 1024, 576)
    np.testing.assert_array_equal(padded[0, :, :513], jstft._dft_bases(1024)[0])
    assert not padded[:, :, 513:].any()


@pytest.mark.parametrize("length", [None, 16000, 17000])
def test_istft_matches_jax(length):
    x = _signal((2, 16384), 3)
    spec = np.array(jstft.stft(jnp.asarray(x)))
    got = tstft.istft(torch.from_numpy(spec), length=length).numpy()
    want = np.asarray(jstft.istft(jnp.asarray(spec), length=length))
    assert _rel(got, want) < REL
    if length is None:                     # the exact round trip
        assert np.mean((got - x) ** 2) / np.mean(x ** 2) < 1e-9


@pytest.mark.parametrize("power", [None, 1.0, 2.0, 0.5, 1.5])
def test_spectrogram_matches_jax(power):
    x = _signal((2, 8192), 4)
    got = tstft.spectrogram(torch.from_numpy(x), power=power).numpy()
    want = np.asarray(jstft.spectrogram(jnp.asarray(x), power=power))
    assert _rel(got, want) < REL


def test_griffin_lim_matches_jax_given_its_angles():
    x = _signal((1, 8192), 5)
    mag2 = np.array(jstft.spectrogram(jnp.asarray(x), power=2.0))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jstft.griffin_lim(jnp.asarray(mag2), n_iter=8, length=8192, key=key))
    angles = np.array(jax.random.uniform(key, mag2.shape, dtype=jnp.float32) * 2 * math.pi)
    got = tstft.griffin_lim(torch.from_numpy(mag2), n_iter=8, length=8192,
                            init_angle=torch.from_numpy(angles)).numpy()
    assert got.shape == want.shape == (1, 8192)
    assert _rel(got, want) < 1e-4


def test_overlap_add_needs_hop_dividing_n_fft():
    with pytest.raises(NotImplementedError, match="n_fft % hop"):
        tstft._overlap_add(torch.zeros(1, 4, 1024), 480)


def test_stft_fused_rejects_signals_without_a_frame():
    """A centred clip shorter than the pad has its frames, as in JAX (the
    reflect padding reflects again); an uncentred one shorter than n_fft
    has none, as JAX's frame_signal has none."""
    x = _signal((1, 100), 6)
    got = tk.stft_fused(torch.from_numpy(x), 1024, 256).numpy()
    want = np.asarray(jstft.stft(jnp.asarray(x), 1024, 256))
    assert got.shape == want.shape == (1, 513, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="no frame"):
        tk.stft_fused(torch.zeros(1, 100), 1024, 256, center=False)


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (256, 64)])
def test_stft_gradient_matches_jax_grad(n_fft, hop):
    """The STFT is linear, so K6's backward is the twin's VJP: the gradient
    of sum(|stft(x)|^2 w) through the port equals jax.grad of JAX's XLA
    stft, in f32."""
    x = _signal((2, 4096), 3)
    spec_shape = tstft.stft(torch.from_numpy(x), n_fft, hop).shape
    w = np.random.default_rng(4).random(spec_shape).astype(np.float32)

    def loss(a):
        return jnp.sum(jnp.square(jnp.abs(jstft.stft(a, n_fft, hop))) * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    leaf = torch.from_numpy(x).requires_grad_()
    (tstft.stft(leaf, n_fft, hop).abs().square() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), want, atol=1e-4 * np.abs(want).max(),
                               rtol=1e-4)
