"""The PyTorch port's four spectrogram given models against the JAX
package's on the CPU: encode and decode of SpectrogramAE,
MagSpectrogramAE, MagDPhaseSpectrogramAE and MelSpectrogramAE on a
(1, 2, 6000) clip (zero-padded to 8192 and cropped back), Griffin-Lim fed
JAX's own initial angles. Tolerances: the encodes and exact decodes 1e-5
of the output's peak (f32, only the order of sums differs), 1e-4 for the
phase-increment decode (a cumulative sum). Griffin-Lim
with momentum 0.99 amplifies rounding over its 32 rounds: a 1e-6 relative
change of JAX's own input moves JAX's decode by 2e-4 (Mag) and 2e-2 (Mel)
rel-RMS, so the port is held to rel-RMS under the larger of 1e-3 and
that spread, measured in the test."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu import given_models as jgm
from audio_algebra_tpu.utils.prng import host_split
from audio_algebra_torch import given_models as tgm

REL = 1e-5
DPHASE_REL = 1e-4      # the phase decode is a cumsum over 33 frames, summed in another order
GL_RMS = 1e-3
# the mag-dphase round trip integrates f32 phase increments over the frames,
# so its error grows with length: at 65536 samples (257 frames) JAX's own
# round trip reaches 1.9e-9 rel MSE. chip_smoke.py holds the port to this.
DPHASE_ROUND_TRIP = 1e-8


def _rel_rms(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.fixture(scope="module")
def clip():
    t = np.arange(6000) / 48000
    x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t), 0.3 * np.sin(2 * np.pi * 660 * t)])
    x = x + 0.05 * np.random.default_rng(0).standard_normal(x.shape)
    return x[None].astype(np.float32)


def _angles(jmodel, shape):
    """The initial Griffin-Lim angles the JAX model's next decode draws."""
    _, key = host_split(jmodel._key)
    return np.array(jax.random.uniform(key, shape, dtype=jnp.float32) * 2 * math.pi)


def test_spectrogram_ae_matches_jax(clip):
    jm, tm = jgm.SpectrogramAE(), tgm.SpectrogramAE(device="cpu")
    reps_j, reps_t = jm.encode(clip), tm.encode(clip)
    assert reps_t.shape == (1, 2, 513, 33)
    assert _rel(reps_t.numpy(), reps_j) < REL
    recon = tm.decode(reps_t)
    assert _rel(recon.numpy(), jm.decode(reps_j)) < REL
    assert recon.shape == clip.shape
    assert float(((recon.numpy() - clip) ** 2).mean() / (clip ** 2).mean()) < 1e-9


@pytest.mark.parametrize("cls", ["MagSpectrogramAE", "MelSpectrogramAE"])
def test_griffin_lim_models_match_jax(clip, cls):
    jm, tm = getattr(jgm, cls)(), getattr(tgm, cls)(device="cpu")
    reps_j, reps_t = jm.encode(clip), tm.encode(clip)
    assert _rel(reps_t.numpy(), reps_j) < REL
    angles = _angles(jm, (1, 2, 513, 33))
    want = jm.decode(reps_j)
    got = tm.decode(reps_t, init_angle=torch.from_numpy(angles))
    assert got.shape == clip.shape
    # JAX's spread: the same decode (same key) of its input changed by 1e-6
    jm2 = getattr(jgm, cls)()
    jm2.orig_shape = jm.orig_shape
    nudge = 1 + 1e-6 * np.random.default_rng(1).standard_normal(np.shape(reps_j))
    spread = _rel_rms(jm2.decode(jnp.asarray(np.asarray(reps_j) * nudge.astype(np.float32))),
                      want)
    assert _rel_rms(got.numpy(), want) < max(GL_RMS, spread)


def test_griffin_lim_draws_its_angles_from_the_generator(clip):
    a, b = (tgm.MagSpectrogramAE(device="cpu", n_iter=2, seed=s) for s in (0, 0))
    reps = a.encode(clip)
    b.encode(clip)
    first = a.decode(reps).numpy()
    np.testing.assert_array_equal(first, b.decode(reps).numpy())
    assert not np.array_equal(first, a.decode(reps).numpy())     # fresh angles


def test_mag_dphase_ae_matches_jax(clip):
    jm, tm = jgm.MagDPhaseSpectrogramAE(), tgm.MagDPhaseSpectrogramAE(device="cpu")
    reps_j, reps_t = np.asarray(jm.encode(clip)), tm.encode(clip)
    assert reps_t.shape == (1, 4, 513, 33)
    assert _rel(reps_t[:, :2].numpy(), reps_j[:, :2]) < REL
    recon = tm.decode(reps_t)
    assert _rel(recon.numpy(), jm.decode(reps_j)) < DPHASE_REL
    assert float(((recon.numpy() - clip) ** 2).mean() / (clip ** 2).mean()) < 1e-9


def test_zero_pad_and_match_sizes(clip):
    m = tgm.SpectrogramAE(device="cpu")
    assert m.next_power_of_2(6000) == 8192 and m.next_power_of_2(0) == 1
    assert m.zero_pad_po2(torch.ones(1, 5)).shape == (1, 8)
    m.orig_shape = (1, 2, 6000)
    assert m.match_sizes(torch.ones(1, 2, 8192)).shape == (1, 2, 6000)
    assert m.match_sizes(torch.ones(1, 2, 5000)).shape == (1, 2, 6000)
    reps, recon = m(clip)                    # forward = encode, decode
    assert reps.shape == (1, 2, 513, 33) and recon.shape == clip.shape


def test_mag_dphase_round_trip_at_full_length():
    """The bound of the exact mag-dphase round trip at the chip's length
    (65536 samples, the data recipe of chip_smoke.py's spectrogram phase):
    JAX's round trip and the port's both stay under it."""
    rng = np.random.default_rng(5)
    shape = (4, 2, 65536)
    t = np.arange(shape[-1]) / 48000
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000, (shape[0], 2, 1)) * t)
    x = (x + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    jm, tm = jgm.MagDPhaseSpectrogramAE(), tgm.MagDPhaseSpectrogramAE(device="cpu")
    for out in (np.asarray(jm.decode(jm.encode(x))), tm.decode(tm.encode(x)).numpy()):
        assert float(((out - x) ** 2).mean() / (x ** 2).mean()) < DPHASE_ROUND_TRIP
