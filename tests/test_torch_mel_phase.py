"""The PyTorch port's mel and phase coding ops (ops/mel.py, ops/phase.py)
against the JAX package on the CPU: the filterbank and its regularised
pseudo-inverse (equal tables), melspectrogram at the spectrogram models'
and CLAP's settings, inverse_mel_scale, and the magnitude / phase-increment
encode and decode in each init. Tolerances relative to the output's peak:
f32, only the order of sums differs."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_torch.ops import mel as tmel
from audio_algebra_torch.ops import phase as tphase

jmel = importlib.import_module("audio_algebra_tpu.ops.mel")
jphase = importlib.import_module("audio_algebra_tpu.ops.phase")
jstft = importlib.import_module("audio_algebra_tpu.ops.stft")
REL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _signal(shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("args", [(513, 128, 48000, 0.0, None, None),
                                  (513, 64, 48000, 50.0, 14000.0, None),
                                  (129, 8, 48000, 50.0, 14000.0, "slaney")])
def test_filterbank_and_pinv_equal_jax(args):
    np.testing.assert_array_equal(tmel._mel_fb_np(*args), jmel._mel_fb_np(*args))
    np.testing.assert_array_equal(tmel._mel_pinv_np(*args), jmel._mel_pinv_np(*args))


@pytest.mark.parametrize("kw", [dict(), dict(n_mels=64, hop_length=480, f_min=50.0,
                                             f_max=14000.0)])
def test_melspectrogram_matches_jax(kw):
    x = _signal((2, 24000), 0)
    got = tmel.melspectrogram(torch.from_numpy(x), **kw).numpy()
    want = np.asarray(jmel.melspectrogram(jnp.asarray(x), **kw))
    assert _rel(got, want) < REL


def test_inverse_mel_scale_matches_jax():
    mel = np.array(jmel.melspectrogram(jnp.asarray(_signal((1, 2, 8192), 1))))
    got = tmel.inverse_mel_scale(torch.from_numpy(mel), 513).numpy()
    want = np.asarray(jmel.inverse_mel_scale(jnp.asarray(mel), 513))
    assert got.min() >= 0
    assert _rel(got, want) < REL


@pytest.mark.parametrize("use_cos", [False, True])
def test_mag_dphase_encode_matches_jax(use_cos):
    spec = np.array(jstft.stft(jnp.asarray(_signal((1, 2, 8192), 2))))
    got = tphase.mag_dphase_encode(torch.from_numpy(spec), use_cos).numpy()
    want = np.asarray(jphase.mag_dphase_encode(jnp.asarray(spec), use_cos))
    assert got.shape == (1, 4, 513, 33)
    if use_cos:
        # arccos has an infinite slope at +-1, where one f32 rounding of its
        # argument moves the angle by ~5e-4: compare the cosines it inverts
        diff = np.cos(got[:, 2:]) - np.cos(want[:, 2:])
    else:
        # angles near +-pi may land on either side of the cut: mod 2 pi
        diff = np.angle(np.exp(1j * (got[:, 2:] - want[:, 2:])))
    assert np.abs(diff).max() < 1e-4
    assert _rel(got[:, :2], want[:, :2]) < REL


@pytest.mark.parametrize("init", ["true", "zero", "rand"])
def test_mag_dphase_decode_matches_jax(init):
    spec = np.array(jstft.stft(jnp.asarray(_signal((1, 2, 8192), 3))))
    reps = np.array(jphase.mag_dphase_encode(jnp.asarray(spec)))
    noise = np.random.default_rng(4).random((1, 2, 513, 1)).astype(np.float32)
    want = np.asarray(jphase.mag_dphase_decode(jnp.asarray(reps), init)) if init != "rand" \
        else None
    got = tphase.mag_dphase_decode(torch.from_numpy(reps), init,
                                   noise=torch.from_numpy(noise)).numpy()
    if init == "rand":                     # JAX draws the origin; feed both the same
        theta = np.cumsum(np.concatenate([noise * 2 * np.pi, reps[..., 2:, :, 1:]], -1), -1)
        want = reps[:, :2] * np.exp(1j * theta)
    assert _rel(got, want) < 1e-4
    if init == "true":                     # the exact decode
        assert _rel(got, spec) < 1e-4
