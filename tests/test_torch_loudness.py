"""The port's BS.1770 loudness against the JAX package's on the CPU: the
K-weighting sections, integrated loudness within 1e-3 LU (the K-weighting
runs on R1's twin, JAX's associative scan), through both gates and the
short-clip path, at 48 kHz and at a redesigned rate; the normalisers."""
import numpy as np
import pytest
import torch

from audio_algebra_tpu.ops import loudness as jl
from audio_algebra_torch.ops import loudness as tl

LU_TOL = 1e-3


def _clip(kind: str, seconds: float, sr: int = 48000, channels: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = 0.1 * rng.standard_normal((channels, n))
    x += 0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 0.5 * t)
    if kind == "quiet_half":            # blocks under the absolute gate (-70 LUFS)
        x[:, : n // 2] *= 1e-4
    elif kind == "relative_gate":       # loud and soft halves: the relative gate drops the soft
        x[:, : n // 2] *= 0.02
    return x.astype(np.float32)


@pytest.mark.parametrize("sr", [48000, 44100])
def test_k_weighting_sections_match_jax(sr):
    np.testing.assert_allclose(tl._k_weighting_sos(sr).numpy(),
                               np.asarray(jl._k_weighting_sos(sr)), rtol=1e-7)


@pytest.mark.parametrize("kind,seconds", [("plain", 2.0), ("quiet_half", 2.0),
                                          ("relative_gate", 2.0), ("plain", 0.25)])
def test_integrated_loudness_matches_jax(kind, seconds):
    x = _clip(kind, seconds)
    got = tl.integrated_loudness(x, device="cpu")
    want = jl.integrated_loudness(x)
    assert abs(got - want) < LU_TOL, (got, want)
    assert got == tl.integrated_loudness(torch.from_numpy(x))     # a tensor: its own device


def test_integrated_loudness_gates_and_shapes():
    """Both gates act (on the port's side; JAX's is held above at these
    shapes): silence alone is under the absolute gate, a soft half moves
    the gated loudness less than its share of the mean square, a mono row
    is a one-channel clip, and channels 3 and 4 weigh 1.41."""
    x = _clip("quiet_half", 2.0)
    assert tl.integrated_loudness(x[:, :x.shape[1] // 4], device="cpu") < -70.0
    loud = tl.integrated_loudness(x[:, x.shape[1] // 2:], device="cpu")
    gated = tl.integrated_loudness(x, device="cpu")
    # ungated, the silent half would halve the mean square (-3.01 LU); the
    # gate drops the silent blocks and keeps the boundary's partly loud ones
    assert loud - 2.5 < gated < loud
    assert tl.integrated_loudness(x[0], device="cpu") == \
        tl.integrated_loudness(x[:1], device="cpu")
    five = np.concatenate([x, x, x[:1]])[:5]
    three = tl.integrated_loudness(five[:3], device="cpu")
    ms = lambda lufs: 10 ** ((lufs + 0.691) / 10)                          # noqa: E731
    assert abs(ms(tl.integrated_loudness(five, device="cpu")) - ms(three)
               - 1.41 * (ms(tl.integrated_loudness(five[3:], device="cpu")))) \
        < 0.05 * ms(three)


def test_integrated_loudness_at_44k1():
    x = _clip("plain", 96000 / 44100, sr=44100, seed=5)
    assert abs(tl.integrated_loudness(x, 44100, device="cpu")
               - jl.integrated_loudness(x, 44100)) < LU_TOL


def test_normalisers_match_jax():
    x = _clip("relative_gate", 2.0, seed=9)
    got, lufs = tl.loudness_normalize(x, -23.0, device="cpu")
    want, jlufs = jl.loudness_normalize(x, -23.0)
    assert abs(lufs - jlufs) < LU_TOL
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert abs(tl.integrated_loudness(got, device="cpu") + 23.0) < 1e-2
    peak, m = tl.maxabs_normalize(x)
    jpeak, jm = jl.maxabs_normalize(x)
    np.testing.assert_array_equal(peak, jpeak)
    assert m == jm


def test_numpy_input_wants_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.integrated_loudness(_clip("plain", 0.5))
