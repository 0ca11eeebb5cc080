"""The port's effect bank and traced filters against the JAX package's, on
the CPU (the recurrences take their twins): every effect of EFFECTS at 3
knobs of its sweep on (2, 4096) audio against JAX's `apply_effect`, the
batched sweep against K single-knob calls, Freeverb against the JUCE
recurrence in float64, and `biquad_coeffs`, `butter_sos` and `sosfilt`
(against both JAX methods).

Tolerances (rel-RMS over the sweep): Clean, TimeReverse, Gain, Distortion,
Delay and Chorus 1e-5 (elementwise maps; Chorus's f32 sine may differ by an
ulp, which moves a fractional delay); the filters, the phaser, the
compressor and the reverb 1e-4 (recurrences and an FFT convolution in
another order); PitchShift 1e-3 (its phase cumsum amplifies rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.ops import effects as jfx
from audio_algebra_tpu.ops import filters as jflt
from audio_algebra_torch.ops import effects as tfx
from audio_algebra_torch.ops import filters as tflt
from test_effects import _np_freeverb_stereo, _np_tpt_filter

TOL = {"Clean": 1e-5, "TimeReverse": 1e-5, "Gain": 1e-5, "Distortion": 1e-5,
       "Delay": 1e-5, "Chorus": 1e-5, "HighpassFilter": 1e-4, "LowpassFilter": 1e-4,
       "Phaser": 1e-4, "Compressor": 1e-4, "Reverb": 1e-4, "PitchShift": 1e-3}
SR = 48000


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30)))


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(7)
    t = np.arange(4096) / SR
    x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(4096),
                  0.3 * np.sin(2 * np.pi * 1765 * t) + 0.1 * rng.standard_normal(4096)])
    return x.astype(np.float32)


def test_registry_and_sweeps_match_jax():
    assert list(tfx.EFFECTS) == list(jfx.EFFECTS)
    for name, (_, knob, lo, hi, log) in tfx.EFFECTS.items():
        assert jfx.EFFECTS[name][1:] == (knob, lo, hi, log)
        np.testing.assert_array_equal(tfx.knob_sweep(name, 32), jfx.knob_sweep(name, 32))


@pytest.mark.parametrize("name", list(jfx.EFFECTS))
def test_effect_sweep_matches_jax(clip, name):
    knobs = jfx.knob_sweep(name, 3)
    static = name in tfx.STATIC_KNOB
    sweep = knobs if static else torch.tensor(knobs, dtype=torch.float32)
    got = tfx.apply_effect(name, torch.from_numpy(clip), sweep, SR)
    want = np.stack([np.asarray(jfx.apply_effect(
        name, jnp.asarray(clip), float(k) if static else jnp.float32(k), SR)) for k in knobs])
    assert got.shape == (3, 2, 4096)
    assert rel_rms(got, want) <= TOL[name]
    # the batched sweep is K calls of one knob each
    for i, k in enumerate(knobs):
        one = tfx.apply_effect(name, torch.from_numpy(clip), float(k), SR)
        assert one.shape == clip.shape
        np.testing.assert_allclose(one.numpy(), got[i].numpy(), rtol=1e-6, atol=1e-7)


def test_sweep_takes_a_batch_of_clips(clip):
    """(K,) knobs over (B, C, T) -> (K, B, C, T), each clip as alone."""
    batch = torch.from_numpy(np.stack([clip, clip[::-1].copy() * 0.5]))
    knobs = torch.tensor([0.2, 0.7])
    for name in ("Reverb", "Compressor", "Phaser", "LowpassFilter", "Delay", "Chorus"):
        y = tfx.apply_effect(name, batch, knobs * (10 if "Filter" in name else 1), SR)
        assert y.shape == (2, 2, 2, 4096)
        for b in range(2):
            alone = tfx.apply_effect(name, batch[b], knobs * (10 if "Filter" in name else 1), SR)
            np.testing.assert_allclose(y[:, b].numpy(), alone.numpy(), rtol=1e-5, atol=1e-6)


def test_reverb_matches_juce_recurrence_in_f64():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 2048)) * 0.3).astype(np.float32)
    for room in (0.2, 0.8):
        want = _np_freeverb_stereo(x.astype(np.float64), room)
        got = tfx.reverb(torch.from_numpy(x), room).numpy()
        assert rel_rms(got, want) < 1e-4


def test_tpt_filters_match_juce_recurrence_in_f64(clip):
    for kind, fn in (("lowpass", tfx.lowpass_filter), ("highpass", tfx.highpass_filter)):
        want = _np_tpt_filter(clip.astype(np.float64), 800.0, SR, kind)
        assert rel_rms(fn(torch.from_numpy(clip), 800.0).numpy(), want) < 1e-5


@pytest.mark.parametrize("kind", ["lowpass", "highpass", "bandpass", "notch", "peak",
                                  "lowshelf", "highshelf"])
def test_biquad_coeffs_match_jax(kind):
    cut = np.array([60.0, 950.0, 7000.0], np.float32)
    b, a = tflt.biquad_coeffs(kind, torch.from_numpy(cut), SR, q=0.9, gain_db=4.5)
    jb, ja = jflt.biquad_coeffs(kind, jnp.asarray(cut), SR, q=0.9, gain_db=4.5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("order,cutoff,btype", [
    (4, 1000.0, "lowpass"), (3, 250.0, "highpass"), (4, (300.0, 3000.0), "bandpass"),
    (4, (500.0, 1500.0), "bandstop")])
def test_butter_sos_matches_jax(order, cutoff, btype):
    got = tflt.butter_sos(order, cutoff, SR, btype)
    want = jflt.butter_sos(order, cutoff, SR, btype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=1e-7)


def test_butter_sos_takes_a_tensor_of_cutoffs():
    cuts = torch.tensor([200.0, 2000.0])
    got = tflt.butter_sos(4, cuts, SR, "lowpass")
    assert got.shape == (2, 2, 6)
    for i, c in enumerate(cuts.tolist()):
        np.testing.assert_allclose(got[i].numpy(),
                                   np.asarray(jflt.butter_sos(4, c, SR, "lowpass")), rtol=2e-6)


@pytest.mark.parametrize("method", ["assoc", "scan"])
@pytest.mark.parametrize("btype,cutoff", [("lowpass", 1000.0), ("bandpass", (300.0, 3000.0))])
def test_sosfilt_matches_jax(clip, method, btype, cutoff):
    """The CPU twin is JAX's default associative scan, to 1e-5; against
    JAX's sequential scan it is held to 1e-4, or to the two JAX methods'
    own spread where that is wider (f32 poles near 1)."""
    sos = jnp.asarray(jflt.butter_sos(4, cutoff, SR, btype))
    want = np.asarray(jflt.sosfilt(sos, jnp.asarray(clip), method=method))
    got = tflt.sosfilt(torch.tensor(np.asarray(sos)), torch.from_numpy(clip)).numpy()
    spread = rel_rms(np.asarray(jflt.sosfilt(sos, jnp.asarray(clip), method="assoc")),
                     np.asarray(jflt.sosfilt(sos, jnp.asarray(clip), method="scan")))
    assert rel_rms(got, want) < (1e-5 if method == "assoc" else max(1e-4, 1.5 * spread))


def test_sosfilt_per_row_sections_broadcast(clip):
    """Sections (K, 1, n, 6) over x (C, T) give (K, C, T), each knob's row
    its own filter."""
    cuts = [300.0, 3000.0]
    sos = tflt.butter_sos(2, torch.tensor(cuts), SR, "lowpass")        # (2, 1, 6)
    got = tflt.sosfilt(sos[:, None], torch.from_numpy(clip))
    assert got.shape == (2, 2, 4096)
    for i, c in enumerate(cuts):
        want = np.asarray(jflt.sosfilt(jflt.butter_sos(2, c, SR, "lowpass"), jnp.asarray(clip)))
        assert rel_rms(got[i].numpy(), want) < 1e-5


@pytest.mark.parametrize("name,args", [("lowpass", (1500.0,)), ("highpass", (120.0,)),
                                       ("bandpass", (200.0, 4000.0)),
                                       ("bandstop", (800.0, 1200.0))])
def test_filter_wrappers_match_jax(clip, name, args):
    got = getattr(tflt, name)(torch.from_numpy(clip), *args, SR).numpy()
    want = np.asarray(getattr(jflt, name)(jnp.asarray(clip), *args, SR))
    assert rel_rms(got, want) < 1e-5
    np.testing.assert_allclose(tflt.apply_gain_db(torch.from_numpy(clip), 6.0).numpy(),
                               np.asarray(jflt.apply_gain_db(jnp.asarray(clip), 6.0)),
                               rtol=1e-6)
