"""The twins of the recurrence kernels R1-R3 (ops/recurrence.py) against
the JAX package's scans and against float64 loops, on the CPU: R1's
associative scan gives JAX's `_biquad_assoc` bits and follows the float64
recurrence, per-row coefficients and the section split included; R2's loop
is the compressor's `lax.scan`; R3's loop is JAX's `freeverb_ir` and the
JUCE recurrence. On the card the kernels are held against these twins in
tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from audio_algebra_tpu.ops import effects as jfx
from audio_algebra_tpu.ops import filters as jflt
from audio_algebra_torch.ops import recurrence as rec

A_ATT, A_REL = math.exp(-1.0 / 48.0), math.exp(-1.0 / 4800.0)


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30)))


def _x(rows=2, t=4096, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal((rows, t))).astype(np.float32)


@pytest.mark.parametrize("order,cutoff,btype", [(4, 1000.0, "lowpass"),
                                                (2, 38.0, "highpass"),
                                                (4, (300.0, 3000.0), "bandpass")])
def test_sosfilt_twin_is_jax_assoc_scan(order, cutoff, btype):
    """JAX's bits. The f32 associative scan is ill-conditioned where a pole
    lies near 1: at the 38 Hz high pass (K-weighting's stage 2) JAX's
    default method is percents from float64 where its sequential scan is
    not; the port's kernel runs the sequential recurrence."""
    x = _x()
    sos = np.asarray(jflt.butter_sos(order, cutoff, 48000, btype))
    got = rec.sosfilt_rows(torch.from_numpy(sos.copy())[None], torch.from_numpy(x)).numpy()
    want = np.asarray(jflt.sosfilt(jnp.asarray(sos), jnp.asarray(x), method="assoc"))
    np.testing.assert_array_equal(got, want)
    f64 = scipy.signal.sosfilt(sos.astype(np.float64), x.astype(np.float64), axis=-1)
    seq = np.asarray(jflt.sosfilt(jnp.asarray(sos), jnp.asarray(x), method="scan"))
    assert rel_rms(seq, f64) < 1e-4
    if btype != "highpass":
        assert rel_rms(got, f64) < 1e-4


@pytest.mark.parametrize("t_len", [1, 2, 3, 7, 64, 1000])
def test_sosfilt_twin_at_ragged_lengths(t_len):
    x = _x(2, t_len, seed=t_len)
    sos = np.asarray(jflt.butter_sos(2, 2000.0, 48000, "lowpass"))
    got = rec.sosfilt_rows(torch.from_numpy(sos.copy())[None], torch.from_numpy(x)).numpy()
    want = scipy.signal.sosfilt(sos.astype(np.float64), x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_sosfilt_rows_per_row_coefficients_and_split():
    """Each row its own cascade; more than MAX_SECTIONS sections chain."""
    x = _x(4, 2048)
    cut = torch.tensor([2000.0, 5000.0, 8000.0, 12000.0])
    from audio_algebra_torch.ops.filters import butter_sos
    sos = torch.cat([butter_sos(4, cut, 48000, "lowpass")] * 6, 1)     # (4, 12, 6)
    assert sos.shape[1] > rec.MAX_SECTIONS
    got = rec.sosfilt_rows(sos, torch.from_numpy(x)).numpy()
    for r in range(4):
        want = scipy.signal.sosfilt(sos[r].double().numpy(), x[r].astype(np.float64))
        assert rel_rms(got[r], want) < 1e-4
    with pytest.raises(ValueError):
        rec.sosfilt_rows(sos[:3], torch.from_numpy(x))


def _jax_envelope(x):
    lt = jnp.moveaxis(jnp.abs(x), -1, 0)

    def step(env, level):
        coeff = jnp.where(level > env, A_ATT, A_REL)
        env2 = coeff * env + (1 - coeff) * level
        return env2, env2

    _, env = jax.lax.scan(step, jnp.zeros(lt.shape[1:], lt.dtype), lt)
    return jnp.moveaxis(env, 0, -1)


def test_envelope_twin_matches_jax_scan_and_f64():
    x = _x(2, 3000, seed=4)
    x[:, 1000:1200] *= 8.0                          # a burst: attack, then release
    got = rec.envelope(torch.from_numpy(x), A_ATT, A_REL).numpy()
    want = np.asarray(_jax_envelope(jnp.asarray(x)))
    assert rel_rms(got, want) < 1e-5
    env, f64 = 0.0, np.empty(3000)
    for t, level in enumerate(np.abs(x[0].astype(np.float64))):
        c = A_ATT if level > env else A_REL
        env = c * env + (1 - c) * level
        f64[t] = env
    assert rel_rms(got[0], f64) < 1e-5
    with pytest.raises(ValueError):
        rec.envelope(torch.from_numpy(x[0]), A_ATT, A_REL)


@pytest.mark.parametrize("sr", [48000, 44100])
def test_freeverb_twin_matches_jax_and_the_juce_recurrence(sr):
    rooms = np.array([0.1, 0.9], np.float32)
    fb = torch.from_numpy(rooms * np.float32(0.28) + np.float32(0.7))
    damp = torch.full((4,), float(np.float32(0.5) * np.float32(0.4)))
    got = rec.freeverb_irs(torch.cat([fb, fb]), damp, [0, 0, 23, 23], 3000, sr).numpy()
    for i, spread in enumerate([0, 0, 23, 23]):
        want = np.asarray(jfx.freeverb_ir(fb[i % 2].item(), damp[i].item(), 3000, sr, spread))
        assert rel_rms(got[i], want) < 1e-6
    # the JUCE comb / allpass recurrence in float64, one response
    combs, aps = rec.delay_sizes(sr, 23)
    bufs, lasts, apb = [np.zeros(s) for s in combs], [0.0] * 8, [np.zeros(s) for s in aps]
    f64 = np.zeros(3000)
    fbv, dmv = float(fb[1]), float(damp[3])
    for i in range(3000):
        acc = 0.0
        for j, s in enumerate(combs):
            o = bufs[j][i % s]
            lasts[j] = o * (1 - dmv) + lasts[j] * dmv
            bufs[j][i % s] = (1.0 if i == 0 else 0.0) + lasts[j] * fbv
            acc += o
        for k, s in enumerate(aps):
            bo = apb[k][i % s]
            apb[k][i % s] = acc + bo * 0.5
            acc = bo - acc
        f64[i] = acc
    assert rel_rms(got[3], f64) < 1e-6


def test_freeverb_delay_sizes_and_refusals():
    assert rec.delay_sizes(48000, 0)[0][0] == 48000 * 1116 // 44100
    assert max(rec.delay_sizes(48000, 23)[0]) == 1785
    with pytest.raises(ValueError):
        rec.freeverb_irs(torch.ones(2), torch.ones(2), [0], 16)
