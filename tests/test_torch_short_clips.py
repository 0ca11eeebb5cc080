"""Short clips through the port's STFT and its consumers against the JAX
package, on the CPU.

JAX reflect-pads a centred STFT with jnp.pad(mode="reflect"), which
reflects as often as the pad needs, so it computes clips of any T >= 1,
also T <= n_fft / 2. The port pads the same way (`ops/stft.reflect_pad`,
the index fold of numpy), and so does the card's kernel K6 for a row no
longer than the pad (`csrc/stft.cu:reflect_index`, modelled below step for
step).
Held here: `stft`, `stft_plain` and `stft_fused` (K6's twin on a CPU
tensor) at T in {1, 2, n_fft/4, n_fft/2, n_fft/2 + 1} for an n_fft of each
of K6's routes on the card (1024 the power-of-two FFT, 1000 the mixed-radix
FFT, 1018 the chirp-z route, 64 the JAX kernel's interpret mode), their
gradient against jax.grad, and the consumers at short T: spectrogram,
melspectrogram, griffin_lim (given JAX's angles), pitch_shift,
utils/viz.spectrogram_db and DMAE's MelE1d.mel, whose pre-pad is the same
reflect. Inputs are seeded with numpy; every comparison is a rel-RMS
below 1e-5, or where the output amplifies rounding (Griffin-Lim,
PitchShift from 1,024 samples) below twice JAX's own spread under a 1e-6
input change (`spread_bound`)."""
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
jmel = importlib.import_module("audio_algebra_tpu.ops.mel")
REL = 1e-5
ROUTES = {(1024, 256): ("fft", (8, 8, 8)), (1000, 250): ("fft", (4, 5, 5, 5)),
          (1018, 250): ("chirp", (2, 8, 8, 8)), (64, 16): ("fft", (4, 8))}


def short_lengths(n_fft):
    return (1, 2, n_fft // 4, n_fft // 2, n_fft // 2 + 1)


CASES = [(n_fft, hop, t) for n_fft, hop in ROUTES for t in short_lengths(n_fft)]


def _signal(shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def rel_rms(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.sqrt(np.mean(np.abs(got - want) ** 2) / np.mean(np.abs(want) ** 2)))


def spread_bound(jax_fn, inp, want, seed):
    """1e-5, or twice the rel-RMS by which JAX's own output moves under a
    1e-6 relative change of its input, whichever is larger: for outputs
    that amplify rounding (Griffin-Lim's rounds, PitchShift's phase
    cumsum)."""
    nudge = 1e-6 * np.random.default_rng(seed).standard_normal(inp.shape).astype(np.float32)
    return max(REL, 2 * rel_rms(jax_fn(inp * (1 + nudge)), want))


def card_reflect_index(s: int, t_len: int) -> int:
    """`reflect_index` of csrc/stft.cu, step for step: reflect at 0 and at
    t_len - 1 until the index lands in the row."""
    if t_len == 1:
        return 0
    last = t_len - 1
    while s < 0 or s > last:
        s = -s if s < 0 else 2 * last - s
    return s


def test_card_reflect_index_is_numpys_reflect():
    """The card's fold (only indices outside [0, T) reach it) gives
    np.pad(mode="reflect") at every T from 1 to 40 and pads up to 3 T + 5,
    the largest pad of the FFT route (4,096) at T = 2 and 3, and the old
    single reflection where one suffices."""
    cases = [(t_len, pad) for t_len in range(1, 41) for pad in range(0, 3 * t_len + 6)]
    for t_len, pad in cases + [(2, 4096), (3, 4096)]:
        want = np.pad(np.arange(t_len), pad, mode="reflect").tolist()
        got = [s if 0 <= s < t_len else card_reflect_index(s, t_len)
               for s in range(-pad, t_len + pad)]
        assert got == want, (t_len, pad)
        twin = tstft._reflect_index(t_len, pad, torch.device("cpu")).numpy()
        assert twin.tolist() == want, (t_len, pad)
    for t_len in range(2, 41):
        for s in range(-(t_len - 1), 0):
            assert card_reflect_index(s, t_len) == -s
        for s in range(t_len, 2 * t_len - 1):
            assert card_reflect_index(s, t_len) == 2 * (t_len - 1) - s


@pytest.mark.parametrize("n_fft,hop,t_len", CASES)
def test_short_clip_stft_matches_jax(n_fft, hop, t_len):
    """stft, stft_plain and stft_fused against JAX's XLA stft (and at 64 /
    16 its Pallas kernel in interpret mode) at a clip no longer than the
    pad, or one sample longer."""
    assert tk.plan(n_fft) == ROUTES[(n_fft, hop)]
    rows = 2 + t_len % 3                       # 2-4 rows
    x = _signal((rows, t_len), n_fft + t_len)
    want = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop))
    assert want.shape == (rows, n_fft // 2 + 1, 1 + t_len // hop)
    xt = torch.from_numpy(x)
    for fn in (tstft.stft, tstft.stft_plain, tk.stft_fused):
        got = fn(xt, n_fft, hop).numpy()
        assert got.dtype == np.complex64
        assert rel_rms(got, want) < REL, fn.__name__
    if n_fft == 64:
        kernel = np.asarray(pallas_stft(jnp.asarray(x), n_fft, hop, interpret=True))
        assert rel_rms(tstft.stft(xt, n_fft, hop).numpy(), kernel) < REL


def test_short_clip_without_a_frame_is_refused():
    """Uncentred, a clip shorter than n_fft has no frame, as JAX's
    frame_signal has none; an empty clip has none either."""
    with pytest.raises(ValueError, match="no frame"):
        tk.stft_fused(torch.zeros(2, 63), 64, 16, center=False)
    with pytest.raises(ValueError, match="no frame"):
        tk.stft_fused(torch.zeros(2, 0), 64, 16)
    assert tk.stft_fused(torch.zeros(2, 64), 64, 16, center=False).shape == (2, 33, 1)


@pytest.mark.parametrize("n_fft,hop,t_len", [(1024, 256, 16), (1024, 256, 300),
                                             (1018, 250, 509), (64, 16, 1), (64, 16, 2),
                                             (64, 16, 33)])
def test_short_clip_gradient_matches_jax_grad(n_fft, hop, t_len):
    """The gradient of sum(|stft(x)|^2 w) through the reflect gather's
    scatter-add against jax.grad through jnp.pad. (jax.grad compiles a
    pad of many reflections slowly: 32 at most here, 3 s; T = 1 and 2 at
    1024 take minutes.)"""
    x = _signal((2, t_len), 7 + t_len)
    shape = (2, n_fft // 2 + 1, 1 + t_len // hop)
    w = np.random.default_rng(8).random(shape).astype(np.float32)

    def loss(a):
        return jnp.sum(jnp.square(jnp.abs(jstft.stft(a, n_fft, hop))) * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    leaf = torch.from_numpy(x).requires_grad_()
    (tstft.stft(leaf, n_fft, hop).abs().square() * torch.from_numpy(w)).sum().backward()
    assert rel_rms(leaf.grad.numpy(), want) < REL


@pytest.mark.parametrize("t_len", [1, 2, 256, 512, 513])
@pytest.mark.parametrize("power", [None, 2.0])
def test_short_clip_spectrogram_matches_jax(t_len, power):
    x = _signal((2, t_len), 20 + t_len)
    got = tstft.spectrogram(torch.from_numpy(x), power=power).numpy()
    want = np.asarray(jstft.spectrogram(jnp.asarray(x), power=power))
    assert rel_rms(got, want) < REL


@pytest.mark.parametrize("t_len", [1, 2, 256, 512, 513])
def test_short_clip_melspectrogram_matches_jax(t_len):
    from audio_algebra_torch.ops import mel as tmel

    x = _signal((1, 2, t_len), 30 + t_len)
    got = tmel.melspectrogram(torch.from_numpy(x)).numpy()
    want = np.asarray(jmel.melspectrogram(jnp.asarray(x)))
    assert got.shape == (1, 2, 128, 1 + t_len // 256)
    assert rel_rms(got, want) < REL


@pytest.mark.parametrize("t_len", [300, 512])
def test_short_clip_griffin_lim_matches_jax_given_its_angles(t_len):
    """Each round's STFT re-analyses an iSTFT of (F - 1) hop samples, no
    more than the pad: the short-clip path on every round. Griffin-Lim
    amplifies rounding: held to `spread_bound` (at T = 512 JAX's own
    output moves 3.5e-5 under the 1e-6 change)."""
    x = _signal((1, t_len), 40 + t_len)
    mag2 = np.array(jstft.spectrogram(jnp.asarray(x), power=2.0))
    key = jax.random.PRNGKey(9)

    def jgl(m):
        return np.asarray(jstft.griffin_lim(jnp.asarray(m), n_iter=8, length=t_len, key=key))

    want = jgl(mag2)
    angles = np.array(jax.random.uniform(key, mag2.shape, dtype=jnp.float32) * 2 * math.pi)
    got = tstft.griffin_lim(torch.from_numpy(mag2), n_iter=8, length=t_len,
                            init_angle=torch.from_numpy(angles)).numpy()
    assert got.shape == want.shape == (1, t_len)
    assert rel_rms(got, want) < spread_bound(jgl, mag2, want, 41)


@pytest.mark.parametrize("t_len", [1, 2, 512, 1024, 1025])
def test_short_clip_pitch_shift_matches_jax(t_len):
    """PitchShift's STFT at n_fft 2048: every clip of at most 1,024
    samples is shorter than its pad. From 1,024 samples on the phase
    cumsum amplifies rounding: held to `spread_bound` (JAX's own output
    moves 9e-6 at T = 1024)."""
    from audio_algebra_tpu.ops import effects as jfx
    from audio_algebra_torch.ops import effects as tfx

    def jshift(a):
        return np.asarray(jfx.pitch_shift(jnp.asarray(a), 3.0))

    x = _signal((2, t_len), 50 + t_len)
    want = jshift(x)
    got = tfx.pitch_shift(torch.from_numpy(x), 3.0).numpy()
    assert got.shape == want.shape == (2, t_len)
    assert rel_rms(got, want) < spread_bound(jshift, x, want, 51)


@pytest.mark.parametrize("t_len", [1, 2, 300, 512])
def test_short_clip_spectrogram_db_matches_jax(t_len):
    """The dB image held in linear magnitude, 10^(dB / 20)."""
    from audio_algebra_tpu.utils import viz as jviz
    from audio_algebra_torch.utils import viz as tviz

    x = _signal((2, t_len), 60 + t_len)
    want = np.asarray(jviz.spectrogram_db(x))
    got = tviz.spectrogram_db(x, device="cpu")
    assert got.shape == want.shape == (513, 1 + t_len // 256)
    assert rel_rms(10.0 ** (got / 20.0), 10.0 ** (want / 20.0)) < REL


@pytest.mark.parametrize("t_len", [16, 17, 24, 25])
def test_dmae_mel_of_a_short_clip_matches_jax(t_len):
    """MelE1d.mel's reflect pre-pad of (n_fft - hop) / 2 = 24 at the tiny
    64 / 16 front end of test_torch_zoo_models: T <= 24 is no longer than
    the pad (torch's F.pad refuses it, jnp.pad reflects again)."""
    from audio_algebra_tpu.models.dmae import MelE1d as JMel
    from audio_algebra_torch.models.dmae import MelE1d as TMel

    kw = dict(channels=8, multipliers=(1, 1), factors=(2,), num_blocks=(1,), out_channels=4,
              mel_channels=16, n_fft=64, hop=16)
    x = _signal((2, 2, t_len), 70 + t_len)
    want = np.asarray(JMel(**kw).apply({}, jnp.asarray(x), method=JMel.mel))
    got = TMel(**kw).mel(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 2 * 16, t_len // 16)
    assert rel_rms(got, want) < REL
