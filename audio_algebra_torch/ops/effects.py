"""The effect bank (pedalboard's effects and knobs) on tensors.

Port of audio_algebra_tpu/ops/effects.py: the same 12 names, knobs and
ranges (`EFFECTS`), `knob_sweep` and `apply_effect`. JAX sweeps a knob by
`jax.vmap` over a traced value; here the batch is written out: every effect
but PitchShift takes its knob as a scalar or as a tensor of shape (K,), and
x of shape (..., C, T), and returns x's shape for a scalar knob and
(K, ..., C, T) for K knobs. PitchShift's knob changes a resampling ratio, so
it stays a Python float, and a sweep of it loops on the host as JAX's does.

The three recurrences run on kernels of ops/recurrence.py: the first-order
TPT filters and the phaser's notches on R1 (through ops/filters.sosfilt),
the compressor's envelope on R2, Freeverb's impulse response on R3. Two
reuses keep the numbers of the per-knob calls:
- the compressor's envelope does not depend on `threshold_db`: it runs once
  a clip and the K gains follow it;
- Freeverb's impulse response does not depend on the clip: it runs once a
  knob and spread, in one launch, and each clip is convolved with it by FFT
  (JAX `_fft_conv`, through torch.fft).
PitchShift runs through ops/stft.stft (kernel K6 on the card), istft and
ops/resample.resample.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .filters import apply_gain_db, biquad_coeffs, sosfilt
from .recurrence import envelope, freeverb_irs
from .resample import resample
from .stft import istft, stft

FREEVERB_STEREO_SPREAD = 23


def _knobs(knob, x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """The knob as a (K,) f32 tensor on x's device, and whether it was a
    scalar."""
    k = torch.as_tensor(knob, dtype=torch.float32, device=x.device)
    if k.dim() > 1:
        raise ValueError(f"a knob is a scalar or (K,), got shape {tuple(k.shape)}")
    return k.reshape(-1), k.dim() == 0


def _over(k: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(K,) -> (K, 1, ..., 1), broadcasting over x's dimensions."""
    return k.view(-1, *([1] * x.dim()))


def _out(y: torch.Tensor, scalar: bool) -> torch.Tensor:
    return y[0] if scalar else y


def clean(x, knob=0.0, sample_rate=48000):
    """Identity (reference xae Clean)."""
    k, scalar = _knobs(knob, x)
    return _out(x[None].expand(k.shape[0], *x.shape), scalar)


def time_reverse(x, knob=0.0, sample_rate=48000):
    """Reverse the time axis (reference xae TimeReverse)."""
    k, scalar = _knobs(knob, x)
    return _out(x.flip(-1)[None].expand(k.shape[0], *x.shape), scalar)


def gain(x, gain_db, sample_rate=48000):
    k, scalar = _knobs(gain_db, x)
    return _out(apply_gain_db(x[None], _over(k, x)), scalar)


def distortion(x, drive_db, sample_rate=48000):
    """pedalboard.Distortion(drive_db): a tanh waveshaper with input gain."""
    k, scalar = _knobs(drive_db, x)
    g = 10.0 ** (_over(k, x) / 20.0)
    return _out(torch.tanh(g * x[None]), scalar)


def _tpt_first_order_sos(cutoff_hz: torch.Tensor, sample_rate, kind: str) -> torch.Tensor:
    """juce::dsp::FirstOrderTPTFilter as one section a knob, (K, 1, 6):
    H_lp(z) = G (1 + z^-1) / (1 + (2G - 1) z^-1), H_hp = 1 - H_lp, with
    G = g / (1 + g), g = tan(pi fc / fs)."""
    fc = torch.clamp(cutoff_hz, 1.0, sample_rate * 0.49999)
    g = torch.tan(math.pi * fc / sample_rate)
    G = g / (1.0 + g)
    if kind == "lowpass":
        b0, b1 = G, G
    else:
        b0, b1 = 1.0 - G, -(1.0 - G)
    a1 = 2.0 * G - 1.0
    zero, one = torch.zeros_like(G), torch.ones_like(G)
    return torch.stack([b0, b1, zero, one, a1, zero], -1)[:, None, :]


def _first_order(x, cutoff_hz, sample_rate, kind):
    k, scalar = _knobs(cutoff_hz, x)
    sos = _tpt_first_order_sos(k, sample_rate, kind)
    return _out(sosfilt(sos.view(-1, *([1] * (x.dim() - 1)), 1, 6), x), scalar)


def lowpass_filter(x, cutoff_hz, sample_rate=48000):
    """pedalboard.LowpassFilter(cutoff_frequency_hz): first-order TPT, 6 dB
    an octave."""
    return _first_order(x, cutoff_hz, sample_rate, "lowpass")


def highpass_filter(x, cutoff_hz, sample_rate=48000):
    """pedalboard.HighpassFilter: first-order TPT, 6 dB an octave."""
    return _first_order(x, cutoff_hz, sample_rate, "highpass")


def compressor(x, threshold_db, sample_rate=48000, ratio: float = 4.0,
               attack_ms: float = 1.0, release_ms: float = 100.0):
    """pedalboard.Compressor(threshold_db): an envelope follower (R2, once
    for all thresholds) and the gain computer."""
    k, scalar = _knobs(threshold_db, x)
    a_att = math.exp(-1.0 / (attack_ms * 1e-3 * sample_rate))
    a_rel = math.exp(-1.0 / (release_ms * 1e-3 * sample_rate))
    env = envelope(x.reshape(-1, x.shape[-1]), a_att, a_rel).reshape(x.shape)
    env_db = 20.0 * torch.log10(torch.clamp(env, min=1e-6))
    over = torch.clamp(env_db[None] - _over(k, x), min=0.0)
    gain_db_ = -over * (1.0 - 1.0 / ratio)
    return _out(x[None] * 10.0 ** (gain_db_ / 20.0), scalar)


def delay(x, delay_seconds, sample_rate=48000, feedback: float = 0.0,
          mix: float = 0.5, n_taps: int = 4):
    """pedalboard.Delay(delay_seconds): n_taps echoes with feedback^k gain,
    a static tap sum."""
    d, scalar = _knobs(delay_seconds, x)
    t_len = x.shape[-1]
    idx = torch.arange(t_len, device=x.device)
    wet = torch.zeros((d.shape[0], *x.shape), dtype=x.dtype, device=x.device)
    for k in range(1, n_taps + 1):
        shift = (d * sample_rate * k).to(torch.int32)[:, None]            # (K, 1)
        src = torch.clamp(idx[None] - shift, 0, t_len - 1)                 # (K, T)
        tap = torch.movedim(x[..., src], -2, 0) * (feedback ** (k - 1))
        wet = wet + tap * (idx[None] >= shift).view(-1, *([1] * (x.dim() - 1)), t_len)
    return _out((1 - mix) * x[None] + mix * wet, scalar)


def chorus(x, rate_hz, sample_rate=48000, depth_ms: float = 7.0,
           centre_ms: float = 8.0, mix: float = 0.5):
    """pedalboard.Chorus(rate_hz): an LFO-modulated fractional delay line."""
    rate, scalar = _knobs(rate_hz, x)
    t_len = x.shape[-1]
    n = torch.arange(t_len, dtype=torch.float32, device=x.device)
    lfo = torch.sin(2 * math.pi * rate[:, None] * n / sample_rate)          # (K, T)
    delay_samp = (centre_ms + depth_ms * 0.5 * lfo) * 1e-3 * sample_rate
    pos = torch.clamp(n - delay_samp, 0.0, t_len - 1.001)
    i0 = pos.to(torch.int64)
    frac = (pos - i0).view(-1, *([1] * (x.dim() - 1)), t_len)
    wet = torch.movedim(x[..., i0], -2, 0) * (1 - frac) \
        + torch.movedim(x[..., i0 + 1], -2, 0) * frac
    return _out((1 - mix) * x[None] + mix * wet, scalar)


def phaser(x, rate_hz, sample_rate=48000, depth: float = 0.8,
           centre_hz: float = 1300.0, mix: float = 0.5, stages: int = 4):
    """pedalboard.Phaser(rate_hz): cascaded notch biquads whose centre
    follows the LFO frozen in each of 8 segments. Each segment is filtered
    from zero state, as in JAX; the 8 segments go to R1 as rows of one
    launch."""
    rate, scalar = _knobs(rate_hz, x)
    t_len = x.shape[-1]
    n_seg = 8
    seg = t_len // n_seg
    secs = []
    for s in range(n_seg):
        phase = 2 * math.pi * rate * (s * seg / sample_rate)
        f = centre_hz * (1.0 + depth * 0.5 * torch.sin(phase))
        b, a = biquad_coeffs("notch", f, sample_rate, q=0.7)
        secs.append(torch.cat([b, a], -1)[:, None, :].expand(-1, stages // 2, 6))
    sos = torch.stack(secs, 1)                                             # (K, 8, n, 6)
    parts = x[..., :n_seg * seg].reshape(*x.shape[:-1], n_seg, seg)
    sos = sos.view(-1, *([1] * (x.dim() - 1)), n_seg, stages // 2, 6)
    wet = sosfilt(sos, parts).reshape(rate.shape[0], *x.shape[:-1], n_seg * seg)
    rem = x[..., n_seg * seg:]
    if rem.shape[-1]:
        wet = torch.cat([wet, rem[None].expand(rate.shape[0], *rem.shape)], -1)
    return _out((1 - mix) * x[None] + mix * wet, scalar)


def _fft_conv(sig: torch.Tensor, ir: torch.Tensor, n_out: int) -> torch.Tensor:
    """Causal convolution, the first n_out samples (f32 FFT)."""
    n = sig.shape[-1] + ir.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    out = torch.fft.irfft(torch.fft.rfft(sig, nfft) * torch.fft.rfft(ir, nfft), nfft)
    return out[..., :n_out]


def reverb(x, room_size, sample_rate=48000, mix: float = 0.33,
           damping: float = 0.5, dry_level: float = 0.4,
           width: float = 1.0, freeze_mode: float = 0.0):
    """pedalboard.Reverb(room_size): Freeverb / juce::Reverb through its
    impulse response. Stereo inputs (..., 2, T) take JUCE's stereo path
    (the mono sum at gain 0.015 through the left and right comb banks,
    wet1 / wet2 width mixing); other shapes the mono path a row.
    Same-length output."""
    room, scalar = _knobs(room_size, x)
    x32 = x.float()
    frozen = freeze_mode >= 0.5
    feedback = torch.ones_like(room) if frozen else room * 0.28 + 0.7
    damp = 0.0 if frozen else float(np.float32(np.float32(damping) * np.float32(0.4)))
    gain_in = 0.0 if frozen else 0.015
    wet = float(np.float32(mix) * np.float32(3.0))               # JUCE wetScaleFactor
    dry = float(np.float32(dry_level) * np.float32(2.0))         # JUCE dryScaleFactor
    wet1 = wet * (width / 2.0 + 0.5)
    wet2 = wet * ((1.0 - width) / 2.0)
    t_len = x32.shape[-1]
    kk = room.shape[0]
    damps = torch.full_like(feedback, damp)
    if x32.dim() >= 2 and x32.shape[-2] == 2:                   # JUCE processStereo
        irs = freeverb_irs(torch.cat([feedback, feedback]), torch.cat([damps, damps]),
                           [0] * kk + [FREEVERB_STEREO_SPREAD] * kk, t_len, sample_rate)
        view = (kk, *([1] * (x32.dim() - 2)), t_len)
        mono_in = (x32[..., 0, :] + x32[..., 1, :]) * gain_in
        out_l = _fft_conv(mono_in[None], irs[:kk].view(view), t_len)
        out_r = _fft_conv(mono_in[None], irs[kk:].view(view), t_len)
        y = torch.stack([out_l * wet1 + out_r * wet2 + x32[..., 0, :] * dry,
                         out_r * wet1 + out_l * wet2 + x32[..., 1, :] * dry], -2)
    else:                                                       # JUCE processMono
        ir = freeverb_irs(feedback, damps, [0] * kk, t_len, sample_rate)
        y = _fft_conv(x32[None] * gain_in, ir.view(kk, *([1] * (x32.dim() - 1)), t_len),
                      t_len) * wet1 + x32[None] * dry
    return _out(y, scalar)


def _mod(a: torch.Tensor, b: float) -> torch.Tensor:
    """jnp.mod for a positive divisor: the exact fmod, moved into [0, b)."""
    r = torch.fmod(a, b)
    return torch.where(r < 0, r + b, r)


def pitch_shift(x, semitones: float, sample_rate=48000, n_fft: int = 2048,
                hop: int = 512):
    """pedalboard.PitchShift(semitones): a phase-vocoder time stretch by the
    ratio, then a resample back to the original duration, which multiplies
    every frequency by the ratio. `semitones` is a Python float."""
    ratio = 2.0 ** (float(semitones) / 12.0)
    t_len = x.shape[-1]
    spec = stft(x.float(), n_fft, hop)                                    # (..., bins, F)
    mag, phase = torch.abs(spec), torch.angle(spec)
    n_frames = spec.shape[-1]
    out_frames = max(int(n_frames * ratio), 2)
    # jnp.linspace(0, n_frames - 1.001, out_frames) in f32, JAX's formula
    div = out_frames - 1
    step = torch.arange(div, dtype=torch.float32, device=x.device) / float(div)
    stop = torch.tensor(n_frames - 1.001, dtype=torch.float32, device=x.device)
    pos = torch.cat([stop * step, stop[None]])
    i0 = pos.to(torch.int64)
    frac = (pos - i0)[None, :]
    i1 = torch.clamp(i0 + 1, max=n_frames - 1)
    mag_i = mag[..., i0] * (1 - frac) + mag[..., i1] * frac
    dphase = phase - torch.roll(phase, 1, dims=-1)
    bins = torch.arange(spec.shape[-2], dtype=torch.float32, device=x.device)
    omega = 2 * math.pi * bins * hop / n_fft
    # frame 0 has no predecessor: pin its advance to the nominal one (JAX)
    dphase[..., 0] = omega
    dev = dphase - omega[:, None]
    dev = _mod(dev + math.pi, 2 * math.pi) - math.pi
    inst = omega[:, None] + dev
    new_phase = torch.cumsum(inst[..., i0], -1)
    stretched = istft(torch.complex(mag_i * torch.cos(new_phase),
                                    mag_i * torch.sin(new_phase)), n_fft, hop)
    up, down = max(int(round(ratio * 1000)), 1), 1000
    g = math.gcd(up, down)
    out = resample(stretched, up // g, down // g)[..., :t_len]
    if out.shape[-1] < t_len:
        out = torch.nn.functional.pad(out, (0, t_len - out.shape[-1]))
    return out


# name -> (fn, knob_name, lo, hi, log_scale): the reference dataset factory's
# sweep (xae_dataset.ipynb cell 27), log scale for the two filters only
# (cell 33); the Compressor at the reference's fixed ratio 25.
EFFECTS: Dict[str, Tuple[Callable, str, float, float, bool]] = {
    "Clean": (clean, "none", 0.0, 1.0, False),
    "TimeReverse": (time_reverse, "none", 0.0, 1.0, False),
    "Gain": (gain, "gain_db", -12.0, 12.0, False),
    "Distortion": (distortion, "drive_db", 0.0, 30.0, False),
    "Reverb": (reverb, "room_size", 0.01, 0.99, False),
    "Chorus": (chorus, "rate_hz", 0.5, 3.0, False),
    "Delay": (delay, "delay_seconds", 0.1, 1.0, False),
    "Phaser": (phaser, "rate_hz", 0.1, 10.0, True),
    "Compressor": (partial(compressor, ratio=25.0), "threshold_db", -60.0, -3.0, False),
    "HighpassFilter": (highpass_filter, "cutoff_frequency_hz", 50.0, 10000.0, True),
    "LowpassFilter": (lowpass_filter, "cutoff_frequency_hz", 50.0, 10000.0, True),
    "PitchShift": (pitch_shift, "semitones", -12.0, 12.0, False),
}
STATIC_KNOB = ("PitchShift",)


def knob_sweep(name: str, n: int = 32) -> np.ndarray:
    """The knob values of a sweep: linear, or logarithmic for the filters."""
    fn, knob, lo, hi, log_scale = EFFECTS[name]
    if log_scale:
        return np.exp(np.linspace(np.log(lo), np.log(hi), n))
    return np.linspace(lo, hi, n)


def apply_effect(name: str, x, knob_value, sample_rate: int = 48000):
    """The effect `name` at one knob value (x's shape) or at each of K
    (K, ...): PitchShift's K values loop on the host."""
    fn = EFFECTS[name][0]
    if name in STATIC_KNOB and np.ndim(knob_value) == 1:
        return torch.stack([fn(x, float(k), sample_rate) for k in np.asarray(knob_value)])
    if name in STATIC_KNOB:
        return fn(x, float(knob_value), sample_rate)
    return fn(x, knob_value, sample_rate)
