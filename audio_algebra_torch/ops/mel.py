"""Mel filterbank ops: MelSpectrogram / InverseMelScale equivalents.

Port of audio_algebra_tpu/ops/mel.py: the HTK-scale triangular filterbank
of torchaudio's defaults, `melspectrogram` as the power spectrogram
(through K6 on the card) followed by one filterbank product, and
`inverse_mel_scale` as one product with a Tikhonov-regularised
pseudo-inverse, clamped at zero. The tables are built in numpy, as in
JAX; the products run in full f32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import full_f32
from .stft import device_table, spectrogram


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def _mel_fb_np(n_bins: int, n_mels: int, sample_rate: int, f_min: float,
               f_max: float | None, norm: str | None) -> np.ndarray:
    """Triangular mel filterbank (n_bins, n_mels), HTK scale."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_bins)
    m_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_bins, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    return fb.astype(np.float32)


def mel_filterbank(n_bins: int, n_mels: int = 128, sample_rate: int = 48000,
                   f_min: float = 0.0, f_max: float | None = None,
                   norm: str | None = None, device=None) -> torch.Tensor:
    """Mel filterbank matrix (n_bins, n_mels)."""
    return device_table(f"melfb{(n_bins, n_mels, sample_rate, f_min, f_max, norm)}",
                        lambda: _mel_fb_np(n_bins, n_mels, sample_rate, f_min, f_max, norm),
                        device)


def melspectrogram(x: torch.Tensor, sample_rate: int = 48000, n_fft: int = 1024,
                   hop_length: int = 256, n_mels: int = 128, power: float = 2.0,
                   f_min: float = 0.0, f_max: float | None = None,
                   norm: str | None = None, center: bool = True) -> torch.Tensor:
    """(..., T) -> (..., n_mels, F), torchaudio MelSpectrogram's defaults."""
    spec = spectrogram(x, n_fft=n_fft, hop_length=hop_length, power=power, center=center)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max, norm, x.device)
    with full_f32():
        return torch.matmul(fb.t(), spec)                  # contract the bins


@functools.lru_cache(maxsize=16)
def _mel_pinv_np(n_bins: int, n_mels: int, sample_rate: int, f_min: float,
                 f_max: float | None, norm: str | None) -> np.ndarray:
    """Tikhonov-regularised pseudo-inverse of the filterbank (n_mels, n_bins)."""
    fb = _mel_fb_np(n_bins, n_mels, sample_rate, f_min, f_max, norm)
    a = fb.T @ fb + 1e-8 * np.eye(n_mels, dtype=np.float64)
    return np.linalg.solve(a, fb.T).astype(np.float32)


def inverse_mel_scale(melspec: torch.Tensor, n_stft: int, sample_rate: int = 48000,
                      n_mels: int = 128, f_min: float = 0.0, f_max: float | None = None,
                      norm: str | None = None) -> torch.Tensor:
    """(..., n_mels, F) -> (..., n_stft, F) nonnegative spectrogram estimate."""
    pinv = device_table(f"melpinv{(n_stft, n_mels, sample_rate, f_min, f_max, norm)}",
                        lambda: _mel_pinv_np(n_stft, n_mels, sample_rate, f_min, f_max, norm),
                        melspec.device)
    with full_f32():
        spec = torch.matmul(pinv.t(), melspec)
    return torch.clamp(spec, min=0.0)
