"""Pseudo-QMF polyphase filterbank (near-perfect reconstruction).

Port of audio_algebra_tpu/ops/pqmf.py. The filter design is numpy and the
JAX package's, line for line: a Kaiser-windowed sinc prototype of length
2 m N, cosine modulation with the ±π/4 phases, the cutoff chosen by a
golden-section search on the distortion's flatness, and the synthesis
bank scaled to unity gain. Analysis is one strided `conv1d` (the JAX
package computes it as one strided convolution, outside any Pallas
kernel), synthesis one `conv_transpose1d` cropped to a delay-free
output.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import full_f32


def _kaiser_beta(atten_db: float) -> float:
    if atten_db > 50:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21:
        return 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    return 0.0


def _prototype(wc: float, taps: int, n_bands: int, beta: float) -> np.ndarray:
    """Kaiser-windowed lowpass prototype; wc ~0.53 puts the cutoff near
    pi / (2N)."""
    n = np.arange(taps) - (taps - 1) / 2
    h = wc / n_bands * np.sinc(wc * n / n_bands)
    w = np.i0(beta * np.sqrt(np.maximum(0, 1 - (2 * n / (taps - 1)) ** 2))) / np.i0(beta)
    return h * w


def _modulate(h: np.ndarray, n_bands: int) -> tuple[np.ndarray, np.ndarray]:
    taps = len(h)
    n = np.arange(taps)
    k = np.arange(n_bands)[:, None]
    phase = (2 * k + 1) * (math.pi / (2 * n_bands)) * (n[None, :] - (taps - 1) / 2)
    ana = 2 * h[None, :] * np.cos(phase + (-1) ** k * math.pi / 4)
    syn = 2 * h[None, :] * np.cos(phase - (-1) ** k * math.pi / 4)
    return ana, syn


def _t0(ana: np.ndarray, syn: np.ndarray, n_bands: int, nfft: int = 8192) -> np.ndarray:
    """|distortion transfer| of the alias-cancelled bank."""
    H = np.fft.fft(ana, nfft, axis=1)
    G = np.fft.fft(syn, nfft, axis=1)
    return np.abs((G * H).sum(0) / n_bands)


@functools.lru_cache(maxsize=8)
def _design(n_bands: int, atten_db: float) -> tuple[np.ndarray, np.ndarray]:
    beta = _kaiser_beta(atten_db)
    m = max(8, int(math.ceil((atten_db - 7.95) / (2.285 * 0.3 * math.pi * 2))))
    taps = 2 * m * n_bands

    def flatness(wc: float) -> float:
        ana, syn = _modulate(_prototype(wc, taps, n_bands, beta), n_bands)
        t = _t0(ana, syn, n_bands)
        return float(np.max(np.abs(t / t.mean() - 1.0)))

    a, b = 0.3, 0.9
    gr = (math.sqrt(5) - 1) / 2
    c, d = b - gr * (b - a), a + gr * (b - a)
    for _ in range(40):
        if flatness(c) < flatness(d):
            b = d
        else:
            a = c
        c, d = b - gr * (b - a), a + gr * (b - a)
    wc = (a + b) / 2
    ana, syn = _modulate(_prototype(wc, taps, n_bands, beta), n_bands)
    syn = syn / _t0(ana, syn, n_bands).mean()
    return ana.astype(np.float32), syn.astype(np.float32)


class PQMF:
    """Near-perfect-reconstruction cosine-modulated filterbank.

    `PQMF(n_bands, attenuation_db).analysis(x)` maps (..., C, T) ->
    (..., C * n_bands, T // n_bands); `synthesis` inverts it with the group
    delay compensated, so the round trip is sample-aligned. n_bands == 1
    is the identity. The banks move to each input's device and dtype;
    the convolutions run in full f32 for f32 inputs."""

    def __init__(self, n_bands: int, attenuation_db: float = 70.0):
        self.n_bands = n_bands
        self.attenuation_db = attenuation_db
        self.taps = 1
        if n_bands > 1:
            ana, syn = _design(n_bands, float(attenuation_db))
            self.taps = ana.shape[1]
            self._ana = torch.from_numpy(np.ascontiguousarray(ana[:, None, :]))  # (N, 1, L)
            self._syn = torch.from_numpy(np.ascontiguousarray(syn[:, None, :]))  # (N, 1, L)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """(..., C, T) -> (..., C * bands, T // bands): y_k[m] = (h_k * x)[m N]."""
        if self.n_bands == 1:
            return x
        *batch, c, t = x.shape
        xb = F.pad(x.reshape(-1, 1, t), (self.taps - 1, 0))
        # conv1d correlates: the flipped bank convolves
        w = self._ana.flip(-1).to(x.device, x.dtype)
        with full_f32():
            y = F.conv1d(xb, w, stride=self.n_bands)
        return y.reshape(*batch, c * self.n_bands, y.shape[-1])

    def synthesis(self, y: torch.Tensor) -> torch.Tensor:
        """The inverse of analysis: zero-stuff by N, then the synthesis
        filters, delay-free (the first taps - 1 samples of the full
        convolution dropped)."""
        if self.n_bands == 1:
            return y
        *batch, cb, f = y.shape
        c = cb // self.n_bands
        yb = y.reshape(-1, self.n_bands, f)
        with full_f32():      # output_padding: the zero tail of the full convolution
            x = F.conv_transpose1d(yb, self._syn.to(y.device, y.dtype), stride=self.n_bands,
                                   output_padding=self.n_bands - 1)
        x = x[..., self.taps - 1:]
        return x.reshape(*batch, c, x.shape[-1])

    def __call__(self, x):
        return self.analysis(x)

    def inverse(self, y):
        return self.synthesis(y)
