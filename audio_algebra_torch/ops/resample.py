"""Host-side polyphase resampling (numpy), the port's own copy of
audio_algebra_tpu.ops.resample.resample_np.

A rational resampler (up L, down M) is y[bL + r] = sum_u x[bM + u] K[u, r]:
every block of L output samples is a linear map of a W-sample input
window sliding by M, so the whole op is one framed matmul. The
windowed-sinc taps follow torchaudio's sinc_interp_hann recipe
(lowpass_filter_width 6, rolloff 0.99).
"""
from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=32)
def resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                    rolloff: float = 0.99) -> tuple[np.ndarray, int, int, int]:
    """Windowed-sinc filter taps. Returns (taps[K], L, M, K); unit-DC·L gain."""
    g = math.gcd(orig_freq, new_freq)
    L, M = new_freq // g, orig_freq // g
    base_freq = min(orig_freq, new_freq) * rolloff / 2.0
    width = int(math.ceil(lowpass_filter_width * orig_freq * L / base_freq))
    t = np.arange(-width, width + 1, dtype=np.float64) / (orig_freq * L)
    kernel = 2 * base_freq / (orig_freq * L) * np.sinc(2 * base_freq * t)
    window = np.cos(np.pi * t * base_freq / lowpass_filter_width / 2) ** 2
    kernel = kernel * window
    kernel = kernel / kernel.sum() * L
    return kernel.astype(np.float32), L, M, len(kernel)


@functools.lru_cache(maxsize=32)
def _block_matrix(orig_freq: int, new_freq: int, lowpass_filter_width: int,
                  rolloff: float):
    """(halo, W, A[W, L], L, M) with A[u, r] = k[uL - rM + pad]."""
    k, L, M, K = resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    pad = K // 2
    u_lo = -(pad // L + 1)
    u_hi = ((L - 1) * M - pad + K - 1) // L + 1
    W = u_hi - u_lo + 1
    u = np.arange(u_lo, u_hi + 1)[:, None]
    r = np.arange(L)[None, :]
    idx = u * L - r * M + pad
    valid = (idx >= 0) & (idx < K)
    A = np.where(valid, k[np.clip(idx, 0, K - 1)], 0.0).astype(np.float32)
    return -u_lo, W, A, L, M


def resample_np(x: np.ndarray, orig_freq: int, new_freq: int,
                lowpass_filter_width: int = 6, rolloff: float = 0.99) -> np.ndarray:
    """Resample the last axis of `x` from orig_freq to new_freq."""
    if orig_freq == new_freq:
        return np.asarray(x)
    halo, W, A, L, M = _block_matrix(orig_freq, new_freq, lowpass_filter_width, rolloff)
    x = np.asarray(x, np.float32)
    t_in = x.shape[-1]
    t_out = int(math.ceil(t_in * L / M))
    n_blocks = -(-t_out // L)
    pad_right = max(0, (n_blocks - 1) * M + (W - halo) - t_in)
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(halo, pad_right)])
    idx = np.arange(n_blocks)[:, None] * M + np.arange(W)[None, :]
    y = xp[..., idx] @ A
    return y.reshape(*x.shape[:-1], n_blocks * L)[..., :t_out]
