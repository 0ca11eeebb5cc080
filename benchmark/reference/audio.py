"""Plain reference of what the service does to generated audio before it
answers: the batch's crossfade into one stream (sine ramps of 1.5 s) and
the 16-bit PCM conversion of its WAV (clip to [-1, 1], scale by 32767,
truncate toward zero)."""
from __future__ import annotations

import numpy as np


def crossfade_flatten(fakes, sr: int = 48000, fade_secs: float = 1.5) -> np.ndarray:
    fakes = np.asarray(fakes, dtype=np.float32)
    b, c, n = fakes.shape
    if b == 1:
        return fakes[0]
    ov = min(int(fade_secs * sr), n // 2)
    fade_in = np.sin(0.5 * np.pi * np.linspace(0.0, 1.0, ov, dtype=np.float32))
    out = np.zeros((c, b * n - (b - 1) * ov), dtype=np.float32)
    pos = 0
    for i in range(b):
        seg = fakes[i].copy()
        if i > 0:
            seg[:, :ov] *= fade_in
        if i < b - 1:
            seg[:, -ov:] *= fade_in[::-1]
        out[:, pos:pos + n] += seg
        pos += n - ov
    return out


def pcm16(audio: np.ndarray) -> np.ndarray:
    """(C, N) float -> (C, N) int16 as a 16-bit WAV holds it."""
    return (np.clip(np.asarray(audio, np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
