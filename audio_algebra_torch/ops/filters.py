"""IIR filter design and application on the host (numpy and scipy).

Port of the host half of audio_algebra_tpu/ops/filters.py, what the
effects dataset's filters run per item: RBJ biquads
(`biquad_coeffs_np`), Butterworth cascades of them (`butter_sos_np`) and
scipy's `sosfilt` (`sosfilt_np`). The traced, on-device half (biquad
design from traced cutoffs, the associative-scan `sosfilt`) is not ported.
"""
from __future__ import annotations

import math

import numpy as np


def biquad_coeffs_np(kind: str, cutoff_hz: float, sample_rate: int,
                     q: float = 0.7071067811865476) -> tuple:
    """RBJ cookbook biquad (lowpass, highpass or notch): (b, a), each (3,),
    normalised so that a[0] == 1."""
    w0 = 2.0 * math.pi * float(cutoff_hz) / sample_rate
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / (2.0 * q)
    if kind == "lowpass":
        b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2])
        a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    elif kind == "highpass":
        b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
        a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    elif kind == "notch":
        b = np.array([1.0, -2 * cw, 1.0])
        a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    else:
        raise ValueError(kind)
    return b / a[0], a / a[0]


def butter_sos_np(order: int, cutoff_hz, sample_rate: int, btype: str = "lowpass"):
    """Butterworth second-order sections, (n_sections, 6) float64. Low and
    high pass: order rounded up to even, one biquad per pole pair; band
    pass: high pass at the low edge then low pass at the high edge; band
    stop: order // 2 notches at the geometric centre."""
    if btype in ("lowpass", "highpass"):
        n = order if order % 2 == 0 else order + 1
        secs = []
        for k in range(n // 2):
            q = 1.0 / (2.0 * math.sin(math.pi * (2 * k + 1) / (2.0 * n)))
            b, a = biquad_coeffs_np(btype, cutoff_hz, sample_rate, q=q)
            secs.append(np.concatenate([b, a]))
        return np.stack(secs)
    if btype == "bandpass":
        low, high = cutoff_hz
        return np.concatenate([
            butter_sos_np(order, low, sample_rate, "highpass"),
            butter_sos_np(order, high, sample_rate, "lowpass")], 0)
    if btype == "bandstop":
        low, high = cutoff_hz
        center = math.sqrt(float(low) * float(high))
        q = center / max(float(high) - float(low), 1e-3)
        b, a = biquad_coeffs_np("notch", center, sample_rate, q=q)
        sec = np.concatenate([b, a])
        return np.stack([sec] * max(order // 2, 1))
    raise ValueError(btype)


def sosfilt_np(sos, x):
    """scipy's sosfilt over the last axis, in x's dtype."""
    import scipy.signal

    return scipy.signal.sosfilt(sos, x, axis=-1).astype(x.dtype)
