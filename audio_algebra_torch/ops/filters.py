"""IIR filter design and application: on tensors, and on the host.

Port of audio_algebra_tpu/ops/filters.py. The tensor half designs RBJ
biquads (`biquad_coeffs`) and Butterworth cascades of them (`butter_sos`)
in closed form, so cutoffs may be tensors (one per row of a knob sweep),
and applies second-order sections with `sosfilt` over kernel R1
(ops/recurrence.sosfilt_rows: the CUDA kernel on the card, the associative
scan of JAX's default `_biquad_assoc` on the CPU). The host half, what the
effects dataset's filters run per item, is numpy and scipy:
`biquad_coeffs_np`, `butter_sos_np` and `sosfilt_np`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .recurrence import sosfilt_rows


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def biquad_coeffs(kind: str, cutoff_hz, sample_rate, q=0.7071067811865476, gain_db=0.0):
    """RBJ cookbook biquad in f32: (b, a), each (..., 3) over the shape of
    the tensor arguments, a[..., 0] == 1. kinds: 'lowpass', 'highpass',
    'bandpass' (0 dB peak), 'notch', 'peak', 'lowshelf', 'highshelf'."""
    cutoff = _f32(cutoff_hz)
    w0 = 2.0 * math.pi * cutoff / sample_rate
    cw, sw = torch.cos(w0), torch.sin(w0)
    alpha = sw / (2.0 * q)
    A = 10.0 ** (_f32(gain_db, cutoff.device) / 40.0)
    stack = lambda *v: torch.stack(torch.broadcast_tensors(*v), -1)   # noqa: E731
    if kind == "lowpass":
        b = stack((1 - cw) / 2, 1 - cw, (1 - cw) / 2)
        a = stack(1 + alpha, -2 * cw, 1 - alpha)
    elif kind == "highpass":
        b = stack((1 + cw) / 2, -(1 + cw), (1 + cw) / 2)
        a = stack(1 + alpha, -2 * cw, 1 - alpha)
    elif kind == "bandpass":
        b = stack(alpha, torch.zeros_like(alpha), -alpha)
        a = stack(1 + alpha, -2 * cw, 1 - alpha)
    elif kind == "notch":
        one = torch.ones_like(alpha)
        b = stack(one, -2 * cw, one)
        a = stack(1 + alpha, -2 * cw, 1 - alpha)
    elif kind == "peak":
        b = stack(1 + alpha * A, -2 * cw, 1 - alpha * A)
        a = stack(1 + alpha / A, -2 * cw, 1 - alpha / A)
    elif kind == "lowshelf":
        sq = 2 * torch.sqrt(A) * alpha
        b = stack(A * ((A + 1) - (A - 1) * cw + sq), 2 * A * ((A - 1) - (A + 1) * cw),
                  A * ((A + 1) - (A - 1) * cw - sq))
        a = stack((A + 1) + (A - 1) * cw + sq, -2 * ((A - 1) + (A + 1) * cw),
                  (A + 1) + (A - 1) * cw - sq)
    elif kind == "highshelf":
        sq = 2 * torch.sqrt(A) * alpha
        b = stack(A * ((A + 1) + (A - 1) * cw + sq), -2 * A * ((A - 1) + (A + 1) * cw),
                  A * ((A + 1) + (A - 1) * cw - sq))
        a = stack((A + 1) - (A - 1) * cw + sq, 2 * ((A - 1) - (A + 1) * cw),
                  (A + 1) - (A - 1) * cw - sq)
    else:
        raise ValueError(f"unknown biquad kind {kind!r}")
    return b / a[..., :1], a / a[..., :1]


def butter_sos(order: int, cutoff_hz, sample_rate, btype: str = "lowpass") -> torch.Tensor:
    """Butterworth sections (..., n_sections, 6) in f32 over the cutoffs'
    shape, (b0, b1, b2, 1, a1, a2) each. Low and high pass: the order
    rounded up to even, one biquad a pole pair (Q = 1 / (2 sin((2k + 1) pi
    / 2n))); band pass: a high pass at the low edge, then a low pass at the
    high edge; band stop: order // 2 notches at the geometric centre."""
    if btype in ("lowpass", "highpass"):
        n = order if order % 2 == 0 else order + 1
        secs = []
        for k in range(n // 2):
            q = 1.0 / (2.0 * math.sin(math.pi * (2 * k + 1) / (2.0 * n)))
            b, a = biquad_coeffs(btype, cutoff_hz, sample_rate, q=q)
            secs.append(torch.cat([b, a], -1))
        return torch.stack(secs, -2)
    if btype == "bandpass":
        low, high = cutoff_hz
        hp = butter_sos(order, low, sample_rate, "highpass")
        lp = butter_sos(order, high, sample_rate, "lowpass")
        lead = torch.broadcast_shapes(hp.shape[:-2], lp.shape[:-2])
        return torch.cat([hp.expand(*lead, *hp.shape[-2:]),
                          lp.expand(*lead, *lp.shape[-2:])], -2)
    if btype == "bandstop":
        low, high = cutoff_hz
        center = torch.sqrt(_f32(low) * high)
        q = center / torch.clamp(high - _f32(low), min=1e-3)
        b, a = biquad_coeffs("notch", center, sample_rate, q=q)
        sec = torch.cat([b, a], -1)
        return torch.stack([sec] * max(order // 2, 1), -2)
    raise ValueError(f"unknown btype {btype!r}")


def sosfilt(sos, x) -> torch.Tensor:
    """Apply second-order sections `sos` (..., n_sections, 6) along the last
    axis of x (..., T) from zero state, through kernel R1. The sections'
    leading shape broadcasts against x's: a (K, 1, 1, n, 6) knob sweep over
    x (B, C, T) gives (K, B, C, T). Returns f32."""
    x = torch.as_tensor(x)
    sos = _f32(sos, x.device)
    lead = torch.broadcast_shapes(sos.shape[:-2], x.shape[:-1])
    t_len, n_sec = x.shape[-1], sos.shape[-2]
    rows = x.float().expand(*lead, t_len).reshape(-1, t_len)
    if sos.dim() == 2:
        coef = sos[None]
    else:
        coef = sos.expand(*lead, n_sec, 6).reshape(-1, n_sec, 6)
    return sosfilt_rows(coef, rows).reshape(*lead, t_len)


def apply_gain_db(x, gain_db):
    return x * (10.0 ** (_f32(gain_db, x.device) / 20.0))


def lowpass(x, cutoff_hz, sample_rate, order: int = 4):
    return sosfilt(butter_sos(order, cutoff_hz, sample_rate, "lowpass"), x)


def highpass(x, cutoff_hz, sample_rate, order: int = 4):
    return sosfilt(butter_sos(order, cutoff_hz, sample_rate, "highpass"), x)


def bandpass(x, low_hz, high_hz, sample_rate, order: int = 4):
    return sosfilt(butter_sos(order, (low_hz, high_hz), sample_rate, "bandpass"), x)


def bandstop(x, low_hz, high_hz, sample_rate, order: int = 4):
    return sosfilt(butter_sos(order, (low_hz, high_hz), sample_rate, "bandstop"), x)


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
