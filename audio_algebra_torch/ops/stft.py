"""STFT / iSTFT / Griffin-Lim.

Port of audio_algebra_tpu/ops/stft.py. Semantics match torchaudio's
transforms with their defaults: periodic Hann window, center=True with
reflect padding, onesided, un-normalised forward, window-envelope
normalised inverse. Layout as torch.stft: (..., n_bins, F). The reflect
padding is numpy's (`reflect_pad`), so any T >= 1 has its frames, as in
JAX: a clip no longer than the pad reflects again.

`stft` with the default window goes through kernel K6
(ops/stft_kernel.py): on a CUDA tensor the hand-written CUDA kernel of
`csrc/stft.cu`, at any hop; on a CPU tensor its plain twin, the matmul
formulation below. A custom window takes the plain formulation, as the JAX
package takes XLA then. The inverse is a matmul iDFT plus overlap-add,
outside any kernel as in JAX. Every product runs in full f32 (JAX:
Precision.HIGHEST); a TF32 product would break the 1e-9 round trip.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import full_f32


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window's default), from float64."""
    k = np.arange(n)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)
    return torch.as_tensor(w, dtype=dtype, device=device)


@functools.lru_cache(maxsize=16)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag onesided DFT analysis bases (n_fft, n_bins), built in
    float64 then cast: X[k] = sum_n x[n] (cos(-2 pi k n / N) + i sin(...))."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _idft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_bins, n_fft) bases from onesided (re, im) back to time frames:
    x[n] = (1/N) sum_k w_k (Re[k] cos(2 pi k n / N) - Im[k] sin(...)),
    w_k = 1 at DC and Nyquist, else 2."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(n_bins)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    weight = np.full((n_bins, 1), 2.0)
    weight[0] = 1.0
    if n_fft % 2 == 0:
        weight[-1] = 1.0
    cos_b = (weight * np.cos(ang) / n_fft).astype(np.float32)
    sin_b = (-weight * np.sin(ang) / n_fft).astype(np.float32)
    return cos_b, sin_b


_DEVICE_TABLES: dict = {}


def device_table(name: str, make, device) -> torch.Tensor:
    """A constant f32 table (numpy, from `make()`) held once per device."""
    key = (name, str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(make(), np.float32)).to(device)
        _DEVICE_TABLES[key] = t
    return t


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) -> overlapping frames (..., F, n_fft), F = 1 + (T - n_fft) // hop
    (a strided view)."""
    return x.unfold(-1, n_fft, hop)


@functools.lru_cache(maxsize=64)
def _reflect_index(t_len: int, pad: int, device: torch.device) -> torch.Tensor:
    """The source sample of each of the t_len + 2 pad padded positions:
    i in [-pad, t_len + pad) folded with period P = 2 (t_len - 1), j = i
    mod P, then P - j where j >= t_len. That reflects as many times as the
    pad needs, as numpy's (and jnp.pad's) mode="reflect" does; a single
    sample (P = 0) maps every position to it."""
    i = np.arange(-pad, t_len + pad)
    if t_len == 1:
        j = np.zeros_like(i)
    else:
        period = 2 * (t_len - 1)
        j = np.mod(i, period)
        j = np.where(j >= t_len, period - j, j)
    return torch.as_tensor(j, dtype=torch.int64, device=device)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by `pad` on both sides (edge excluded), at
    any pad, by a gather (its VJP a scatter-add)."""
    if pad == 0:
        return x
    return x.index_select(-1, _reflect_index(x.shape[-1], pad, x.device))


def _pow(x: torch.Tensor, p: float) -> torch.Tensor:
    """x ** p with the exact cheap forms of the common exponents."""
    if p == 1.0:
        return x
    if p == 2.0:
        return torch.square(x)
    if p == 0.5:
        return torch.sqrt(x)
    return torch.exp(p * torch.log(torch.clamp(x, min=1e-30)))


def stft_plain(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
               window: torch.Tensor | None = None, center: bool = True) -> torch.Tensor:
    """The matmul formulation: frames (window applied) @ DFT bases, in
    full f32. complex64 (..., n_bins, F)."""
    if window is None:
        window = hann_window(n_fft, x.dtype, x.device)
    if center:
        x = reflect_pad(x, n_fft // 2)
    frames = frame_signal(x, n_fft, hop_length) * window      # (..., F, n_fft)
    cos_b = device_table(f"dft_cos{n_fft}", lambda: _dft_bases(n_fft)[0], x.device)
    sin_b = device_table(f"dft_sin{n_fft}", lambda: _dft_bases(n_fft)[1], x.device)
    with full_f32():
        re = torch.matmul(frames.float(), cos_b)
        im = torch.matmul(frames.float(), sin_b)
    return torch.complex(re, im).transpose(-1, -2)             # (..., n_bins, F)


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
         window: torch.Tensor | None = None, center: bool = True) -> torch.Tensor:
    """Complex STFT of (..., T) -> complex64 (..., n_bins, F). The default
    Hann window goes through K6 (the CUDA kernel on the card, its twin on
    the CPU); a custom window takes the plain formulation."""
    if window is None:
        from . import stft_kernel
        return stft_kernel.stft_fused(x, n_fft, hop_length, center)
    return stft_plain(x, n_fft, hop_length, window, center)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add (..., F, n_fft) -> (..., (F - 1) * hop + n_fft): each
    frame split into r = n_fft / hop chunks, r shifted adds (n_fft % hop
    must be 0, as in JAX)."""
    *batch, n_frames, n_fft = frames.shape
    if n_fft % hop != 0:
        raise NotImplementedError(
            f"overlap-add needs n_fft % hop == 0 (got n_fft={n_fft}, hop={hop})")
    r = n_fft // hop
    chunks = frames.reshape(*batch, n_frames, r, hop)
    out = frames.new_zeros((*batch, n_frames + r - 1, hop))
    for j in range(r):
        out[..., j:j + n_frames, :] = out[..., j:j + n_frames, :] + chunks[..., :, j, :]
    return out.reshape(*batch, (n_frames + r - 1) * hop)


def istft(spec: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
          window: torch.Tensor | None = None, center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT of complex (..., n_bins, F) -> (..., T): matmul iDFT,
    overlap-add, window-envelope normalisation (floor 1e-11)."""
    dev = spec.device
    if window is None:
        window = hann_window(n_fft, device=dev)
    spec = spec.transpose(-1, -2)                              # (..., F, n_bins)
    cos_b = device_table(f"idft_cos{n_fft}", lambda: _idft_bases(n_fft)[0], dev)
    sin_b = device_table(f"idft_sin{n_fft}", lambda: _idft_bases(n_fft)[1], dev)
    with full_f32():
        frames = torch.matmul(spec.real, cos_b) + torch.matmul(spec.imag, sin_b)
    frames = frames * window
    y = _overlap_add(frames, hop_length)
    n_frames = spec.shape[-2]
    win_sq = (window * window).expand(n_frames, n_fft)
    envelope = _overlap_add(win_sq, hop_length)
    y = y / torch.clamp(envelope, min=1e-11)
    if center:
        y = y[..., n_fft // 2: y.shape[-1] - n_fft // 2]
    if length is not None:
        if y.shape[-1] >= length:
            y = y[..., :length]
        else:
            y = F.pad(y, (0, length - y.shape[-1]))
    return y


def spectrogram(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                power: float | None = None, center: bool = True) -> torch.Tensor:
    """torchaudio Spectrogram: power None -> complex, 1 -> magnitude,
    2 -> power."""
    s = stft(x, n_fft=n_fft, hop_length=hop_length, center=center)
    if power is None:
        return s
    mag = torch.abs(s)
    return mag if power == 1.0 else _pow(mag, power)


def inverse_spectrogram(spec: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                        center: bool = True, length: int | None = None) -> torch.Tensor:
    """torchaudio InverseSpectrogram (complex input)."""
    return istft(spec, n_fft=n_fft, hop_length=hop_length, center=center, length=length)


def griffin_lim(specgram: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                power: float = 2.0, n_iter: int = 32, momentum: float = 0.99,
                length: int | None = None, init_angle: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Griffin-Lim phase recovery with momentum (torchaudio GriffinLim):
    n_iter rounds of iSTFT -> STFT (one K6 launch each), then a last iSTFT.

    The initial angles are `init_angle` (radians, specgram's shape) or
    uniform on [0, 2 pi) drawn from `generator`; the JAX package draws them
    from a key instead."""
    mag = _pow(specgram, 1.0 / power)
    if init_angle is None:
        init_angle = torch.rand(mag.shape, generator=generator, device=mag.device,
                                dtype=torch.float32) * (2 * math.pi)
    init_angle = torch.as_tensor(init_angle, device=mag.device)
    spec = torch.complex(mag * torch.cos(init_angle), mag * torch.sin(init_angle))
    prev = torch.zeros_like(spec)
    for _ in range(n_iter):
        inv = istft(spec, n_fft=n_fft, hop_length=hop_length)
        rebuilt = stft(inv, n_fft=n_fft, hop_length=hop_length)
        tprev = rebuilt - (momentum / (1 + momentum)) * prev
        angle = tprev / torch.clamp(torch.abs(tprev), min=1e-16)
        spec = mag * angle
        prev = rebuilt
    return istft(spec, n_fft=n_fft, hop_length=hop_length, length=length)
