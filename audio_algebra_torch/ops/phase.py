"""Magnitude + phase-difference spectrogram coding.

Port of audio_algebra_tpu/ops/phase.py: the encode stacks magnitudes and
non-negative phase increments (theta[0] kept at frame 0); the decode
integrates the increments with one cumulative sum along the frame axis.
The random phase origin of init 'rand' is explicit noise: uniform [0, 1)
draws the caller hands in, or draws from a torch.Generator.
"""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def mag_dphase_encode(spec: torch.Tensor, use_cos: bool = False) -> torch.Tensor:
    """Complex (..., C, bins, F) -> stacked (..., 2C, bins, F): C magnitude
    channels, then C phase-increment channels."""
    mag = torch.abs(spec)
    theta = torch.angle(spec)
    if use_cos:
        x, y = spec.real, spec.imag
        mag_tm1 = torch.roll(mag, 1, -1)
        x_tm1, y_tm1 = torch.roll(x, 1, -1), torch.roll(y, 1, -1)
        num, den = x * x_tm1 + y * y_tm1, mag * mag_tm1
        arg = torch.where(den == 0, torch.ones_like(num), num / torch.clamp(den, min=1e-20))
        dtheta = torch.arccos(torch.clamp(arg, -1, 1))
    else:
        dtheta = theta - torch.roll(theta, 1, -1)
        dtheta = torch.where(dtheta < 0, dtheta + TWO_PI, dtheta)
    dtheta = torch.cat([theta[..., :1], dtheta[..., 1:]], dim=-1)
    return torch.cat([mag, dtheta], dim=-3)


def phase_integrate(dtheta: torch.Tensor, init: str = "true",
                    noise: torch.Tensor | None = None,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Integrate phase increments along the frame axis. init 'true' starts
    at dtheta[..., 0]; 'rand' at 2 pi * noise (uniform [0, 1) of shape
    dtheta[..., :1], drawn from `generator` unless given); 'zero' at 0."""
    if init == "true":
        first = dtheta[..., :1]
    elif init == "rand":
        if noise is None:
            noise = torch.rand(dtheta[..., :1].shape, generator=generator,
                               device=dtheta.device, dtype=dtheta.dtype)
        first = torch.as_tensor(noise, device=dtheta.device) * TWO_PI
    elif init == "zero":
        first = torch.zeros_like(dtheta[..., :1])
    else:
        raise ValueError(f"unknown init {init!r}")
    return torch.cumsum(torch.cat([first, dtheta[..., 1:]], dim=-1), dim=-1)


def mag_dphase_decode(reps: torch.Tensor, init: str = "true",
                      noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse of mag_dphase_encode -> complex (..., C, bins, F)."""
    nc = reps.shape[-3] // 2
    mag, dtheta = reps[..., :nc, :, :], reps[..., nc:, :, :]
    theta = phase_integrate(dtheta, init, noise, generator)
    return torch.complex(mag * torch.cos(theta), mag * torch.sin(theta))
