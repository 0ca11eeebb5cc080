"""k-diffusion sampling: VDenoiser, polyexponential sigmas, DPM++(2M).

Port of audio_algebra_tpu/samplers/kdiff.py. The JAX `lax.scan` is a
Python loop. The step coefficients are computed in f32 and cast to x's
dtype before they touch x, so a bf16 x stays bf16 through the loop, as in
JAX (kdiff.py:41-50, :75-93).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


def _in_dtype(c: torch.Tensor, dtype: torch.dtype) -> float:
    """A 0-d f32 coefficient rounded to `dtype`, as a Python float."""
    return float(c.to(dtype))


class VDenoiser:
    """A v-objective model as a Karras-style denoiser (sigma_data = 1):
    denoised = c_skip * x + c_out * model(c_in * x, t(sigma)),
    t = atan(sigma) * 2 / pi."""

    def __init__(self, model_fn: Callable, sigma_data: float = 1.0):
        self.model_fn = model_fn
        self.sigma_data = sigma_data

    def sigma_to_t(self, sigma):
        return torch.atan(sigma / self.sigma_data) / math.pi * 2

    def t_to_sigma(self, t):
        return torch.tan(t * math.pi / 2) * self.sigma_data

    def __call__(self, x, sigma, **kwargs):
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        sd2 = self.sigma_data ** 2
        total = sigma ** 2 + sd2
        shape = (-1,) + (1,) * (x.ndim - 1)
        c_skip = (sd2 / total).to(x.dtype).reshape(shape)
        c_out = (-sigma * self.sigma_data / torch.sqrt(total)).to(x.dtype).reshape(shape)
        c_in = (1.0 / torch.sqrt(total)).to(x.dtype).reshape(shape)
        v = self.model_fn(x * c_in, self.sigma_to_t(sigma).to(x.dtype), **kwargs)
        return x * c_skip + v.to(x.dtype) * c_out


def get_sigmas_polyexponential(n: int, sigma_min: float, sigma_max: float,
                               rho: float = 1.0) -> torch.Tensor:
    """Polyexponential sigma schedule, descending, with a trailing 0; an
    (n + 1,) f32 CPU tensor."""
    ramp = np.linspace(1, 0, n) ** rho
    sigmas = np.exp(ramp * (math.log(sigma_max) - math.log(sigma_min))
                    + math.log(sigma_min))
    return torch.tensor(np.append(sigmas, 0.0), dtype=torch.float32)


@torch.inference_mode()
def sample_dpmpp_2m(denoiser: Callable, x: torch.Tensor, sigmas: torch.Tensor,
                    extra_args: Optional[dict] = None) -> torch.Tensor:
    """DPM-Solver++(2M) (k-diffusion's sample_dpmpp_2m); sigmas is an f32
    CPU tensor."""
    extra_args = extra_args or {}
    sigmas = sigmas.float().cpu()
    t_of = -torch.log(sigmas.clamp(min=1e-20))              # t_fn, in f32
    old_denoised = None
    for i in range(sigmas.shape[0] - 1):
        sigma = torch.full((x.shape[0],), float(sigmas[i]), dtype=torch.float32,
                           device=x.device)
        denoised = denoiser(x, sigma, **extra_args)
        t, t_next = t_of[i], t_of[i + 1]
        h = t_next - t
        if i == 0 or float(sigmas[i + 1]) == 0.0:
            denoised_d = denoised
        else:
            r = (t - t_of[i - 1]) / h
            ca = _in_dtype(1 + 1 / (2 * r), x.dtype)
            cb = _in_dtype(1 / (2 * r), x.dtype)
            denoised_d = ca * denoised - cb * old_denoised
        x = _in_dtype(torch.exp(-t_next) / torch.exp(-t), x.dtype) * x \
            - _in_dtype(torch.expm1(-h), x.dtype) * denoised_d
        old_denoised = denoised
    return x


def kdiff_sample(model_fn: Callable, latents: torch.Tensor, steps: int,
                 eta: float = 0.0, sigma_min: float = 0.11, sigma_max: float = 50.0,
                 **extra_args) -> torch.Tensor:
    """Scale unit noise by sigma_max, run DPM++(2M) over polyexponential
    sigmas, clamp to [-1, 1]. `eta` is accepted for the reference's call
    signature and unused, as there."""
    denoiser = VDenoiser(model_fn)
    sigmas = get_sigmas_polyexponential(steps, sigma_min, sigma_max)
    x = latents * _in_dtype(sigmas[0], latents.dtype)
    out = sample_dpmpp_2m(denoiser, x, sigmas, extra_args=extra_args)
    return torch.clamp(out, -1.0, 1.0)
