"""Plain reference samplers, in f32: the v-objective DDIM with the "crash"
schedule (eta 0, the last step returning the predicted clean signal) and
k-diffusion's DPM-Solver++(2M) over polyexponential sigmas through a
v-objective denoiser (sigma_data 1)."""
from __future__ import annotations

import math

import numpy as np
import torch


def crash_steps(steps: int) -> torch.Tensor:
    """t of each step: crash(1 - idx / steps)."""
    t = 1.0 - torch.arange(steps, dtype=torch.float64) / steps
    sigma = torch.sin(t * math.pi / 2) ** 2
    alpha = (1 - sigma ** 2) ** 0.5
    return torch.atan2(sigma, alpha) / math.pi * 2


def vddim_sample(model_fn, x, steps: int, cond):
    """Deterministic v-DDIM from noise x; model_fn(x, t, cond) -> v."""
    ts = crash_steps(steps)
    alphas, sigmas = torch.cos(ts * math.pi / 2), torch.sin(ts * math.pi / 2)
    for i in range(steps):
        t = torch.full((x.shape[0],), float(ts[i]), dtype=x.dtype, device=x.device)
        v = model_fn(x, t, cond)
        pred = x * float(alphas[i]) - v * float(sigmas[i])
        if i == steps - 1:
            return pred
        eps = x * float(sigmas[i]) + v * float(alphas[i])
        x = pred * float(alphas[i + 1]) + eps * float(sigmas[i + 1])
    return x


def polyexponential_sigmas(n: int, sigma_min: float, sigma_max: float, rho: float = 1.0):
    ramp = np.linspace(1, 0, n) ** rho
    sigmas = np.exp(ramp * (math.log(sigma_max) - math.log(sigma_min)) + math.log(sigma_min))
    return np.append(sigmas, 0.0)


def dpmpp_2m_sample(model_fn, noise, steps: int, sigma_min: float = 0.11,
                    sigma_max: float = 50.0, **extra):
    """DPM++(2M) of a v-model model_fn(x, t, **extra): scale unit noise by
    sigma_max, run the solver, clamp to [-1, 1]."""
    sigmas = polyexponential_sigmas(steps, sigma_min, sigma_max)
    x = noise * sigmas[0]
    old = None
    for i in range(steps):
        s = sigmas[i]
        total = s * s + 1.0
        t = torch.full((x.shape[0],), math.atan(s) / math.pi * 2, dtype=x.dtype,
                       device=x.device)
        v = model_fn(x / math.sqrt(total), t, **extra)
        denoised = x / total - v * (s / math.sqrt(total))
        t_cur, t_next = -math.log(s), -math.log(max(sigmas[i + 1], 1e-20))
        h = t_next - t_cur
        if i == 0 or sigmas[i + 1] == 0.0:
            d = denoised
        else:
            r = (t_cur + math.log(sigmas[i - 1])) / h
            d = (1 + 1 / (2 * r)) * denoised - (1 / (2 * r)) * old
        x = (sigmas[i + 1] / s) * x - math.expm1(-h) * d
        old = denoised
    return torch.clamp(x, -1.0, 1.0)
