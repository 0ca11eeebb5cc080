"""v-objective DDIM sampler with the cosine and "crash" schedules.

Port of audio_algebra_tpu/samplers/vddim.py, with `resample_diffusion`
(the img2img partial-noise init). The JAX `fori_loop` is a
Python loop. Per step the schedule value t is computed in f32 and handed
to the model in x's dtype; the update runs in f32 and is cast back to x's
dtype; the last step returns the predicted clean signal. At eta > 0 the
noise comes from the caller's torch.Generator (a fixed seed of 0 when none
is given), so the trajectory differs from JAX's fold-in draws: compare
those by distribution.

`model_fn(x, t, **extra_args)` is any callable. With `aux_mode` (the
turbo amax carry, JAX `_ddim_scan(aux_mode=True)`) it is
`model_fn(x, t, aux, **extra_args) -> (v, aux)`: step 0 runs with
aux=None and each later step takes the previous step's aux.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


def get_alphas_sigmas(t: torch.Tensor):
    """Scaling factors for the signal (alpha) and the noise (sigma) at t."""
    return torch.cos(t * math.pi / 2), torch.sin(t * math.pi / 2)


def alpha_sigma_to_t(alpha, sigma):
    """Inverse of get_alphas_sigmas."""
    return torch.atan2(sigma, alpha) / math.pi * 2


def get_crash_schedule(t: torch.Tensor):
    """The 'crash' schedule warp."""
    sigma = torch.sin(t * math.pi / 2) ** 2
    alpha = (1 - sigma ** 2) ** 0.5
    return alpha_sigma_to_t(alpha, sigma)


def _ddim_loop(model_fn: Callable, x: torch.Tensor, t_steps: torch.Tensor,
               eta: float, generator: Optional[torch.Generator],
               extra_args: dict, aux_mode: bool = False) -> torch.Tensor:
    """Shared denoise loop; t_steps is an (S,) f32 CPU tensor, descending."""
    steps = t_steps.shape[0]
    alphas, sigmas = get_alphas_sigmas(t_steps)
    if eta and generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    aux = None
    for idx in range(steps):
        nxt = min(idx + 1, steps - 1)
        alpha_i, sigma_i = alphas[idx].item(), sigmas[idx].item()
        alpha_n, sigma_n = alphas[nxt].item(), sigmas[nxt].item()
        t = torch.full((x.shape[0],), t_steps[idx].item(), dtype=x.dtype,
                       device=x.device)
        if aux_mode:
            v, aux = model_fn(x, t, aux, **extra_args)
        else:
            v = model_fn(x, t, **extra_args)
        v = v.float()
        xf = x.float()
        pred = xf * alpha_i - v * sigma_i
        if idx == steps - 1:
            return pred.to(x.dtype)
        eps = xf * sigma_i + v * alpha_i
        if eta:
            ddim_sigma = eta * math.sqrt(sigma_n ** 2 / max(sigma_i ** 2, 1e-20)) \
                * math.sqrt(max(1 - alpha_i ** 2 / max(alpha_n ** 2, 1e-20), 0.0))
            adjusted_sigma = math.sqrt(max(sigma_n ** 2 - ddim_sigma ** 2, 0.0))
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=torch.float32)
            x_next = pred * alpha_n + eps * adjusted_sigma + noise * ddim_sigma
        else:
            x_next = pred * alpha_n + eps * sigma_n
        x = x_next.to(x.dtype)
    return x


def crash_steps(steps: int) -> torch.Tensor:
    """The per-step t of `sample`: crash(1 - idx/steps), in f32."""
    idx = torch.arange(steps, dtype=torch.float32)
    return get_crash_schedule(1.0 - idx / steps)


@torch.inference_mode()
def sample(model_fn: Callable, x: torch.Tensor, steps: int, eta: float, logits,
           generator: Optional[torch.Generator] = None, aux_mode: bool = False,
           **extra_args) -> torch.Tensor:
    """Draw samples from noise x with the crash schedule; `logits` is the
    conditioning, passed to the model as `cond`. `aux_mode`: the turbo
    amax-carry model contract (module docstring)."""
    if logits is not None:
        extra_args = dict(extra_args, cond=logits)
    return _ddim_loop(model_fn, x, crash_steps(steps), eta, generator, extra_args,
                      aux_mode=aux_mode)


@torch.inference_mode()
def sample_manual(model_fn: Callable, x: torch.Tensor, steps: int, eta: float,
                  step_list: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  **extra_args) -> torch.Tensor:
    """Linear (or caller-provided) schedule variant."""
    if step_list is None:
        t = torch.linspace(1.0, 0.0, steps + 1, dtype=torch.float32)[:-1]
    else:
        t = torch.as_tensor(step_list, dtype=torch.float32).cpu()
    return _ddim_loop(model_fn, x, t, eta, generator, extra_args)


@torch.inference_mode()
def resample_diffusion(model_fn: Callable, audio_latents: torch.Tensor, steps: int = 100,
                       eta: float = 0.0, noise_level: float = 1.0,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       **extra_args) -> torch.Tensor:
    """img2img-style partial-noise init: noise the latents to `noise_level`
    on the linear schedule, then run its tail. The noise is `noise` when
    given, else a draw from `generator`. The noised latents keep their
    dtype."""
    while audio_latents.dim() < 3:
        audio_latents = audio_latents[None]
    t = np.linspace(0.0, 1.0, steps + 1)
    step_list = torch.tensor(t[t < noise_level], dtype=torch.float32)
    if step_list.shape[0] == 0:
        return audio_latents            # nothing to noise or denoise
    alpha, sigma = get_alphas_sigmas(step_list[-1])
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=audio_latents.device).manual_seed(0)
        noise = torch.randn(audio_latents.shape, generator=generator,
                            device=audio_latents.device, dtype=torch.float32)
    noised = (audio_latents.float() * float(alpha)
              + noise.to(audio_latents.device).float() * float(sigma)).to(audio_latents.dtype)
    tail = step_list.flip(0)[:-1]
    if tail.shape[0] == 0:
        return noised                   # no denoising step left
    return _ddim_loop(model_fn, noised, tail, eta, generator, extra_args)
