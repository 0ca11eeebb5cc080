"""given_models — the DVAE wrapper of the Destructo path.

Port of audio_algebra_tpu/given_models.py:DVAEWrapper. encode: encoder ->
tanh, and a fresh decode noise is drawn (as the reference does); decode:
v-DDIM `sample` from that noise conditioned on the latents, then the
'b d n -> d (b n)' flatten. The noise is an attribute the caller may set
(`w.noise = ...`, shape (B, 2, sample_size)).

The wrapper holds one set of weights, the ones inference uses (the JAX
wrapper's `params_ema`). Without a checkpoint they are the seeded random
weights of utils/params.random_init_; `load_flax_params(tree)` loads a
flax params tree instead. The other given models come with later slices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .models.dvae import DiffusionDVAE
from .samplers.vddim import sample as vddim_sample
from .utils import params as params_mod

__all__ = ["DVAEWrapper"]


class DVAEWrapper:
    DEFAULT_ARGS = {"num_quantizers": 0, "sample_size": 65536, "demo_steps": 50,
                    "sample_rate": 48000, "latent_dim": 64, "pqmf_bands": 1}

    def __init__(self, args_dict: Optional[dict] = None,
                 model_kwargs: Optional[dict] = None, seed: int = 0,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        args = dict(self.DEFAULT_ARGS)
        args.update(args_dict or {})
        self.seed = seed
        self.model = DiffusionDVAE(
            latent_dim=args["latent_dim"], pqmf_bands=args["pqmf_bands"],
            num_quantizers=args["num_quantizers"], **(model_kwargs or {}))
        self.model.eval()
        self._loaded = False
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.noise: Optional[torch.Tensor] = None
        self.demo_steps = args["demo_steps"]
        self.demo_samples = args["sample_size"]

    def load_flax_params(self, tree: dict) -> None:
        """Load a flax params tree (e.g. the JAX wrapper's params_ema)."""
        params_mod.load_flax_params(self.model, tree)
        self.model.to(self.device, self.dtype)
        self._loaded = True

    def ensure_params(self) -> None:
        """Random-initialise the weights (seeded) unless some were loaded."""
        if not self._loaded:
            params_mod.random_init_(self.model, self.seed)
            self.model.to(self.device, self.dtype)
            self._loaded = True

    def _as_input(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device, self.dtype)

    def _draw_noise(self, batch: int) -> torch.Tensor:
        return torch.randn((batch, 2, self.demo_samples), generator=self.generator,
                           device=self.device, dtype=torch.float32).to(self.dtype)

    @torch.inference_mode()
    def encode(self, waveform) -> torch.Tensor:
        """(B, 2, T) audio -> (B, latent_dim, T/128) tanh latents."""
        waveform = self._as_input(waveform)
        self.demo_samples = waveform.shape[-1]
        self.ensure_params()
        reps = self.model.encode_it(waveform)
        self.noise = self._draw_noise(waveform.shape[0])
        return reps

    @torch.inference_mode()
    def decode(self, reps, demo_steps: Optional[int] = None) -> torch.Tensor:
        """Latents (B, latent_dim, n) -> audio (2, B * sample_size)."""
        if demo_steps is None:
            demo_steps = self.demo_steps
        self.ensure_params()
        reps = self._as_input(reps)
        noise = self.noise
        if noise is None or noise.shape[0] != reps.shape[0]:
            noise = self._draw_noise(reps.shape[0])
        fakes = vddim_sample(self.model.decode_v, self._as_input(noise),
                             demo_steps, 0, reps)
        b, d, n = fakes.shape                     # 'b d n -> d (b n)'
        return fakes.transpose(0, 1).reshape(d, b * n)
