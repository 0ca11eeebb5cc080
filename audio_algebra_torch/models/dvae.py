"""DiffusionDVAE — SoundStream-XL encoder + v-diffusion UNet decoder.

Port of audio_algebra_tpu/models/dvae.py. Defaults are the reference
config: capacity 32, c_mults (2, 4, 8, 16, 32), strides (4, 4, 2, 2, 2)
(/128), latent_dim 64, decoder UNet c_mults [256, 256] + [512] * 12 with 4
attention levels. The Memcodes quantizer and the PQMF front-end are not
ported yet: num_quantizers > 0 or pqmf_bands > 1 raise.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .blocks import TURBO_MIN_B
from .soundstream import SoundStreamXLEncoder
from .unet1d import DiffusionAttnUnet1D


class DiffusionDVAE(nn.Module):
    def __init__(self, latent_dim: int = 64, io_channels: int = 2,
                 pqmf_bands: int = 1, num_quantizers: int = 0,
                 capacity: int = 32, c_mults: Sequence[int] = (2, 4, 8, 16, 32),
                 strides: Sequence[int] = (4, 4, 2, 2, 2), n_attn_layers: int = 4,
                 diffusion_c_mults: Sequence[int] = tuple([256, 256] + [512] * 12)):
        super().__init__()
        if num_quantizers > 0:
            raise NotImplementedError("Memcodes quantizers are not ported yet")
        if pqmf_bands > 1:
            raise NotImplementedError("the PQMF front-end is not ported yet")
        self.strides = tuple(strides)
        self.encoder = SoundStreamXLEncoder(
            in_channels=io_channels * pqmf_bands, capacity=capacity,
            latent_dim=latent_dim, c_mults=c_mults, strides=strides)
        self.diffusion = DiffusionAttnUnet1D(
            io_channels=io_channels, cond_dim=latent_dim, pqmf_bands=pqmf_bands,
            n_attn_layers=n_attn_layers, c_mults=diffusion_c_mults)

    @property
    def downsampling_ratio(self) -> int:
        return int(math.prod(self.strides))

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> raw encoder latents (B, latent_dim, T/128)."""
        return self.encoder(audio)

    def encode_it(self, audio: torch.Tensor) -> torch.Tensor:
        """encoder -> tanh."""
        return torch.tanh(self.encode(audio))

    def decode_v(self, x: torch.Tensor, t: torch.Tensor,
                 cond: torch.Tensor) -> torch.Tensor:
        """One UNet forward: the predicted velocity (the sampler's model)."""
        return self.diffusion(x, t, cond)

    def decode_v_aux(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                     q_aux=None, turbo_min_b: int = TURBO_MIN_B):
        """decode_v through the turbo route, in the amax-carry contract:
        returns (v, q_aux_out); q_aux is the previous sampler step's (None
        on the first). See DiffusionAttnUnet1D.forward."""
        return self.diffusion(x, t, cond, q_aux=q_aux, collect_q_aux=True, turbo=True,
                              turbo_min_b=turbo_min_b)
