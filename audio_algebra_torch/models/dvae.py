"""DiffusionDVAE — SoundStream-XL encoder + v-diffusion UNet decoder.

Port of audio_algebra_tpu/models/dvae.py. Defaults are the reference
config: capacity 32, c_mults (2, 4, 8, 16, 32), strides (4, 4, 2, 2, 2)
(/128), latent_dim 64, decoder UNet c_mults [256, 256] + [512] * 12 with 4
attention levels. `pqmf_bands > 1` puts a PQMF analysis (ops/pqmf.py, 70
dB) in front of the encoder; `num_quantizers` 1 adds a Memcodes
quantizer, more a ResidualMemcodes (models/memcodes.py). encode_it is
pqmf -> encoder -> optional quantize -> tanh, as in JAX.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.pqmf import PQMF
from .blocks import TURBO_MIN_B
from .memcodes import Memcodes, ResidualMemcodes
from .soundstream import SoundStreamXLEncoder
from .unet1d import DiffusionAttnUnet1D


class DiffusionDVAE(nn.Module):
    ENCODER_PARTS = ("encoder", "quantizer")   # what encode() and encode_it() read

    def __init__(self, latent_dim: int = 64, io_channels: int = 2,
                 pqmf_bands: int = 1, num_quantizers: int = 0, num_heads: int = 8,
                 codebook_size: int = 1024, capacity: int = 32, c_mults: Sequence[int] = (2, 4, 8, 16, 32),
                 strides: Sequence[int] = (4, 4, 2, 2, 2), n_attn_layers: int = 4,
                 diffusion_c_mults: Sequence[int] = tuple([256, 256] + [512] * 12)):
        super().__init__()
        self.pqmf_bands, self.num_quantizers = pqmf_bands, num_quantizers
        self.strides = tuple(strides)
        self.encoder = SoundStreamXLEncoder(
            in_channels=io_channels * pqmf_bands, capacity=capacity,
            latent_dim=latent_dim, c_mults=c_mults, strides=strides)
        self.diffusion = DiffusionAttnUnet1D(
            io_channels=io_channels, cond_dim=latent_dim, pqmf_bands=pqmf_bands,
            n_attn_layers=n_attn_layers, c_mults=diffusion_c_mults)
        if num_quantizers > 1:
            self.quantizer = ResidualMemcodes(dim=latent_dim, heads=num_heads,
                                              num_codes=codebook_size,
                                              num_quantizers=num_quantizers)
        elif num_quantizers == 1:
            self.quantizer = Memcodes(dim=latent_dim, heads=num_heads, num_codes=codebook_size)
        self.pqmf = PQMF(pqmf_bands, 70) if pqmf_bands > 1 else None

    @property
    def downsampling_ratio(self) -> int:
        return int(math.prod(self.strides))

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> raw encoder latents (B, latent_dim, T/128)."""
        x = audio if self.pqmf is None else self.pqmf.analysis(audio)
        return self.encoder(x)

    def encode_it(self, audio: torch.Tensor) -> torch.Tensor:
        """pqmf -> encoder -> optional quantize -> tanh."""
        emb = self.encode(audio)
        if self.num_quantizers > 0:
            emb, _ = self.quantizer(emb.transpose(1, 2))   # Memcodes takes (b, n, d)
            emb = emb.transpose(1, 2)
        return torch.tanh(emb)

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
