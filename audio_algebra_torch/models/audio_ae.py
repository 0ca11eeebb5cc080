"""AudioAutoencoder — the first-stage waveform AE under the stacked models.

Port of audio_algebra_tpu/models/audio_ae.py: capacity 64, c_mults
[2, 4, 8, 16, 32], strides [2] * 5, latent_dim 32 (downsampling ratio
32). encode tanh-bounds the encoder's latents; decode is the SoundStream-XL
decoder. Submodules are named `encoder` and `decoder`, as in flax.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .soundstream import SoundStreamXLDecoder, SoundStreamXLEncoder


class AudioAutoencoder(nn.Module):
    def __init__(self, capacity: int = 64, c_mults: Sequence[int] = (2, 4, 8, 16, 32),
                 strides: Sequence[int] = (2, 2, 2, 2, 2), latent_dim: int = 32,
                 io_channels: int = 2):
        super().__init__()
        self.strides = tuple(strides)
        self.encoder = SoundStreamXLEncoder(in_channels=io_channels, capacity=capacity,
                                            latent_dim=latent_dim, c_mults=c_mults,
                                            strides=strides)
        self.decoder = SoundStreamXLDecoder(out_channels=io_channels, capacity=capacity,
                                            latent_dim=latent_dim, c_mults=c_mults,
                                            strides=strides)

    @property
    def downsampling_ratio(self) -> int:
        return int(math.prod(self.strides))

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> tanh-bounded latents (B, latent_dim, T / ratio)."""
        return torch.tanh(self.encoder(audio))

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, latent_dim, T') -> (B, C, T' * ratio)."""
        return self.decoder(latents)
