"""Stacked latent diffusion models (the MIRAGE generative stack).

Port of audio_algebra_tpu/models/stacked.py:

* LatentAudioDiffusionAutoencoder: the stage-2 AE over the first-stage
  AudioAutoencoder's latents: Encoder1d (32 -> 32, /16) and a
  DiffusionAttnUnet1D (io 32, cond 32, depth 10, c_mults [512] * 10, no
  attention). encode = AE.encode -> latent_encoder -> tanh; the decode
  path is the v-diffusion (`diffusion_v`, the sampler's model) and
  `decode_first_stage` (the AE decoder). The module carries every
  submodule of the flax tree (the AE encoder and Encoder1d too), so the
  seeded random weights and the flax bridge see the same leaves.
* StackedAELatentDiffusionCond: UNetCFG1d over the 32-d stage-2 latents
  with 512-d context embeddings (the songs configuration by default).

Training (v_objective_loss) comes with a later slice.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .audio_ae import AudioAutoencoder
from .encoder1d import Encoder1d
from .unet1d import DiffusionAttnUnet1D
from .unet_cfg1d import UNetCFG1d


class LatentAudioDiffusionAutoencoder(nn.Module):
    def __init__(self, latent_dim: int = 32, second_stage_latent_dim: int = 32,
                 factors: Sequence[int] = (2, 2, 2, 2), ae_capacity: int = 64,
                 ae_c_mults: Sequence[int] = (2, 4, 8, 16, 32),
                 ae_strides: Sequence[int] = (2, 2, 2, 2, 2),
                 latent_channels: int = 128,
                 latent_multipliers: Sequence[int] = (1, 2, 4, 8, 8),
                 latent_num_blocks: Sequence[int] = (8, 8, 8, 8),
                 diffusion_c_mults: Sequence[int] = tuple([512] * 10),
                 diffusion_depth: int = 10):
        super().__init__()
        self.latent_dim = latent_dim
        self.second_stage_latent_dim = second_stage_latent_dim
        self.factors = tuple(factors)
        self.autoencoder = AudioAutoencoder(capacity=ae_capacity, c_mults=ae_c_mults,
                                            strides=ae_strides, latent_dim=latent_dim)
        self.latent_encoder = Encoder1d(
            in_channels=latent_dim, out_channels=second_stage_latent_dim,
            channels=latent_channels, multipliers=latent_multipliers,
            factors=factors, num_blocks=latent_num_blocks)
        self.diffusion = DiffusionAttnUnet1D(
            io_channels=latent_dim, cond_dim=second_stage_latent_dim, n_attn_layers=0,
            c_mults=diffusion_c_mults, depth=diffusion_depth)

    @property
    def latent_downsampling_ratio(self) -> int:
        return int(math.prod(self.factors))

    @property
    def downsampling_ratio(self) -> int:
        return self.autoencoder.downsampling_ratio * self.latent_downsampling_ratio

    def encode(self, reals: torch.Tensor) -> torch.Tensor:
        """(B, 2, T) -> tanh-bounded stage-2 latents (B, 32, T / ratio)."""
        return torch.tanh(self.latent_encoder(self.autoencoder.encode(reals)))

    def diffusion_v(self, x, t, cond):
        """Stage-1-latent v prediction (the outer sampler's model)."""
        return self.diffusion(x, t, cond)

    def decode_first_stage(self, first_stage_latents: torch.Tensor) -> torch.Tensor:
        """AE decode of (clamped) stage-1 latents -> audio."""
        return self.autoencoder.decode(first_stage_latents)


class StackedAELatentDiffusionCond(nn.Module):
    """UNetCFG1d over stage-2 latents with (B, 1, 512) context embeddings;
    the submodule is named `diffusion`, as in flax."""

    def __init__(self, latent_dim: int = 32, embedding_features: int = 512,
                 embedding_max_len: int = 1, channels: int = 256,
                 multipliers: Sequence[int] = (2, 3, 4, 4, 4, 4),
                 factors: Sequence[int] = (1, 2, 2, 4, 4),
                 num_blocks: Sequence[int] = (3, 3, 3, 3, 3),
                 attentions: Sequence[int] = (0, 0, 2, 2, 2, 2),
                 resnet_groups: int = 8, attention_heads: int = 16,
                 attention_features: int = 64, attention_multiplier: int = 4,
                 attention_rel_pos_max_distance: int = 2048,
                 attention_rel_pos_num_buckets: int = 256):
        super().__init__()
        self.diffusion = UNetCFG1d(
            in_channels=latent_dim, context_embedding_features=embedding_features,
            context_embedding_max_length=embedding_max_len, channels=channels,
            resnet_groups=resnet_groups, multipliers=multipliers, factors=factors,
            num_blocks=num_blocks, attentions=attentions,
            attention_heads=attention_heads, attention_features=attention_features,
            attention_multiplier=attention_multiplier,
            attention_rel_pos_max_distance=attention_rel_pos_max_distance,
            attention_rel_pos_num_buckets=attention_rel_pos_num_buckets,
            use_skip_scale=True, use_context_time=True)

    def forward(self, x, t, embedding=None, embedding_scale: float = 1.0,
                rel_biases=None):
        return self.diffusion(x, t, embedding=embedding, embedding_scale=embedding_scale,
                              rel_biases=rel_biases)
