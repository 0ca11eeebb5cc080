"""Stacked latent diffusion models (the MIRAGE generative stack).

Port of audio_algebra_tpu/models/stacked.py:

* LatentAudioDiffusionAutoencoder: the stage-2 AE over the first-stage
  AudioAutoencoder's latents: Encoder1d (32 -> 32, /16) and a
  DiffusionAttnUnet1D (io 32, cond 32, depth 10, c_mults [512] * 10, no
  attention). encode = AE.encode -> latent_encoder -> tanh; the decode
  path is the v-diffusion (`diffusion_v`, the sampler's model; its
  turbo amax carry `diffusion_v_aux`) and `decode_first_stage` (the AE
  decoder); `ENCODER_PARTS` names the submodules the encode reads (a
  frozen encode in bf16 casts only those: aa_mixer.mixed_encode_fn). The
  module carries every
  submodule of the flax tree (the AE encoder and Encoder1d too), so the
  seeded random weights and the flax bridge see the same leaves.
* StackedAELatentDiffusionCond: UNetCFG1d over the 32-d stage-2 latents
  with 512-d context embeddings (the songs configuration by default).
* v_objective_loss: the training objective of the latter (v prediction,
  MSE, CFG dropout of the conditioning).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..samplers.vddim import get_alphas_sigmas
from .audio_ae import AudioAutoencoder
from .blocks import TURBO_MIN_B
from .encoder1d import Encoder1d
from .unet1d import DiffusionAttnUnet1D
from .unet_cfg1d import UNetCFG1d


class LatentAudioDiffusionAutoencoder(nn.Module):
    ENCODER_PARTS = ("autoencoder.encoder", "latent_encoder")   # what encode() reads

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

    def diffusion_v_aux(self, x, t, cond, q_aux=None, turbo_min_b: int = TURBO_MIN_B):
        """diffusion_v on the turbo route with the amax carry (JAX's under
        AA_TURBO_INT8): returns (v, q_aux_out), and the v-DDIM sampler's
        aux mode threads q_aux from step to step. Below turbo_min_b the
        UNet runs its float route."""
        return self.diffusion(x, t, cond, q_aux=q_aux, collect_q_aux=True, turbo=True,
                              turbo_min_b=turbo_min_b)

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
                 attention_rel_pos_num_buckets: int = 256,
                 train_flash: bool = True, remat: bool = False):
        super().__init__()
        self.diffusion = UNetCFG1d(
            train_flash=train_flash, remat=remat,
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
                rel_biases=None, embedding_mask_proba: float = 0.0, keep=None,
                generator: torch.Generator | None = None):
        return self.diffusion(x, t, embedding=embedding, embedding_scale=embedding_scale,
                              rel_biases=rel_biases,
                              embedding_mask_proba=embedding_mask_proba, keep=keep,
                              generator=generator)


def v_objective_loss(model, latents, embeddings, t, noise,
                     embedding_mask_proba: float = 0.1, keep=None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """The training objective (JAX stacked.py:151-166): noised = z * alpha +
    noise * sigma, target = noise * alpha - z * sigma, MSE on the predicted
    v with CFG dropout of the embeddings (`keep` given, or drawn from
    `generator` with probability `embedding_mask_proba` of a drop)."""
    alphas, sigmas = get_alphas_sigmas(t)
    alphas, sigmas = alphas[:, None, None], sigmas[:, None, None]
    noised = latents * alphas + noise * sigmas
    targets = noise * alphas - latents * sigmas
    v = model(noised, t, embedding=embeddings, embedding_mask_proba=embedding_mask_proba,
              keep=keep, generator=generator)
    return (v - targets).square().mean()
