"""RAVE v2 — IRCAM's realtime neural audio codec.

Port of audio_algebra_tpu/models/rave.py, channels-first (B, C, T):

  * a PQMF multiband front end (16 bands, 100 dB; ops/pqmf.py);
  * EncoderV2: conv-in -> per ratio [dilated residual units -> leaky
    ReLU -> strided down conv, channels x 2] -> conv-out emitting (mean,
    scale) of the variational posterior;
  * GeneratorV2: conv-in -> per ratio [leaky ReLU -> transposed up conv,
    channels / 2 -> dilated residual units] -> a waveform head with
    amplitude modulation (mod_sigmoid(x) = 2 sigmoid(x)^2.3 + 1e-7) and a
    filtered-noise head (NoiseGenerator: strided convs -> per-frame
    noise-band magnitudes -> zero-phase impulse responses -> FFT-convolved
    uniform noise), summed as tanh(wave) + noise, then PQMF synthesis.

The convs are plain fused kernels: convert.fuse_weight_norm folds the
reference's weight-norm pairs before the pour. Modules keep the flax
names (conv_in, lvl{i}_unit{j}, lvl{i}_zdown / lvl{i}_up, net{i}, ...).
The noise head takes its uniform [-1, 1) noise (B, Tn, bands, prod(noise
ratios)) as an argument, or draws it from a torch.Generator.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pqmf import PQMF
from .blocks import Conv1d, ConvTranspose1d


def leaky(x, slope: float = 0.2):
    return F.leaky_relu(x, negative_slope=slope)


def mod_sigmoid(x):
    """RAVE's strictly positive amplitude nonlinearity."""
    return 2.0 * torch.sigmoid(x) ** 2.3 + 1e-7


class DilatedUnit(nn.Module):
    """Residual dilated unit: act -> dilated k-conv -> act -> 1-conv, + x."""

    def __init__(self, dim: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.conv_a = Conv1d(dim, dim, kernel_size, dilation=dilation)
        self.conv_b = Conv1d(dim, dim, 1)

    def forward(self, x):
        return x + self.conv_b(leaky(self.conv_a(leaky(x))))


class EncoderV2(nn.Module):
    """PQMF bands (B, data_size, T) -> (B, n_out * latent_size,
    T / prod(ratios))."""

    def __init__(self, data_size: int, capacity: int, ratios: Sequence[int],
                 latent_size: int, dilations: Sequence[Sequence[int]], n_out: int = 2,
                 kernel_size: int = 3):
        super().__init__()
        self.conv_in = Conv1d(data_size, capacity, 2 * kernel_size + 1)
        self.levels = []
        ch = capacity
        for li, (r, dils) in enumerate(zip(ratios, dilations)):
            names = []
            for ui, d in enumerate(dils):
                setattr(self, f"lvl{li}_unit{ui}", DilatedUnit(ch, kernel_size, d))
                names.append(f"lvl{li}_unit{ui}")
            setattr(self, f"lvl{li}_zdown", Conv1d(ch, 2 * ch, 2 * r, stride=r))
            self.levels.append((names, f"lvl{li}_zdown"))
            ch *= 2
        self.conv_out = Conv1d(ch, n_out * latent_size, 2 * kernel_size + 1)

    def forward(self, x):
        x = self.conv_in(x)
        for units, down in self.levels:
            for u in units:
                x = getattr(self, u)(x)
            x = getattr(self, down)(leaky(x))
        return self.conv_out(leaky(x))


def _amp_to_impulse_response(amp: torch.Tensor, target_size: int) -> torch.Tensor:
    """Magnitudes (a zero-phase real spectrum) -> centred, Hann-windowed
    impulse responses zero-padded to `target_size`."""
    ir = torch.fft.irfft(torch.complex(amp.float(), torch.zeros_like(amp.float())))
    filter_size = ir.shape[-1]
    ir = torch.roll(ir, filter_size // 2, dims=-1)
    n = torch.arange(filter_size, device=amp.device, dtype=ir.dtype)
    ir = ir * (0.5 - 0.5 * torch.cos(2 * math.pi * n / filter_size))   # periodic Hann
    ir = F.pad(ir, (0, int(target_size) - filter_size))
    return torch.roll(ir, -(filter_size // 2), dims=-1)


def _fft_convolve(signal: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Linear convolution of same-length last axes by 2x zero padding,
    keeping the aligned second half."""
    n = signal.shape[-1]
    sig = F.pad(signal, (0, n))
    ker = F.pad(kernel, (n, 0))
    out = torch.fft.irfft(torch.fft.rfft(sig) * torch.fft.rfft(ker))
    return out[..., out.shape[-1] // 2:]


class NoiseGenerator(nn.Module):
    """Filtered-noise head: band-rate features (B, hidden, T) -> band-rate
    noise (B, data_size, T). Each frame of the conv net (rate
    T / prod(ratios)) shapes prod(ratios) samples of noise."""

    def __init__(self, data_size: int, hidden: int = 64, ratios: Sequence[int] = (4, 4, 4),
                 noise_bands: int = 5, kernel_size: int = 3):
        super().__init__()
        self.data_size, self.noise_bands = data_size, noise_bands
        self.target_size = math.prod(ratios)
        self.n_convs = len(ratios)
        for i, r in enumerate(ratios):
            feats = data_size * noise_bands if i == len(ratios) - 1 else hidden
            setattr(self, f"net{i}", Conv1d(hidden, feats, kernel_size, stride=r))

    def forward(self, x, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = x
        for i in range(self.n_convs):
            h = getattr(self, f"net{i}")(leaky(h) if i else h)
        amp = mod_sigmoid(h - 5.0).transpose(1, 2)            # (B, Tn, D * nb)
        b, tn, _ = amp.shape
        ir = _amp_to_impulse_response(amp.reshape(b, tn, self.data_size, self.noise_bands),
                                      self.target_size)
        if noise is None:
            noise = torch.rand(ir.shape, generator=generator, device=ir.device) * 2.0 - 1.0
        out = _fft_convolve(noise.to(ir.dtype), ir)          # (B, Tn, D, target)
        out = out.permute(0, 2, 1, 3).reshape(b, self.data_size, tn * self.target_size)
        return out.to(x.dtype)


class GeneratorV2(nn.Module):
    """Latents (B, latent_size, Tz) -> PQMF bands (B, data_size, T)."""

    def __init__(self, data_size: int, capacity: int, ratios: Sequence[int],
                 latent_size: int, dilations: Sequence[Sequence[int]], kernel_size: int = 3,
                 amplitude_modulation: bool = True, use_noise: bool = True,
                 noise_ratios: Sequence[int] = (4, 4, 4), noise_bands: int = 5):
        super().__init__()
        self.amplitude_modulation, self.use_noise = amplitude_modulation, use_noise
        ch = capacity * 2 ** len(ratios)
        self.conv_in = Conv1d(latent_size, ch, 2 * kernel_size + 1)
        self.levels = []
        # the generator runs the ratios and dilations in reverse
        for li, (r, dils) in enumerate(zip(ratios[::-1], dilations[::-1])):
            setattr(self, f"lvl{li}_up", ConvTranspose1d(ch, ch // 2, 2 * r, r))
            ch //= 2
            names = []
            for ui, d in enumerate(dils):
                setattr(self, f"lvl{li}_unit{ui}", DilatedUnit(ch, kernel_size, d))
                names.append(f"lvl{li}_unit{ui}")
            self.levels.append((f"lvl{li}_up", names))
        out = 2 * data_size if amplitude_modulation else data_size
        self.waveform_module = Conv1d(ch, out, 2 * kernel_size + 1)
        if use_noise:
            self.noise_module = NoiseGenerator(data_size, hidden=ch, ratios=noise_ratios,
                                               noise_bands=noise_bands)

    def forward(self, z, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = self.conv_in(z)
        for up, units in self.levels:
            x = getattr(self, up)(leaky(x))
            for u in units:
                x = getattr(self, u)(x)
        wav = self.waveform_module(leaky(x))
        if self.amplitude_modulation:
            wav, amp = wav.chunk(2, dim=1)
            wav = wav * mod_sigmoid(amp)
        bands = torch.tanh(wav)
        if self.use_noise:
            bands = bands + self.noise_module(x, noise=noise, generator=generator)
        return bands


class RAVE(nn.Module):
    """Full RAVE v2: PQMF -> variational EncoderV2 -> GeneratorV2 -> PQMF
    synthesis. `latent_dim` / `n_bands` / `strides` are RAVE's
    latent_size / n_band / ratios."""

    def __init__(self, latent_dim: int = 128, n_bands: int = 16, capacity: int = 64,
                 strides: Sequence[int] = (4, 4, 4, 2), kernel_size: int = 3,
                 dilations: Optional[Sequence[Sequence[int]]] = None,
                 noise_ratios: Sequence[int] = (4, 4, 4), noise_bands: int = 5,
                 amplitude_modulation: bool = True, use_noise: bool = True,
                 pqmf_attenuation: float = 100.0):
        super().__init__()
        self.latent_dim, self.n_bands = latent_dim, n_bands
        self.downsampling_ratio = n_bands * math.prod(strides)
        self.pqmf = PQMF(n_bands, pqmf_attenuation)
        dils = tuple(dilations) if dilations is not None else tuple((1, 3, 9) for _ in strides)
        self.encoder = EncoderV2(n_bands, capacity, tuple(strides), latent_dim, dils,
                                 n_out=2, kernel_size=kernel_size)
        self.decoder = GeneratorV2(n_bands, capacity, tuple(strides), latent_dim, dils,
                                   kernel_size=kernel_size,
                                   amplitude_modulation=amplitude_modulation,
                                   use_noise=use_noise, noise_ratios=tuple(noise_ratios),
                                   noise_bands=noise_bands)

    def encode(self, audio, sample: bool = False,
               generator: Optional[torch.Generator] = None):
        """(B, 1, T) mono -> (B, latent_dim, T / downsampling_ratio): the
        posterior mean (what an exported model returns), or with
        `sample=True` mean + std * eps, eps drawn from `generator`."""
        mean, scale = self.encode_bands(self.pqmf.analysis(audio)).chunk(2, dim=1)
        if sample:
            if generator is None:
                raise ValueError("encode(sample=True) needs a torch.Generator; omit "
                                 "sample for the deterministic posterior mean")
            std = F.softplus(scale) + 1e-4
            mean = mean + std * torch.randn(mean.shape, generator=generator,
                                            device=mean.device, dtype=mean.dtype)
        return mean

    def encode_bands(self, bands):
        """PQMF bands (B, n_bands, Tb) -> the raw posterior statistics
        (B, 2 latent_dim, Tz): EncoderV2 alone."""
        return self.encoder(bands)

    def decode_bands(self, z, noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """(B, latent_dim, Tz) -> PQMF bands (B, n_bands, Tb): GeneratorV2
        alone."""
        return self.decoder(z, noise=noise, generator=generator)

    def encode_stats(self, audio):
        """(mean, std) of the posterior, for KL terms."""
        mean, scale = self.encode_bands(self.pqmf.analysis(audio)).chunk(2, dim=1)
        return mean, F.softplus(scale) + 1e-4

    def decode(self, z, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """(B, latent_dim, Tz) -> (B, 1, Tz * downsampling_ratio)."""
        return self.pqmf.synthesis(self.decode_bands(z, noise=noise, generator=generator))

    def forward(self, audio, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        z = self.encode(audio)
        return z, self.decode(z, noise=noise, generator=generator)
