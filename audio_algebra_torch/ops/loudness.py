"""ITU-R BS.1770 loudness (pyloudnorm's capability) on tensors.

Port of audio_algebra_tpu/ops/loudness.py: K-weighting (a high shelf and a
high pass, two biquads) -> mean squares over 400 ms blocks with a 100 ms
hop -> the absolute gate at -70 LUFS and the relative gate 10 LU below ->
LUFS. The K-weighting runs on kernel R1 (ops/filters.sosfilt): on a whole
track that is one long serial chain a channel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from .filters import sosfilt


def _k_weighting_sos(sr: int) -> torch.Tensor:
    """BS.1770 stage 1 (high shelf) and stage 2 (high pass) as (2, 6) f32:
    the published coefficients at 48 kHz, redesigned from the analog
    prototypes at other rates."""
    if sr == 48000:
        shelf_b = [1.53512485958697, -2.69169618940638, 1.19839281085285]
        shelf_a = [1.0, -1.69065929318241, 0.73248077421585]
        hp_b = [1.0, -2.0, 1.0]
        hp_a = [1.0, -1.99004745483398, 0.99007225036621]
    else:
        f0, G, Q = 1681.9744509555319, 3.99984385397, 0.7071752369554196
        K = math.tan(math.pi * f0 / sr)
        Vh = 10 ** (G / 20.0)
        Vb = Vh ** 0.4996667741545416
        a0 = 1.0 + K / Q + K * K
        shelf_b = [(Vh + Vb * K / Q + K * K) / a0, 2.0 * (K * K - Vh) / a0,
                   (Vh - Vb * K / Q + K * K) / a0]
        shelf_a = [1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0]
        f0, Q = 38.13547087602444, 0.5003270373238773
        K = math.tan(math.pi * f0 / sr)
        hp_a = [1.0, 2.0 * (K * K - 1.0) / (1.0 + K / Q + K * K),
                (1.0 - K / Q + K * K) / (1.0 + K / Q + K * K)]
        hp_b = [1.0, -2.0, 1.0]
    return torch.tensor([shelf_b + shelf_a, hp_b + hp_a], dtype=torch.float32)


def _lufs(ms) -> torch.Tensor:
    return -0.691 + 10.0 * torch.log10(torch.clamp(ms, min=1e-12))


def integrated_loudness(audio, sample_rate: int = 48000, device="cuda") -> float:
    """(C, T) or (T,) -> integrated loudness in LUFS. A tensor runs on its
    own device; a numpy array on `device`."""
    if isinstance(audio, torch.Tensor):
        x = audio.float()
    else:
        x = torch.as_tensor(np.asarray(audio, np.float32), device=resolve_device(device))
    if x.dim() == 1:
        x = x[None]
    xw = sosfilt(_k_weighting_sos(sample_rate).to(x.device), x)
    # BS.1770-4 channel weights (L, R, C, Ls, Rs): the surround pair 1.41
    g = torch.ones(xw.shape[0], dtype=torch.float32, device=x.device)
    g[3:5] = 1.41
    block = int(0.400 * sample_rate)
    hop = int(0.100 * sample_rate)
    t = xw.shape[-1]
    if t < block:
        ms = (g * torch.mean(torch.square(xw), dim=-1)).sum()
        return float(_lufs(ms))
    frames = xw.unfold(-1, block, hop)                          # (C, n_blocks, block)
    ms = (g[:, None] * torch.mean(torch.square(frames), dim=-1)).sum(dim=0)
    lk = _lufs(ms)
    abs_mask = lk > -70.0                                       # absolute gate
    ms_abs = torch.where(abs_mask, ms, 0.0)
    l_abs = _lufs(ms_abs.sum() / torch.clamp(abs_mask.sum(), min=1))
    rel_mask = abs_mask & (lk > (l_abs - 10.0))                 # relative gate
    ms_rel = torch.where(rel_mask, ms, 0.0)
    return float(_lufs(ms_rel.sum() / torch.clamp(rel_mask.sum(), min=1)))


def loudness_normalize(audio, target_lufs: float = -23.0, sample_rate: int = 48000,
                       max_gain_db: float = 40.0, device="cuda"):
    """Gain numpy audio to the target integrated loudness (pyloudnorm's
    normalize): (audio, the loudness it had)."""
    x = np.asarray(audio, np.float32)
    lufs = integrated_loudness(x, sample_rate, device)
    gain_db = np.clip(target_lufs - lufs, -max_gain_db, max_gain_db)
    return x * (10.0 ** (gain_db / 20.0)), lufs


def maxabs_normalize(audio, peak: float = 0.95):
    """Peak normalisation (the reference's maxabs option)."""
    x = np.asarray(audio, np.float32)
    m = np.abs(x).max()
    return x * (peak / max(m, 1e-9)), float(m)
