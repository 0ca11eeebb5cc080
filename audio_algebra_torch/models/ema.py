"""Exponential moving averages of parameters, in place.

Port of audio_algebra_tpu/models/ema.py: `ema_update` (ema <- decay * ema +
(1 - decay) * params) and `EMASchedule`, the ema_pytorch-style warm-up
decay(t) = clip(1 - (1 + t / inv_gamma) ** -power, 0, beta) with t = step -
update_after_step, 0 while t <= 0 (the MIRAGE trainer uses beta 0.9999,
power 3/4). The decay is an f32 scalar, as in JAX. Parameters are any
matching sequences or name -> tensor dicts (`state_dict`-shaped); the
averages are updated in place under no_grad.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _tensors(tree):
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


@torch.no_grad()
def ema_update(params, ema_params, decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, with decay and
    1 - decay rounded to f32."""
    decay = np.float32(decay)
    rest = np.float32(1.0) - decay
    if isinstance(params, dict):
        params = [params[k] for k in ema_params]
    for e, p in zip(_tensors(ema_params), _tensors(params), strict=True):
        e.mul_(float(decay)).add_(p.detach().to(e.dtype), alpha=float(rest))


@dataclass(frozen=True)
class EMASchedule:
    beta: float = 0.9999
    power: float = 0.75
    inv_gamma: float = 1.0
    update_after_step: int = 1

    def decay(self, step: int) -> float:
        """The decay at `step`, computed in f32."""
        t = np.float32(max(float(step) - self.update_after_step, 0.0))
        if t <= 0:
            return 0.0
        value = np.float32(1.0) - np.power(np.float32(1.0) + t / np.float32(self.inv_gamma),
                                           np.float32(-self.power))
        return float(np.clip(value, np.float32(0.0), np.float32(self.beta)))

    def update(self, params, ema_params, step: int) -> None:
        ema_update(params, ema_params, self.decay(step))
