"""CLAP-embedding combination math of the MIRAGE app.

Port of audio_algebra_tpu/embedding_math.py (lerp, slerp,
interp_embeddings, weighted_algebra; reference mirage.py:156-179 and
:375-381). Inputs may be torch tensors or numpy arrays; results are torch
tensors. The model cache of the JAX module lives in serve.py here.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["lerp", "slerp", "interp_embeddings", "weighted_algebra"]


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def lerp(a, b, t):
    """Linear interpolation."""
    return _tensor(a) * (1 - t) + _tensor(b) * t


def slerp(a, b, t, dot_threshold: float = 0.9995):
    """Spherical interpolation; lerp when the two are nearly parallel."""
    a, b = _tensor(a), _tensor(b)
    dot = (a * b).sum() / torch.clamp(torch.linalg.norm(a) * torch.linalg.norm(b),
                                      min=1e-8)
    if float(dot.abs()) > dot_threshold:
        return lerp(a, b, t)
    theta0 = torch.arccos(torch.clamp(dot, -1, 1))
    theta = theta0 * t
    s0 = torch.sin(theta0 - theta) / torch.sin(theta0)
    s1 = torch.sin(theta) / torch.sin(theta0)
    return s0 * a + s1 * b


def interp_embeddings(emb1, emb2, interp_scale: float = 0.5, interp_type: str = "slerp"):
    if interp_type == "lerp":
        return lerp(emb1, emb2, interp_scale)
    return slerp(emb1, emb2, interp_scale)


def weighted_algebra(embeddings: Sequence, weights: Sequence[float]):
    """sum(w_i * emb_i), renormalised to unit length ("audio algebra")."""
    total = None
    for emb, w in zip(embeddings, weights):
        term = _tensor(emb) * w
        total = term if total is None else total + term
    return total / torch.clamp(torch.linalg.norm(total), min=1e-8)
