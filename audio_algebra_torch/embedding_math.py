"""CLAP-embedding combination math of the MIRAGE app, and its warm model
cache.

Port of audio_algebra_tpu/embedding_math.py (lerp, slerp,
interp_embeddings, weighted_algebra; reference mirage.py:156-179 and
:375-381; `get_model_ready`, the cache that the MIRAGE CLI and the service
share). Inputs may be torch tensors or numpy arrays; results are torch
tensors.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

__all__ = ["lerp", "slerp", "interp_embeddings", "weighted_algebra", "get_model_ready",
           "model_cache_key", "decode_batch_from_env"]

_model_cache: dict = {}
# why a turbo model takes no mesh: CLAPDAE.generate_seqpar's refusal, and
# the parse-time one of the MIRAGE CLI and the service
TURBO_SEQPAR_REFUSAL = "the sequence-parallel outer stage runs the float route only, as JAX's"
# how a JAX user sets CLAPDAE's outer micro-batch; of the port, only the
# MIRAGE CLI and the service read it (`decode_batch_from_env`)
DECODE_BATCH_ENV = "AA_MIRAGE_DECODE_BATCH"


def decode_batch_from_env() -> dict:
    """{"decode_batch": n} when AA_MIRAGE_DECODE_BATCH is set (JAX's
    int(...); CLAPDAE takes a value below 1 as 1), else {}: what the MIRAGE
    CLI and the service pass on to get_model_ready."""
    value = os.environ.get(DECODE_BATCH_ENV)
    return {} if value is None else {"decode_batch": int(value)}


def model_cache_key(model_choice: str = "22s", half: bool = True, device="cuda", *,
                    turbo: bool = False, decode_batch: int = 4, **model_kwargs) -> tuple:
    """The key of get_model_ready's cache: the model length, the bf16 switch,
    the resolved device, the turbo switch, the outer micro-batch (as
    CLAPDAE takes it: at least 1) and the model's configuration."""
    from .device import resolve_device
    return (model_choice, half, str(resolve_device(device)), turbo,
            max(int(decode_batch), 1), json.dumps(model_kwargs, sort_keys=True))


def get_model_ready(model_choice: str = "22s", device="cuda", verbose: bool = True,
                    half: bool = True, turbo: bool = False, decode_batch: int = 4,
                    **model_kwargs):
    """The warm CLAPDAE of a model length, keyed by model_cache_key: built
    on `device` with `model_kwargs` (seeded random weights unless its setup
    finds checkpoints) at its first request; `half` casts the diffusion
    stages to bf16, the reference app's default (CLAP stays f32); `turbo`
    builds it on the int8 routes of its outer stage; `decode_batch` is its
    outer micro-batch (CLAPDAE's default 4). A request on another device,
    turbo switch, micro-batch or configuration builds its own model."""
    key = model_cache_key(model_choice, half, device, turbo=turbo, decode_batch=decode_batch,
                          **model_kwargs)
    if key not in _model_cache:
        from .given_models import CLAPDAE
        if verbose:
            print(f"get_model_ready: instantiating CLAPDAE ({model_choice}"
                  f"{', turbo' if turbo else ''})")
        model = CLAPDAE(device=device, turbo=turbo, decode_batch=decode_batch, **model_kwargs)
        model.setup(gdrive=False, model_len=model_choice)
        if half:
            model.half()
        _model_cache[key] = model
    return _model_cache[key]


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
