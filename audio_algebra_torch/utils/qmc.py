"""Quasi-random (Sobol) timestep draws for diffusion training.

The port's copy of audio_algebra_tpu/utils/qmc.py: a scrambled 1-D Sobol
engine stratifies the noise levels each batch sees. scipy's engine, on the
host: the same seed gives the same draws as the JAX package's sampler.
"""
from __future__ import annotations

import warnings

import numpy as np
from scipy.stats import qmc


class SobolSampler:
    """Scrambled Sobol sequence, drawn host-side per training step.
    draw(n) -> float32 (n,) in [0, 1)."""

    def __init__(self, dim: int = 1, scramble: bool = True, seed: int = 0):
        self.dim = dim
        self._engine = qmc.Sobol(d=dim, scramble=scramble, seed=seed)

    def draw(self, n: int) -> np.ndarray:
        with warnings.catch_warnings():
            # scipy warns that draws that are no power of 2 lose balance; a
            # batch is drawn whatever its size, as the reference does
            warnings.simplefilter("ignore", UserWarning)
            return self._engine.random(n)[:, 0].astype(np.float32)
