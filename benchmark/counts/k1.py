"""Kernel K1 (GroupNorm(1) [+ tanh-GELU] [+ residual], csrc/groupnorm.cu):
its least time per launch, a frozen copy of the measured package's
`chip_smoke.gn_bound`: read x (and the residual) once, write y once, plus
the per-channel scale and bias; or its f32 operations (statistics 3,
normalise and affine 4, GELU 8, residual 1 an element) at the f32 peak,
whichever is larger."""
from __future__ import annotations

import math

from .peaks import F32_FLOPS_PER_S, HBM_BYTES_PER_S


def bound_s(shape, esize: int, gelu: bool, residual: bool) -> float:
    n, c = math.prod(shape), shape[1]
    t_bytes = (n * esize * (3 if residual else 2) + 2 * c * esize) / HBM_BYTES_PER_S
    t_ops = n * (7 + 8 * gelu + residual) / F32_FLOPS_PER_S
    return max(t_bytes, t_ops)
