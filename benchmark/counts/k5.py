"""Kernel K5 (grouped GroupNorm [+ FiLM] [+ SiLU], csrc/grouped_gn.cu):
its least time per launch, a frozen copy of the measured package's
`chip_smoke.ggn_bound`: read x once, write y once, plus the per-channel
planes (and the per-row FiLM planes); or its f32 operations (statistics
3, affine 2, SiLU 4 an element) at the f32 peak, whichever is larger."""
from __future__ import annotations

from .peaks import F32_FLOPS_PER_S, HBM_BYTES_PER_S


def bound_s(shape, esize: int, film: bool) -> float:
    b, c, t = shape
    nbytes = 2 * b * c * t * esize + (2 * c + (2 * b * c if film else 0)) * esize
    return max(nbytes / HBM_BYTES_PER_S, b * c * t * 9 / F32_FLOPS_PER_S)
