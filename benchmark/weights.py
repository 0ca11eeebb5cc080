"""Seeded weights, made on the card in a few large calls.

The rule of the measured package's own random init: every parameter of two
or more dimensions is a matrix drawn from N(0, 1 / fan_in), fan_in its
element count over its leading (output) dimension, so a conv's Cin * K and
a dense layer's inputs; a one-dimensional `weight` (a norm's scale) is 1,
every `bias` 0. One normal draw from a CUDA torch.Generator covers all the
matrices of a module, sliced and scaled leaf by leaf, rounded to the dtype
they are served in. Nothing is drawn on the host. The reference draws the
same values again from the seed, so it reads nothing the program holds.
"""
from __future__ import annotations

import math

import torch


def seed_of(*parts: int) -> int:
    """A 63-bit seed mixed from integers (the run's seed and a role)."""
    h = 1469598103934665603
    for p in parts:
        h = ((h ^ (int(p) & ((1 << 64) - 1))) * 1099511628211) % (1 << 64)
    return h >> 1


def shapes_of(module: torch.nn.Module) -> dict:
    """{parameter name: shape} of a module, in its own order."""
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


@torch.no_grad()
def draw(shapes: dict, seed: int, device, dtype, out_dtype=None) -> dict:
    """{name: tensor} by the rule above, rounded to `dtype` and returned in
    `out_dtype` (default `dtype`)."""
    out_dtype = out_dtype or dtype
    mats = [(n, s) for n, s in shapes.items() if len(s) >= 2]
    total = sum(math.prod(s) for _, s in mats)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    values, ofs = {}, 0
    for name, shape in mats:
        n = math.prod(shape)
        std = 1.0 / math.sqrt(max(n // shape[0], 1))
        values[name] = (flat[ofs:ofs + n] * std).to(dtype).to(out_dtype).view(shape)
        ofs += n
    del flat
    for name, shape in shapes.items():
        if len(shape) < 2:
            values[name] = torch.full(shape, 1.0 if name.endswith("weight") else 0.0,
                                      device=device, dtype=out_dtype)
    return values


@torch.no_grad()
def load_(module: torch.nn.Module, values: dict) -> None:
    """Copy `values` into the module's parameters; every name must match."""
    params = dict(module.named_parameters())
    if params.keys() != values.keys():
        raise KeyError(f"weights do not match the module: "
                       f"{sorted(params.keys() ^ values.keys())[:5]}")
    for name, p in params.items():
        p.copy_(values[name])
