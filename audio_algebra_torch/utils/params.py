"""Weights across the frameworks: the flax-to-torch bridge and a seeded
random init.

The port's modules keep the flax module names, so a flax `params` tree of
nested dicts of numpy arrays maps onto the torch state by name:

  flax leaf                            torch parameter
  Conv1d    kernel (K, Cin, Cout)      Conv1d.weight (Cout, Cin, K)
  ConvTranspose kernel (K, Cout, Cin)  ConvTranspose1d.weight (Cin, Cout, K)
  Dense     kernel (in, out)           Dense / Linear.weight (out, in)
  GroupNorm scale (C,)                 GroupNorm1 / GroupNorm.weight
  LayerNorm scale (C,)                 LayerNorm.weight
  FourierFeatures weight (out/2, 1)    FourierFeatures.weight, as is
  rel_pos_bias, fixed_embedding        the parameter of that name, as is
  any       bias                       bias

`load_flax_params` raises on any leaf left over or missing. It is the
inverse of audio_algebra_tpu.checkpoint.torch_to_flax_array.

`random_init_(module, seed)` fills the module as
audio_algebra_tpu.utils.params.fast_random_params fills a flax tree with
the same seed: leaves in sorted flax-path order, fan-in-scaled normals
from numpy's default_rng(seed), zero biases, unit norm scales. So a run
with no JAX gets the very weights the JAX package would draw.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from ..models.blocks import (Conv1d, ConvTranspose1d, Dense, FourierFeatures, GroupNorm,
                             GroupNorm1, LayerNorm, Linear)

# parameters that keep their flax name and layout
_AS_IS = ("rel_pos_bias", "fixed_embedding")


def _flax_leaf(owner: nn.Module, leaf: str) -> tuple[str, Any]:
    """(flax leaf name, torch layout -> flax layout) for a torch parameter."""
    if leaf == "bias" or leaf in _AS_IS:
        return leaf, lambda a: a
    if isinstance(owner, (Conv1d, ConvTranspose1d)):
        return "kernel", lambda a: a.transpose(2, 1, 0)
    if isinstance(owner, (Dense, Linear)):
        return "kernel", lambda a: a.T
    if isinstance(owner, (GroupNorm1, GroupNorm, LayerNorm)):
        return "scale", lambda a: a
    if isinstance(owner, FourierFeatures):
        return "weight", lambda a: a
    raise TypeError(f"no flax name for {type(owner).__name__}.{leaf}")


def flax_paths(module: nn.Module) -> dict[tuple[str, ...], tuple[str, Any]]:
    """{flax path: (torch parameter name, torch -> flax layout)}."""
    out = {}
    for name, _ in module.named_parameters():
        *owner_path, leaf = name.split(".")
        owner = module.get_submodule(".".join(owner_path))
        flax_leaf, to_flax = _flax_leaf(owner, leaf)
        out[(*owner_path, flax_leaf)] = (name, to_flax)
    return out


def _flatten(tree: dict, prefix=()) -> dict[tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, (*prefix, str(k))))
        else:
            out[(*prefix, str(k))] = np.asarray(v)
    return out


def _unwrap(tree: dict) -> dict:
    return tree["params"] if set(tree.keys()) == {"params"} else tree


def _inverse_layout(to_flax, arr: np.ndarray, shape) -> np.ndarray:
    """torch layout of a flax array: every map above is its own inverse."""
    out = to_flax(arr)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"shape {arr.shape} does not map onto {tuple(shape)}")
    return out


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Fill `module` from a flax params tree (nested dicts of arrays, with
    or without the top-level 'params' key). Raises on any leaf that is
    left over or missing, or whose shape does not match."""
    leaves = _flatten(_unwrap(tree))
    paths = flax_paths(module)
    missing = sorted("/".join(p) for p in paths.keys() - leaves.keys())
    extra = sorted("/".join(p) for p in leaves.keys() - paths.keys())
    if missing or extra:
        raise KeyError(f"flax tree does not match the module: missing {missing[:8]}"
                       f" ({len(missing)}), left over {extra[:8]} ({len(extra)})")
    state = dict(module.named_parameters())
    for path, (name, to_flax) in paths.items():
        p = state[name]
        arr = _inverse_layout(to_flax, np.asarray(leaves[path], np.float32), p.shape)
        p.copy_(torch.from_numpy(np.array(arr, np.float32)).to(p.dtype))
    return module


def to_flax_params(module: nn.Module) -> dict:
    """The module's parameters as a flax params tree of numpy f32 arrays."""
    state = dict(module.named_parameters())
    tree: dict = {}
    for path, (name, to_flax) in flax_paths(module).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(
            to_flax(state[name].detach().float().cpu().numpy()))
    return tree


@torch.no_grad()
def random_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill `module` with the weights fast_random_params draws for `seed`."""
    rng = np.random.default_rng(seed)
    state = dict(module.named_parameters())
    paths = flax_paths(module)
    for path in sorted(paths):
        name, to_flax = paths[path]
        p = state[name]
        flax_shape = to_flax(np.empty(p.shape, np.float32)).shape
        leaf = path[-1].lower()
        if leaf in ("bias", "b") or len(flax_shape) == 1:
            p.fill_(1.0 if "scale" in leaf or leaf.endswith("var") else 0.0)
            continue
        fan_in = int(np.prod(flax_shape[:-1]))
        std = 1.0 / max(np.sqrt(fan_in), 1.0)
        arr = (rng.standard_normal(flax_shape).astype(np.float32) * std
               ).astype(np.float32)
        p.copy_(torch.from_numpy(np.ascontiguousarray(to_flax(arr))).to(p.dtype))
    return module
