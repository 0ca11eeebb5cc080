"""Weights across the frameworks: the flax-to-torch bridge and a seeded
random init.

The port's modules keep the flax module names, so a flax `params` tree of
nested dicts of numpy arrays maps onto the torch state by name:

  flax leaf                            torch parameter
  Conv1d    kernel (K, Cin, Cout)      Conv1d.weight (Cout, Cin, K)
  Conv (2-D) kernel (kh, kw, in, out)  clap.Conv2d.weight (out, in, kh, kw)
  ConvTranspose kernel (K, Cout, Cin)  ConvTranspose1d.weight (Cin, Cout, K)
  Dense     kernel (in, out)           Dense / Linear.weight (out, in)
  GroupNorm scale (C,)                 GroupNorm1 / GroupNorm / PlainGroupNorm.weight
  LayerNorm scale (C,)                 LayerNorm.weight
  FourierFeatures weight (out/2, 1)    FourierFeatures.weight, as is
  Embed     embedding (N, C)           clap.Embed.embedding, as is
  CLAP _BN  scale, bias, mean, var     clap._BN's parameters of those names
  BatchNorm scale, bias                aa.BatchNorm's parameters of those names
  BatchNorm batch_stats mean, var      aa.BatchNorm's buffers of those names
  rel_pos_bias, fixed_embedding,       the parameter of that name, as is
  token_type_embeddings, bn_scale,
  bn_bias, bn_mean, bn_var, codes
  any       bias                       bias

`load_flax_params` raises on any leaf left over or missing. It is the
inverse of audio_algebra_tpu.checkpoint.torch_to_flax_array. It takes a
bare params tree, `{"params": ...}`, or flax's variables
`{"params": ..., "batch_stats": ...}`, whose `batch_stats` load into the
BatchNorm buffers. `to_flax_tree` goes the other way, for parameters
(`to_flax_params`), gradients (`to_flax_grads`) or any name -> tensor dict
in the parameters' layout; `to_flax_batch_stats` for the buffers.

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

from ..models.aa import BatchNorm
from ..models.blocks import (Conv1d, ConvTranspose1d, Dense, FourierFeatures, GroupNorm,
                             GroupNorm1, LayerNorm, Linear, PlainGroupNorm)
from ..models.clap import _BN, Conv2d

# parameters that keep their flax name and layout
_AS_IS = ("rel_pos_bias", "fixed_embedding", "token_type_embeddings", "embedding",
          "bn_scale", "bn_bias", "bn_mean", "bn_var", "codes")


def _same(a):
    return a


def _flax_leaf(owner: nn.Module, leaf: str) -> tuple[str, Any, Any]:
    """(flax leaf name, torch layout -> flax layout, flax layout -> torch
    layout) for a torch parameter."""
    if leaf == "bias" or leaf in _AS_IS or isinstance(owner, (_BN, BatchNorm)):
        return leaf, _same, _same
    if isinstance(owner, (Conv1d, ConvTranspose1d)):
        return "kernel", lambda a: a.transpose(2, 1, 0), lambda a: a.transpose(2, 1, 0)
    if isinstance(owner, Conv2d):
        return "kernel", lambda a: a.transpose(2, 3, 1, 0), lambda a: a.transpose(3, 2, 0, 1)
    if isinstance(owner, (Dense, Linear)):
        return "kernel", lambda a: a.T, lambda a: a.T
    if isinstance(owner, (GroupNorm1, GroupNorm, PlainGroupNorm, LayerNorm)):
        return "scale", _same, _same
    if isinstance(owner, FourierFeatures):
        return "weight", _same, _same
    raise TypeError(f"no flax name for {type(owner).__name__}.{leaf}")


def flax_paths(module: nn.Module) -> dict[tuple[str, ...], tuple[str, Any, Any]]:
    """{flax path: (torch parameter name, torch -> flax layout, flax ->
    torch layout)}."""
    out = {}
    for name, _ in module.named_parameters():
        *owner_path, leaf = name.split(".")
        owner = module.get_submodule(".".join(owner_path))
        flax_leaf, to_flax, from_flax = _flax_leaf(owner, leaf)
        out[(*owner_path, flax_leaf)] = (name, to_flax, from_flax)
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
    return tree["params"] if set(tree.keys()) in ({"params"}, {"params", "batch_stats"}) \
        else tree


def stat_paths(module: nn.Module) -> dict[tuple[str, ...], str]:
    """{flax `batch_stats` path: torch buffer name} of the BatchNorms."""
    out = {}
    for name, sub in module.named_modules():
        if isinstance(sub, BatchNorm):
            for leaf in ("mean", "var"):
                path = (*name.split("."), leaf) if name else (leaf,)
                out[path] = f"{name}.{leaf}" if name else leaf
    return out


def _inverse_layout(from_flax, arr: np.ndarray, shape) -> np.ndarray:
    """torch layout of a flax array, checked against the parameter's shape."""
    out = from_flax(arr)
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
    for path, (name, _, from_flax) in paths.items():
        p = state[name]
        arr = _inverse_layout(from_flax, np.asarray(leaves[path], np.float32), p.shape)
        p.copy_(torch.from_numpy(np.array(arr, np.float32)).to(p.dtype))
    stats = _flatten(tree.get("batch_stats", {})) if "params" in tree else {}
    buffers = dict(module.named_buffers())
    wanted = stat_paths(module)
    if stats.keys() - wanted.keys() or (stats and wanted.keys() - stats.keys()):
        raise KeyError(f"batch_stats do not match the module: have {sorted(stats)[:8]}, "
                       f"want {sorted(wanted)[:8]}")
    for path, arr in stats.items():
        b = buffers[wanted[path]]
        b.copy_(torch.from_numpy(np.array(arr, np.float32)).reshape(b.shape).to(b.dtype))
    return module


def to_flax_tree(module: nn.Module, tensors: dict) -> dict:
    """{torch parameter name: tensor in that parameter's layout} as a flax
    params tree of numpy f32 arrays, the layout transposes undone: the
    inverse of load_flax_params, for parameters, gradients or EMA copies."""
    tree: dict = {}
    for path, (name, to_flax, _) in flax_paths(module).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(           # a copy: never a view of a live tensor
            to_flax(tensors[name].detach().float().cpu().numpy()), order="C")
    return tree


def to_flax_batch_stats(module: nn.Module) -> dict:
    """The BatchNorm buffers as flax's `batch_stats` tree of numpy f32
    arrays."""
    tree: dict = {}
    buffers = dict(module.named_buffers())
    for path, name in stat_paths(module).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(buffers[name].detach().float().cpu().numpy())
    return tree


def to_flax_params(module: nn.Module) -> dict:
    """The module's parameters as a flax params tree of numpy f32 arrays."""
    return to_flax_tree(module, dict(module.named_parameters()))


def flax_shapes(module: nn.Module) -> dict:
    """A flax params tree of uninitialised f32 arrays in the module's leaf
    shapes: a pour's template where the module's own values are not read."""
    tree: dict = {}
    state = dict(module.named_parameters())
    for path, (name, to_flax, _) in flax_paths(module).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        shape = to_flax(np.empty(state[name].shape, np.float32)).shape
        node[path[-1]] = np.empty(shape, np.float32)
    return tree


def to_flax_grads(module: nn.Module) -> dict:
    """The parameters' gradients (`.grad`, after a backward) as a flax tree
    of numpy f32 arrays. A parameter the loss did not reach (`.grad` None)
    has a zero gradient, as jax.grad gives it."""
    return to_flax_tree(module, {name: torch.zeros_like(p) if p.grad is None else p.grad
                                 for name, p in module.named_parameters()})


@torch.no_grad()
def random_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill `module` with the weights fast_random_params draws for `seed`."""
    rng = np.random.default_rng(seed)
    state = dict(module.named_parameters())
    paths = flax_paths(module)
    for path in sorted(paths):
        name, to_flax, from_flax = paths[path]
        p = state[name]
        flax_shape = to_flax(np.empty(p.shape, np.float32)).shape
        leaf = path[-1].lower()
        if leaf in ("bias", "b") or len(flax_shape) == 1:
            p.fill_(1.0 if "scale" in leaf or leaf.endswith("var") else 0.0)
            continue
        fan_in = int(np.prod(flax_shape[:-1]))
        std = 1.0 / max(np.sqrt(fan_in), 1.0)
        arr = rng.standard_normal(flax_shape).astype(np.float32)
        # arr * std as numpy promotes it, rounded to f32, in place
        np.multiply(arr, std, out=arr, casting="unsafe")
        p.copy_(torch.from_numpy(from_flax(arr)))
    return module
