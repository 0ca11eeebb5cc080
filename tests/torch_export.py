"""A TorchScript archive that carries a given state dict, as a RAVE export
(.ts) does: one submodule per weight / bias stem, so that the archive's
state_dict() gives back the very names, and buffers (an export's
latent_pca, latent_mean) beside them. It imports only torch, so that
chip_smoke.py can load it by path on a machine without JAX."""
from __future__ import annotations

import torch


class _Leaf(torch.nn.Module):
    def forward(self, x):
        return x


class _Node(torch.nn.Module):
    def forward(self, x):
        return x


def script_state_dict(sd: dict, buffers=("latent_pca", "latent_mean")):
    """A scripted module whose state_dict() is `sd` (name -> tensor);
    names whose last part is in `buffers` become buffers, the rest
    parameters."""
    root = _Node()
    for name, value in sd.items():
        *path, leaf = name.split(".")
        mod = root
        for part in path:
            sub = getattr(mod, part, None)
            if sub is None:
                sub = _Leaf()
                mod.add_module(part, sub)
            mod = sub
        value = torch.as_tensor(value).detach().clone()
        if leaf in buffers:
            mod.register_buffer(leaf, value)
        else:
            mod.register_parameter(leaf, torch.nn.Parameter(value, requires_grad=False))
    return torch.jit.script(root)
