"""Checkpoints: a training run's own, and the reference's torch files.

Port of audio_algebra_tpu/checkpoint.py's save_checkpoint, load_checkpoint
and latest_checkpoint onto torch.save / torch.load: a state is a nested
dict of tensors and numbers ({params, ema_params, opt_state, step} for the
trainers), written as `<path>/step_XXXXXXXX/state.pt` (the step-numbered
directory naming is the JAX package's, which wrote orbax trees there;
those are not read here). Tensors are saved from, and loaded to, the CPU;
the caller places them.

Inbound: `load_torch_checkpoint` reads a pretrained torch file of the
reference (a Lightning `state_dict`, a raw state dict or DMAE's
`model_state_dict`) as a flat {name: np.ndarray}; `remap_ema_weights`
folds its `*_ema.` twins over the main copies; `torch_to_flax_array` is
the torch -> flax layout of one tensor. convert.py pours the result into
a module's flax-layout tree.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state: Any, step: Optional[int] = None) -> str:
    """Save a state tree under `path` (under `path/step_XXXXXXXX` with a
    step). Returns the checkpoint's directory."""
    path = Path(os.path.expanduser(path)).resolve()
    if step is not None:
        path = path / f"step_{step:08d}"
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path / STATE_FILE)          # a cut run leaves no half file
    return str(path)


def load_checkpoint(path: str) -> Any:
    """The state tree saved by save_checkpoint at `path`, on the CPU."""
    path = Path(os.path.expanduser(path)).resolve()
    return torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest step_XXXXXXXX subdirectory, or None."""
    d = Path(os.path.expanduser(ckpt_dir))
    if not d.exists():
        return None
    steps = sorted(p for p in d.iterdir() if re.match(r"step_\d+", p.name))
    return str(steps[-1]) if steps else None


def load_torch_checkpoint(path: str) -> dict:
    """A torch .ckpt / .pt file as a flat {name: np.ndarray} dict, on the
    host. Takes a Lightning checkpoint ('state_dict'), a raw state dict or
    the DMAE format ('model_state_dict'); entries that are not arrays are
    dropped. The file is unpickled in full (weights_only=False, as the
    reference's files hold Lightning's hyperparameters): read only files
    you trust."""
    obj = torch.load(os.path.expanduser(path), map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model_state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: np.asarray(v.detach().cpu().numpy()) if hasattr(v, "detach")
            else np.asarray(v) for k, v in obj.items() if hasattr(v, "shape")}


def remap_ema_weights(sd: dict) -> dict:
    """The reference's load_ema_weights: every `<module>_ema.<rest>` entry
    overwrites `<module>.<rest>`, then the EMA entries are dropped."""
    out = dict(sd)
    for name, value in sd.items():
        m = re.match(r"(.*?)([a-zA-Z0-9_]+)_ema\.(.*)", name)
        if m:
            out[f"{m.group(1)}{m.group(2)}.{m.group(3)}"] = value
    return {k: v for k, v in out.items() if "_ema." not in k}


def torch_to_flax_array(name: str, value: np.ndarray) -> np.ndarray:
    """The layout transposes: a torch Conv1d weight (out, in, k) -> flax
    (k, in, out); a torch Linear weight (out, in) -> flax kernel (in, out)."""
    if value.ndim == 3:
        return np.transpose(value, (2, 1, 0))
    if value.ndim == 2 and ("weight" in name or "kernel" in name):
        return np.transpose(value, (1, 0))
    return value
