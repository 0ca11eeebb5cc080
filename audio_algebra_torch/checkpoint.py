"""Checkpoints of a training run.

Port of audio_algebra_tpu/checkpoint.py's save_checkpoint, load_checkpoint
and latest_checkpoint onto torch.save / torch.load: a state is a nested
dict of tensors and numbers ({params, ema_params, opt_state, step} for the
trainers), written as `<path>/step_XXXXXXXX/state.pt` (the step-numbered
directory naming is the JAX package's, which wrote orbax trees there;
those are not read here). Tensors are saved from, and loaded to, the CPU;
the caller places them.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

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
