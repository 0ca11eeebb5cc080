"""The data-parallel world: which rank this process is, of how many, on
which device, and the collectives the steps use.

Port of audio_algebra_tpu/parallel/mesh.py. A JAX Mesh names the devices
one process drives; a torch process drives one card, so the port's
`make_mesh` describes the process group instead: its size, this
process's rank and device. Only the `data` axis is ported; the sequence
axis of the parallel decodes is ROADMAP item A7.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .multihost import in_process_group


class _Gather(torch.autograd.Function):
    """all_gather along dim 0. Every rank computes the same loss of the
    gathered tensor, so the gradient of a rank's own rows is the global
    one: backward keeps those rows, and the ranks' parameter gradients sum
    to the global batch's."""

    @staticmethod
    def forward(ctx, x):
        ctx.rank, ctx.rows = dist.get_rank(), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


class World:
    """`size` processes in the `data` axis; this one is `rank`, on
    `device`. Without a process group it is one process and the
    collectives are identities; in a group (of one, too) they run."""

    def __init__(self, size: int, rank: int, device: torch.device):
        self.size, self.rank, self.device = int(size), int(rank), device
        self.grouped = in_process_group()

    def rows(self, n: int) -> slice:
        """This rank's rows of n global rows (n % size == 0)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of a per-rank tensor, rank order along dim 0,
        differentiable (see _Gather: the loss must be the same on every
        rank)."""
        return _Gather.apply(x) if self.grouped else x

    def all_reduce_sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the ranks in place, in one flat buffer."""
        if not self.grouped or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        self.all_reduce_sum_(tensors)
        if self.grouped:
            for t in tensors:
                t.div_(self.size)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values into every rank's tensors, in place."""
        if self.grouped:
            for t in tensors:
                dist.broadcast(t, src=0)


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device: str | torch.device | None = "cuda") -> World:
    """The world of this process: the process group's size and rank (one
    process without a group) on `device` (the card LOCAL_RANK names). The
    arguments are JAX's: `n_devices`, when given, must be the group's
    size, and `axis_names` / `shape` name one `data` axis."""
    names = tuple(axis_names)
    sizes = tuple(shape) if shape is not None else None
    if "seq" in names:
        raise NotImplementedError("a 'seq' mesh axis (the sequence-parallel decodes) is not "
                                  "ported yet: ROADMAP item A7")
    if names != ("data",) or (sizes is not None and len(sizes) != 1):
        raise NotImplementedError(f"mesh axes {names}: only the 'data' axis is ported; "
                                  "the rest is ROADMAP item A7")
    size = dist.get_world_size() if in_process_group() else 1
    rank = dist.get_rank() if in_process_group() else 0
    want = sizes[0] if sizes is not None else n_devices
    if want is not None and int(want) != size:
        raise ValueError(f"a data axis of {want} needs {want} processes, this world has "
                         f"{size}: launch with torchrun --nproc_per_node {want}")
    return World(size, rank, _rank_device(device))


def mesh_from_spec(spec: str, device: str | torch.device | None = "cuda") -> World:
    """Parse a mesh spec like 'data=2' (JAX's surface, e.g. mirage.py
    --mesh) into the world. A 'seq' axis raises NotImplementedError
    (ROADMAP item A7)."""
    axes, sizes = [], []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, val = part.partition("=")
        if not eq or not val.strip().isdigit() or int(val) < 1:
            raise ValueError(f"bad mesh spec {spec!r}: expected 'axis=N[,axis=N...]', "
                             f"got component {part!r}")
        axes.append(name.strip())
        sizes.append(int(val))
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    return make_mesh(n_devices=int(np.prod(sizes)), axis_names=tuple(axes),
                     shape=tuple(sizes), device=device)
