"""The world: which rank this process is, of how many, on which device,
along which mesh axis, and the collectives the steps and decodes use.

Port of audio_algebra_tpu/parallel/mesh.py. A JAX Mesh names the devices
one process drives; a torch process drives one card, so the port's
`make_mesh` describes the process group instead: its size, this
process's rank and device, and the one axis it spans, `data` (the
batch: parallel.train, the multi-rank encodes) or `seq` (the time axis of
the sequence-parallel decodes: parallel.seq, parallel.infer). The `seq`
collectives are the halo exchange of a time-sharded conv and the gather
of time slabs; both sides of JAX's `shard_map` programs, written out.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from .multihost import in_process_group, initialize_distributed

AXES = ("data", "seq")


class _Gather(torch.autograd.Function):
    """all_gather along dim 0. Every rank computes the same loss of the
    gathered tensor, so the gradient of a rank's own rows is the global
    one: backward keeps those rows, and the ranks' parameter gradients sum
    to the global batch's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class World:
    """`size` processes along mesh axis `axis` ("data" or "seq"); this one
    is `rank`, on `device`. Without a process group it is one process and
    the collectives are identities; in a group (of one, too) they run, over
    `group` (a torch.distributed group of `size` ranks; None: the default
    group)."""

    def __init__(self, size: int, rank: int, device: torch.device, axis: str = "data",
                 group=None):
        self.size, self.rank, self.device = int(size), int(rank), device
        self.axis, self.group = axis, group
        self.grouped = in_process_group()

    def _global(self, rank: int) -> int:
        """The default group's rank of this world's `rank`."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

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
        return _Gather.apply(x, self.group) if self.grouped else x

    def all_reduce_sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the ranks in place, in one flat buffer."""
        if not self.grouped or not tensors:
            return
        if len(tensors) == 1 and tensors[0].is_contiguous():
            dist.all_reduce(tensors[0], group=self.group)
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
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
                dist.broadcast(t, src=self._global(0), group=self.group)

    def broadcast_object(self, obj):
        """Rank 0's picklable `obj` on every rank (what the others pass is
        ignored)."""
        if not self.grouped:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self._global(0), group=self.group)
        return box[0]

    def barrier(self) -> None:
        if self.grouped:
            dist.barrier(group=self.group)

    # -- the seq axis: time slabs of (B, C, T) tensors --
    def slab(self, t_len: int) -> slice:
        """This rank's time slab of t_len samples (t_len % size == 0)."""
        return self.rows(t_len)

    def exchange_halo(self, x_local: torch.Tensor, halo_l: int, halo_r: int) -> torch.Tensor:
        """cat[left halo, x_local, right halo] along time (the last dim):
        the left neighbour's last `halo_l` samples and the right
        neighbour's first `halo_r`, zeros at the two ends of the row (JAX
        `seq.py:_halo_exchange`, SAME's zero padding at the row's ends).
        One batch of point-to-point sends and receives; the halos are B x
        halo x C elements."""
        if halo_l == 0 and halo_r == 0:
            return x_local
        if min(halo_l, halo_r) < 0 or max(halo_l, halo_r) > x_local.shape[-1]:
            raise ValueError(f"halos ({halo_l}, {halo_r}) do not fit a slab of "
                             f"{x_local.shape[-1]} samples")
        out = F.pad(x_local, (halo_l, halo_r))     # zeros where no neighbour sends
        if self.grouped and self.size > 1:
            left = x_local.new_empty((*x_local.shape[:-1], halo_l))
            right = x_local.new_empty((*x_local.shape[:-1], halo_r))
            ops = []
            lo, hi = self.rank - 1, self.rank + 1
            if lo >= 0:
                peer = self._global(lo)
                if halo_r:
                    ops.append(dist.P2POp(dist.isend, x_local[..., :halo_r].contiguous(),
                                          peer, self.group))
                if halo_l:
                    ops.append(dist.P2POp(dist.irecv, left, peer, self.group))
            if hi < self.size:
                peer = self._global(hi)
                if halo_l:
                    ops.append(dist.P2POp(dist.isend, x_local[..., -halo_l:].contiguous(),
                                          peer, self.group))
                if halo_r:
                    ops.append(dist.P2POp(dist.irecv, right, peer, self.group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            if self.rank > 0 and halo_l:
                out[..., :halo_l] = left
            if self.rank < self.size - 1 and halo_r:
                out[..., out.shape[-1] - halo_r:] = right
        return out

    def all_gather_time(self, h: torch.Tensor) -> torch.Tensor:
        """The whole row of a time-sharded (B, C, T_local): the ranks'
        slabs in rank order along the last dim (JAX's all_gather(...,
        axis=time, tiled=True))."""
        if not self.grouped or self.size == 1:
            return h
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shaped tensors in rank order along dim 0, with
        no autograd (the multi-rank encodes and decodes)."""
        if not self.grouped or self.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev


def _launch_hint(size: int, module: Optional[str]) -> str:
    target = f"-m audio_algebra_torch.{module}" if module else "<entry point>"
    return f"torchrun --nproc_per_node {size} {target} ..."


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device: str | torch.device | None = "cuda",
              module: Optional[str] = None) -> World:
    """The world of this process: the process group's size and rank (one
    process without a group) on `device` (the card LOCAL_RANK names), along
    one axis. The arguments are JAX's: `n_devices`, when given, must be the
    group's size; `axis_names` / `shape` name one `data` or `seq` axis
    (axes of size 1 beside it are dropped: a process group is one axis).
    Asking for more than one process outside a group of that size raises
    and says how to launch (`module`, the entry point, for the message);
    a group torchrun described in the environment is joined first."""
    names = tuple(axis_names)
    sizes = tuple(int(v) for v in shape) if shape is not None else None
    if sizes is not None and len(sizes) != len(names):
        raise ValueError(f"mesh axes {names} and shape {sizes} differ in length")
    if "model" in names:
        raise NotImplementedError(
            "a 'model' mesh axis (tensor parallelism) has no counterpart in the port: "
            "no entry point of the JAX package shards a model's weights")
    unknown = [a for a in names if a not in AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}: the port's axes are {AXES}")
    if sizes is not None:
        kept = [(a, v) for a, v in zip(names, sizes) if v > 1] or [(names[-1], sizes[-1])]
    else:
        kept = [(names[-1], n_devices)] if len(names) == 1 else None
        if kept is None:
            raise ValueError(f"mesh axes {names} need a shape")
    if len(kept) > 1:
        raise NotImplementedError(
            f"mesh axes {dict(kept)}: a process group is one axis of processes; give "
            "one axis larger than 1")
    axis, want = kept[0]
    dev = resolve_device(device)
    if want is not None and int(want) > 1:
        initialize_distributed(backend="nccl" if dev.type == "cuda" else "gloo")
    size = dist.get_world_size() if in_process_group() else 1
    rank = dist.get_rank() if in_process_group() else 0
    if want is not None and int(want) != size:
        raise ValueError(f"a {axis} axis of {want} needs {want} processes, this world has "
                         f"{size}: launch with {_launch_hint(int(want), module)}")
    return World(size, rank, _rank_device(dev), axis=axis)


def mesh_from_spec(spec: str, device: str | torch.device | None = "cuda",
                   module: Optional[str] = None) -> World:
    """Parse a mesh spec like 'data=2' or 'seq=4' (JAX's surface, e.g.
    mirage.py --mesh) into the world (make_mesh)."""
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
    return make_mesh(axis_names=tuple(axes), shape=tuple(sizes), device=device, module=module)
