"""Multi-process scaffolding: the process group, rank-0 gating, the batch
each rank feeds.

Port of audio_algebra_tpu/parallel/multihost.py. JAX runs one process a
host over many devices; torch runs one process a card, in a
`torch.distributed` process group: `nccl` between cards, `gloo` on the
CPU. `torchrun` describes the group in the environment (WORLD_SIZE, RANK,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), where JAX reads
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group the arguments or the environment describe.

    `coordinator` is "host:port" (else MASTER_ADDR:MASTER_PORT),
    `num_processes` the world size (else WORLD_SIZE, else 1), `process_id`
    the rank (else RANK, else 0); explicit arguments override the
    environment. Without a coordinator, or with one process, it does
    nothing and returns False (one process). Returns True when the process
    is in a group, also one joined before the call. `backend` defaults to
    nccl where a card is present, else gloo."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if not coordinator or num_processes <= 1:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def launched_world_size(asked: int, device: torch.device, name: str, flag: str) -> int:
    """The number of processes an entry point's flag asks for, checked
    against the group: `asked` > 1 joins the group torchrun described in
    the environment and raises, saying how to launch, outside one (`name`
    the module, `flag` the flag as the user gives it, e.g. "--num_gpus");
    a larger group raises too, and a smaller one runs on its size and says
    so. `asked` 1 is one process, or a group of one joined before; 0 is
    the launched group's size (JAX's "every local device"). Returns the
    group's size (1 without one)."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if asked == 0:
        initialize_distributed(backend=backend)
        asked = process_count()
    if asked > 1 and not initialize_distributed(backend=backend):
        print(f"{name}: {flag} {asked} asks for {asked} processes, and this one is not in "
              "a process group")
        raise RuntimeError(f"{flag} {asked}: launch one process a card with "
                           f"`torchrun --nproc_per_node {asked} -m audio_algebra_torch.{name} "
                           f"... {flag} {asked}`, or pass {flag} 1")
    size = process_count()
    if size > asked:
        raise RuntimeError(f"{name}: {size} processes launched for {flag} {asked}: "
                           f"pass {flag} {size}")
    if size < asked:
        print(f"{name}: {flag} {asked}, {size} processes launched: running on {size}")
    return size


def data_parallel_world(args, device: torch.device, name: str, fsdp: bool = False):
    """The data-parallel world the flags ask for (parallel.World).

    `--num_gpus N` > 1 trains over N processes, one a card, that torchrun
    (or any launcher setting WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT)
    started: `torchrun --nproc_per_node N -m audio_algebra_torch.<trainer>
    ... --num_gpus N`. Outside such a group it raises and says how to
    launch, rather than train on one card (launched_world_size). `--fsdp 1`
    (a sharded train state, parallel/fsdp.py) is taken by the trainers
    that pass `fsdp=True` (train_clapdae, as in JAX); the others raise on
    it rather than ignore it. `name` is the entry point's module, for the
    messages."""
    from .mesh import make_mesh      # mesh.py imports this module

    if int(getattr(args, "fsdp", 0) or 0) and not fsdp:
        print(f"{name}: --fsdp {args.fsdp} asks for a sharded train state, which only "
              "train_clapdae keeps")
        raise ValueError(f"--fsdp: {name} keeps a replicated train state; only "
                         "train_clapdae shards its state (parallel/fsdp.py)")
    launched_world_size(max(args.num_gpus, 1), device, name, "--num_gpus")
    world = make_mesh(device=device)
    if world.size > 1:
        print(f"{name}: data parallel over {world.size} processes, rank {world.rank} on "
              f"{world.device}")
    return world


def in_process_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if in_process_group() else 0


def process_count() -> int:
    return dist.get_world_size() if in_process_group() else 1


def is_main_process() -> bool:
    """Rank-0 gate for printing, logging and checkpoints."""
    return process_index() == 0


class HostPrinter:
    """Print only on the main process."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def __call__(self, *args, **kwargs):
        if is_main_process():
            print(self.prefix, *args, **kwargs)


class Shard:
    """A rank's own rows of a global batch, on its device: the steps of
    parallel.train and parallel.manual take it as it is, where a plain
    array is the global batch and each rank cuts its rows from it."""

    def __init__(self, local: torch.Tensor):
        self.local = local


def global_batch_sharding(world, per_host_batch: int):
    """`place(local_batch) -> Shard`: the batch this rank loaded (its
    `per_host_batch` rows of the global batch, which has world.size times
    as many) on the rank's device. The size is checked at every batch: a
    loader that drifts from the agreed shard would desync the ranks'
    collectives."""

    def place(local_batch) -> Shard:
        x = torch.as_tensor(local_batch)
        if x.shape[0] != per_host_batch:
            raise ValueError(f"local batch {x.shape[0]} != agreed per_host_batch "
                             f"{per_host_batch}")
        return Shard(x.to(world.device))

    return place
