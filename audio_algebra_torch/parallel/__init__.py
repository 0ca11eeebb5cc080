"""Data parallelism over a torch.distributed process group.

Port of audio_algebra_tpu/parallel's data-parallel half: the world
(`make_mesh`, `mesh_from_spec`), the process group and rank-0 gating
(`multihost`), the step with the global batch's semantics
(`make_data_parallel_step`) and plain DDP (`manual.make_manual_ddp_step`).
FSDP and the sequence-parallel decodes are ROADMAP item A7.
"""

from .mesh import World, make_mesh, mesh_from_spec  # noqa: F401
from .train import make_data_parallel_step, shard_batch  # noqa: F401
