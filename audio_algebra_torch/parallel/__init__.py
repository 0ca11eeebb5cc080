"""Parallelism over a torch.distributed process group.

Port of audio_algebra_tpu/parallel: the world (`make_mesh`,
`mesh_from_spec`: a `data` or `seq` axis of processes), the process group
and rank-0 gating (`multihost`), the step with the global batch's
semantics (`make_data_parallel_step`), plain DDP
(`manual.make_manual_ddp_step`), the sharded train state (`fsdp`), and the
sequence-parallel decodes (`seq`, `infer`: `decode_unet_seqpar`).
"""

from .infer import decode_unet_seqpar, pick_sharded_levels  # noqa: F401
from .mesh import World, make_mesh, mesh_from_spec  # noqa: F401
from .train import make_data_parallel_step, shard_batch  # noqa: F401
