"""Multi-device runs on ``torch.distributed``: a 1-D x mesh with one rank
per card (NCCL on CUDA, gloo on the CPU), the lattice cut into x-slabs and
the cells replicated.

Counterpart of ``hemocell_tpu/parallel/`` for its shard_map runner
(``sharded_step.py``); the owner-computes runner and 2-D meshes are not
ported yet, and the GSPMD runner has no counterpart.
"""

from .comm import XMesh, init_distributed
from .sharded_step import build_shardmap_runner, build_shardmap_step, sharded_unsupported_reason
from .sharding import gather_state, make_mesh, shard_state, shard_step_config

__all__ = [
    "XMesh", "init_distributed", "make_mesh", "shard_state", "shard_step_config",
    "gather_state", "build_shardmap_step", "build_shardmap_runner",
    "sharded_unsupported_reason",
]
