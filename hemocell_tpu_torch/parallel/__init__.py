"""Multi-device runs on ``torch.distributed``, one rank per card (NCCL on
CUDA, gloo on the CPU): a 1-D x mesh or a 2-D (x, y) mesh, the lattice cut
into x-slabs or (x, y) tiles.

Counterpart of ``hemocell_tpu/parallel/``: its shard_map runner
(``sharded_step.py``, the cells replicated) and its owner-computes runner
(``owner_step.py``, each rank's cells in fixed-capacity tables).  The GSPMD
runner has no counterpart: what the reference hands to it on a 1-D or an
(x, y) mesh (a field body force, the Lees-Edwards combinations, a domain
the ranks do not divide) runs on the sharded step.
"""

from .comm import Mesh, XMesh, init_distributed, xy_mesh
from .owner_step import (OwnedType, build_owner_runner, owner_supported,
                         owner_unsupported_reason, required_slab_width, suggest_envelope)
from .sharded_step import build_shardmap_runner, build_shardmap_step, sharded_unsupported_reason
from .sharding import gather_state, make_mesh, shard_state, shard_step_config, tile

__all__ = [
    "Mesh", "XMesh", "init_distributed", "xy_mesh", "make_mesh", "tile", "shard_state",
    "shard_step_config", "gather_state", "build_shardmap_step", "build_shardmap_runner",
    "sharded_unsupported_reason", "OwnedType", "build_owner_runner", "owner_supported",
    "owner_unsupported_reason", "required_slab_width", "suggest_envelope",
]
