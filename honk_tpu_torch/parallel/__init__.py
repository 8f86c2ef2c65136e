"""Data parallel on ``torch.distributed``: one process per device, the batch's rows split by rank."""

from .mesh import DataMesh, make_data_mesh
from .runtime import (
    barrier, initialize_distributed, is_primary, launch_local_ranks, rank, rank_device, shutdown, world_size,
)

__all__ = [
    "DataMesh", "barrier", "initialize_distributed", "is_primary", "launch_local_ranks", "make_data_mesh",
    "rank", "rank_device", "shutdown", "world_size",
]
