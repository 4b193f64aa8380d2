"""Data-parallel meshes and angle-sharded operators over ``torch.distributed``
(port of ``pdunet_tpu/parallel``): ``sharding`` (mesh, replication, batch
shards, the collectives of the sharded train step), ``angle_shard`` (the
projector sharded over the mesh's angle axis) and ``launch`` (one process
per rank, and the command-line flags of a run over several)."""

from pdunet_tpu_torch.parallel.sharding import (
    ANGLE,
    DATA,
    Mesh,
    gather_batch,
    init_distributed,
    make_mesh,
    mean_over,
    replicate,
    shard_batch,
)

__all__ = ["ANGLE", "DATA", "Mesh", "gather_batch", "init_distributed", "make_mesh",
           "mean_over", "replicate", "shard_batch"]
