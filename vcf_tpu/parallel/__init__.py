"""Data-parallel execution over a device mesh.

The reference is single-process (SURVEY §2.4); parallelism here is new
device-native design: frames / tiles / GOPs are the independent units,
sharded over a `jax.sharding.Mesh`, side information (codebooks,
levels, tables) replicated, and variable-length compressed streams
gathered on the host in frame order.
"""

from vcf_tpu.parallel.mesh import make_mesh, shard_batch, BatchCodec

__all__ = ["make_mesh", "shard_batch", "BatchCodec"]
