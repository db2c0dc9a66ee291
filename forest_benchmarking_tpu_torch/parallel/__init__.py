"""Sharding of a problem batch over a mesh of devices. Port of
``forest_benchmarking_tpu/parallel``."""
from forest_benchmarking_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, shard_batch, replicate, batch_sharded, shard_map_batched,
    fold_in, Mesh)
