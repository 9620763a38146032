"""Multi-device execution: `@app:shard` (parallel/shard.py), the partition
mesh and the routed step (parallel/mesh.py), key-sharded group-by and join
placement (parallel/keyshard.py). The port's counterpart of
siddhi_tpu/parallel/; this package imports no JAX."""

from siddhi_tpu_torch.parallel.shard import (  # noqa: F401
    BatchShardRouter,
    ShardRuntime,
    resolve_shard_annotation,
    shard_env_override,
)
