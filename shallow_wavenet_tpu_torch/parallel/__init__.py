"""Data parallelism over processes: the launcher's process group, the
per-rank shard of a file list and the gradient's mean all-reduce. The
JAX package's `make_mesh` becomes `init_distributed`; its `data_sharding`
and `replicated` have no counterpart, since a port process holds whole
tensors on its one device."""

from shallow_wavenet_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_mean,
    dp_devices,
    init_distributed,
    is_main,
    process_shard,
    rank,
    shutdown,
    world,
)
