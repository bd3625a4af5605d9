"""Multi-host partitioning (``distributed``: identity, barriers and the
index election on a torch.distributed TCPStore, each host streaming its
own key range) and the bucket-axis helpers of one device (``sharded``).
The per-GPU bucket-block dispatch of the JAX package's mesh is not
ported yet (ROADMAP queue 1 item 5)."""

from duplexumiconsensusreads_torch.parallel.distributed import (  # noqa: F401
    coordination_barrier,
    host_input_range,
    host_tile_range,
    init_distributed,
    multihost_call,
    shutdown_distributed,
)
