"""Multi-device and multi-host execution: device meshes (``mesh``: a
(data,) or (data, cycle) grid of CUDA devices, or of logical CPU
lanes), the per-lane bucket-block dispatch of the fused pipeline
(``sharded``: one contiguous bucket block per data lane, each on its
own device and stream, no collectives), and multi-host partitioning
(``distributed``: identity, barriers and the index election on a
torch.distributed TCPStore, each host streaming its own key range)."""

from duplexumiconsensusreads_torch.parallel.distributed import (  # noqa: F401
    coordination_barrier,
    host_input_range,
    host_tile_range,
    init_distributed,
    multihost_call,
    shutdown_distributed,
)
from duplexumiconsensusreads_torch.parallel.mesh import make_mesh  # noqa: F401
from duplexumiconsensusreads_torch.parallel.sharded import (  # noqa: F401
    presharded_pipeline,
    put_lanes,
    sharded_pipeline,
    stage_lanes,
)
