from duplexumiconsensusreads_torch.ops.grouper import UmiGrouper  # noqa: F401
from duplexumiconsensusreads_torch.ops.caller import ConsensusCaller  # noqa: F401
from duplexumiconsensusreads_torch.ops.pipeline import (  # noqa: F401
    PipelineSpec,
    fused_pipeline,
    run_bucket,
    spec_for_buckets,
)
