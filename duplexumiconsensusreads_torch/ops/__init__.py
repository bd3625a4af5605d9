from duplexumiconsensusreads_torch.ops.pipeline import (  # noqa: F401
    PipelineSpec,
    fused_pipeline,
    spec_for_buckets,
)
