from duplexumiconsensusreads_torch.bucketing.buckets import (  # noqa: F401
    Bucket,
    build_buckets,
    stack_buckets,
)
