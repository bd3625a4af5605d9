from duplexumiconsensusreads_torch.bucketing.buckets import (  # noqa: F401
    STACKED_KEYS,
    Bucket,
    build_buckets,
    pad_buckets,
    stack_buckets,
)
