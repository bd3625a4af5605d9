from duplexumiconsensusreads_torch.oracle.grouping import group_reads  # noqa: F401
