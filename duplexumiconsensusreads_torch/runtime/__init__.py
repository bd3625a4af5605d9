from duplexumiconsensusreads_torch.runtime.executor import (  # noqa: F401
    RunReport,
    call_batch,
    call_consensus_file,
)
