from duplexumiconsensusreads_torch.oracle.grouping import group_reads  # noqa: F401
from duplexumiconsensusreads_torch.oracle.consensus import (  # noqa: F401
    call_consensus,
    single_strand_consensus,
    duplex_merge,
)
from duplexumiconsensusreads_torch.oracle.error_model import (  # noqa: F401
    fit_cycle_error_model,
    apply_cycle_error_model,
)
