from duplexumiconsensusreads_torch.kernels.encoding import pack_umi_words  # noqa: F401
from duplexumiconsensusreads_torch.kernels.grouping import group_kernel  # noqa: F401
from duplexumiconsensusreads_torch.kernels.consensus import (  # noqa: F401
    ssc_kernel,
    duplex_kernel,
    duplex_merge_strided,
)
from duplexumiconsensusreads_torch.kernels.error_model import (  # noqa: F401
    fit_cycle_cap_kernel,
    apply_cycle_cap,
)
