from duplexumiconsensusreads_torch.utils.phred import (  # noqa: F401
    phred_to_error,
    error_to_phred,
    seq_to_codes,
    codes_to_seq,
    pack_umi,
)
