"""IO layer: BGZF/BAM codec and ReadBatch interchange.

Produces the padded host tensors everything downstream runs on. The
pure-Python codec here is the only path: the port carries no native
reader.
"""

from duplexumiconsensusreads_torch.io.bam import (
    BamHeader,
    BamRecords,
    read_bam,
    write_bam,
)
from duplexumiconsensusreads_torch.io.convert import (
    consensus_to_records,
    readbatch_to_records,
    records_to_readbatch,
    simulated_bam,
)
from duplexumiconsensusreads_torch.io.npz import load_readbatch, save_readbatch


def load_input(
    path: str, duplex: bool, warn_mixed: bool = True,
    ref_projected: bool = False, mate_aware: str = "off",
    umi_whitelist=None, umi_max_mismatches: int = 1,
):
    """ONE input loader for every consumer: .npz ReadBatch interchange,
    else the portable BAM codec. Returns (header, batch, info).
    warn_mixed=False defers the mixed-mate warning to the caller
    (mate-aware auto-resolution decides whether it applies).
    ref_projected / umi_whitelist are not ported and raise."""
    if ref_projected:
        raise NotImplementedError(
            "ref_projected consensus is not ported to the torch package"
        )
    if umi_whitelist is not None:
        raise NotImplementedError(
            "umi_whitelist correction is not ported to the torch package"
        )
    if path.endswith(".npz"):
        from duplexumiconsensusreads_torch.io.convert import mixed_ends_present

        batch = load_readbatch(path)
        info = {
            "n_records": batch.n_reads,
            # same auto-detection semantics as the BAM codec: on only
            # when some family actually mixes fragment ends
            "mixed_mates": mixed_ends_present(batch),
        }
        return BamHeader.synthetic(), batch, info
    header, recs = read_bam(path)
    batch, info = records_to_readbatch(
        recs, duplex=duplex, warn_mixed=warn_mixed, mate_aware=mate_aware,
    )
    return header, batch, info


__all__ = [
    "load_input",
    "BamHeader",
    "BamRecords",
    "read_bam",
    "write_bam",
    "records_to_readbatch",
    "readbatch_to_records",
    "consensus_to_records",
    "simulated_bam",
    "save_readbatch",
    "load_readbatch",
]
