"""IO layer: BGZF/BAM codec and ReadBatch interchange.

Produces the padded host tensors everything downstream runs on. BAM
input parses through the native loader (io/native_reader.py over the
C++ library in native/) unless ref projection, a UMI whitelist or
DUT_NO_NATIVE=1 selects the pure-Python codec here, the portable
reference.
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
    else the native BAM parse (DUT_NO_NATIVE=1 forces the portable
    codec; a native build failure raises), as the JAX package's
    load_input. Returns (header, batch, info). warn_mixed=False defers
    the mixed-mate warning to the caller (mate-aware auto-resolution
    decides whether it applies). ref_projected=True projects reads onto
    reference columns (io/refproject.py) — BAM inputs only (the .npz
    interchange carries no CIGARs), via the portable codec (the native
    fast path hands back a finished batch; projection needs the parsed
    records)."""
    from duplexumiconsensusreads_torch.native import native_enabled

    if path.endswith(".npz"):
        if ref_projected:
            raise ValueError(
                "ref-projected consensus requires BAM input (CIGARs); "
                ".npz interchange carries none"
            )
        from duplexumiconsensusreads_torch.io.convert import (
            correct_umis_whitelist,
            mixed_ends_present,
        )

        batch = load_readbatch(path)
        info = {
            "n_records": batch.n_reads,
            # same auto-detection semantics as the BAM codecs: on only
            # when some family actually mixes fragment ends
            "mixed_mates": mixed_ends_present(batch),
        }
        if umi_whitelist is not None:
            info.update(
                correct_umis_whitelist(batch, umi_whitelist, umi_max_mismatches)
            )
            info["mixed_mates"] = mixed_ends_present(batch)
        return BamHeader.synthetic(), batch, info
    # the native fast path applies its family policies (modal-CIGAR
    # vote) during the fill, which must see CORRECTED UMIs — whitelist
    # runs take the portable codec, like ref_projected does
    if not ref_projected and umi_whitelist is None and native_enabled():
        from duplexumiconsensusreads_torch.io.native_reader import read_bam_native

        return read_bam_native(path, duplex=duplex, warn_mixed=warn_mixed)
    header, recs = read_bam(path)
    batch, info = records_to_readbatch(
        recs, duplex=duplex, warn_mixed=warn_mixed,
        ref_projected=ref_projected, mate_aware=mate_aware,
        umi_whitelist=umi_whitelist, umi_max_mismatches=umi_max_mismatches,
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
