"""Core data model: padded, static-shape tensors for reads and consensus.

Everything downstream of IO operates on ``ReadBatch`` — an
HBM-resident struct-of-arrays with fully static shapes, the design
mandated by the north-star (BASELINE.json: "batched JAX kernels over an
HBM-resident padded read/quality tensor"). Fields are NumPy arrays on
the host path and torch tensors on the device path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from duplexumiconsensusreads_torch.constants import NO_FAMILY


@dataclasses.dataclass
class ReadBatch:
    """A padded batch of N aligned reads, each up to L cycles.

    bases:     u8 (N, L)  0..3 real, 4=N, 5=PAD (beyond read length)
    quals:     u8 (N, L)  Phred; 0 on PAD cycles
    umi:       u8 (N, U)  2-bit codes; for duplex input this is the
                          *canonicalised* concatenated UMI pair (see io/)
    pos_key:   i64 (N,)   packed canonical genomic key (ref, unclipped
                          start[, mate start]); identical for all reads
                          of one source molecule
    strand_ab: bool (N,)  True = top (AB) strand read, False = bottom (BA)
    frag_end:  bool (N,)  fragment-end bit: True iff the read observes
                          the template's SECOND fragment end. For a
                          paired record this is READ2==top-strand (so
                          top-R1 and bottom-R2 share end 1 — the
                          fgbio-style cross-mate duplex partners);
                          single-end records are always end 1. Used by
                          mate-aware grouping (GroupingParams.mate_aware)
                          to keep opposite fragment ends in separate
                          cycle-space families.
    valid:     bool (N,)  False marks padding slots in the batch
    """

    bases: Any
    quals: Any
    umi: Any
    pos_key: Any
    strand_ab: Any
    frag_end: Any
    valid: Any

    @property
    def n_reads(self) -> int:
        return self.bases.shape[0]

    @property
    def read_len(self) -> int:
        return self.bases.shape[1]

    @property
    def umi_len(self) -> int:
        return self.umi.shape[1]

    @staticmethod
    def empty(n: int, l: int, u: int) -> "ReadBatch":
        from duplexumiconsensusreads_torch.constants import BASE_PAD

        return ReadBatch(
            bases=np.full((n, l), BASE_PAD, np.uint8),
            quals=np.zeros((n, l), np.uint8),
            umi=np.zeros((n, u), np.uint8),
            pos_key=np.zeros((n,), np.int64),
            strand_ab=np.zeros((n,), bool),
            frag_end=np.zeros((n,), bool),
            valid=np.zeros((n,), bool),
        )

    def take(self, idx) -> "ReadBatch":
        return ReadBatch(
            bases=self.bases[idx],
            quals=self.quals[idx],
            umi=self.umi[idx],
            pos_key=self.pos_key[idx],
            strand_ab=self.strand_ab[idx],
            frag_end=self.frag_end[idx],
            valid=self.valid[idx],
        )


@dataclasses.dataclass
class FamilyAssignment:
    """Output of UmiGrouper: per-read family/molecule labels.

    family_id:   i32 (N,)  dense id of the (molecule, strand) single-strand
                           family; NO_FAMILY for invalid/unassigned reads.
                           Mate-aware grouping splits families further by
                           fragment end: (molecule, frag_end, strand)
    molecule_id: i32 (N,)  dense id of the consensus OUTPUT unit: the
                           source molecule (duplex: the AB and BA
                           families of one molecule share it), or, under
                           mate-aware grouping, the (molecule, frag_end)
                           pair — each emits its own duplex consensus
    pair_id:     i32 (N,)  dense id of the source molecule proper —
                           equals molecule_id except under mate-aware
                           grouping, where the two fragment-end units of
                           one molecule share it (it links the emitted
                           R1/R2 consensus mates)
    n_families:  i32 ()    number of distinct family ids in this batch
    n_molecules: i32 ()    number of distinct molecule (unit) ids
    """

    family_id: Any
    molecule_id: Any
    pair_id: Any
    n_families: Any
    n_molecules: Any

    @staticmethod
    def none(n: int) -> "FamilyAssignment":
        return FamilyAssignment(
            family_id=np.full((n,), NO_FAMILY, np.int32),
            molecule_id=np.full((n,), NO_FAMILY, np.int32),
            pair_id=np.full((n,), NO_FAMILY, np.int32),
            n_families=np.int32(0),
            n_molecules=np.int32(0),
        )


@dataclasses.dataclass
class ConsensusBatch:
    """Output of ConsensusCaller: F padded consensus reads.

    bases: u8 (F, L)   consensus base codes (4=N)
    quals: u8 (F, L)   consensus Phred qualities
    depth: i32 (F, L)  per-cycle read depth that contributed
    valid: bool (F,)   False marks padding families
    err:   i32 (F, L)  per-cycle count of contributing reads that
                       disagree with the consensus base (duplex: sum of
                       the two strands' own-consensus disagreements)
    """

    bases: Any
    quals: Any
    depth: Any
    valid: Any
    err: Any = None


@dataclasses.dataclass(frozen=True)
class GroupingParams:
    """UmiGrouper configuration (static / hashable — safe as jit static arg).

    strategy:     "exact" (identical UMI), "adjacency" (directional
                  clustering, UMI-tools algorithm, Hamming <= max_hamming),
                  or "cluster" (UMI-tools cluster method: symmetric
                  connected components within Hamming <= max_hamming,
                  labeled by their highest-count member — identical to
                  adjacency with the count condition removed, which is
                  exactly how both implementations realize it:
                  count_ratio 0 makes the directed edge condition
                  count >= -1 vacuously true and the edge set symmetric)
    max_hamming:  adjacency/cluster edge threshold (reference: 1)
    count_ratio:  directional edge condition count(a) >= ratio*count(b)-1
                  (reference behaviour: 2; forced 0 under "cluster")
    paired:       duplex mode — reads carry a canonicalised UMI pair and
                  strand_ab distinguishes top/bottom families
    mate_aware:   paired-end mode — the fragment-end bit joins the
                  family identity, so a template's R1 and R2 mates
                  (opposite fragment ends, disjoint cycle spaces) form
                  separate families, and each (molecule, fragment end)
                  becomes its own duplex output unit — pairing the
                  top-strand R1 family with the bottom-strand R2 family
                  (the fgbio CallDuplexConsensusReads pairing). With no
                  second-end reads present the grouping is identical to
                  mate_aware=False by construction.
    """

    strategy: str = "exact"
    max_hamming: int = 1
    count_ratio: int = 2
    paired: bool = False
    mate_aware: bool = False

    @property
    def effective_count_ratio(self) -> int:
        """The directional edge ratio the implementations consume:
        "cluster" is adjacency with the count condition removed."""
        return 0 if self.strategy == "cluster" else self.count_ratio


@dataclasses.dataclass(frozen=True)
class ConsensusParams:
    """ConsensusCaller configuration (static / hashable).

    mode:            "single_strand" or "duplex"
    min_reads:       minimum reads per single-strand family; smaller
                     families emit no consensus
    min_duplex_reads: minimum reads on EACH strand for a duplex call
    max_qual:        cap on emitted consensus quality
    max_input_qual:  cap applied to input qualities before the math
    min_input_qual:  bases below this quality contribute NO evidence
                     (masked like N, excluded from depth) — the
                     fgbio-style min-input-base-quality filter
    error_model:     None, or "cycle" to apply a fitted per-cycle
                     quality cap before consensus (benchmark config 5)
    """

    mode: str = "single_strand"
    min_reads: int = 1
    min_duplex_reads: int = 1
    max_qual: int = 90
    max_input_qual: int = 50
    min_input_qual: int = 0
    error_model: str | None = None
