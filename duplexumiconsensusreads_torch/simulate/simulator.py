"""Truth-aware synthetic read simulator.

Generates ground-truth source molecules (known sequence, position, UMI
pair), then amplifies each into top-/bottom-strand reads with
Phred-consistent sequencing errors and optional UMI base errors (to
exercise directional adjacency clustering). Because the true molecule
sequence is known, tests can measure the *consensus error rate* of any
pipeline output directly — this is the stand-in for "matched consensus
error rate" given the empty reference mount (SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from duplexumiconsensusreads_torch.constants import BASE_N, N_REAL_BASES
from duplexumiconsensusreads_torch.types import ReadBatch


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_molecules: int = 64
    read_len: int = 48
    umi_len: int = 6           # per-strand UMI; duplex uses a pair => 2*umi_len codes
    n_positions: int = 4       # distinct genomic positions (tiles collapse later)
    mean_family_size: int = 4  # reads per (molecule, strand), geometric-ish
    max_family_size: int = 16
    base_error: float = 0.01   # per-base sequencing error prob (flat component)
    cycle_error_slope: float = 0.0  # extra error prob per cycle (config 5 exercises >0)
    umi_error: float = 0.0     # per-UMI-base error prob (exercises adjacency grouping)
    indel_error: float = 0.0   # per-read prob of a 1bp indel (CIGAR I/D; exercises
    #                            the modal-CIGAR input filter — simulated_bam only,
    #                            since indels live in BAM CIGARs, not ReadBatch)
    qual_lo: int = 20
    qual_hi: int = 40
    duplex: bool = True
    paired_reads: bool = False  # each (molecule, strand) family's reads
    #                             come as R1+R2 mate PAIRS covering two
    #                             distinct fragment ends (mol_seq /
    #                             mol_seq2); exercises mate-aware calling
    n_frac: float = 0.0        # fraction of read bases replaced by N
    seed: int = 0


@dataclasses.dataclass
class SimTruth:
    """Ground truth: per-molecule sequence + per-read provenance."""

    mol_seq: np.ndarray       # u8 (M, L) true molecule sequences (fragment end 1)
    mol_pos_key: np.ndarray   # i64 (M,)
    mol_umi: np.ndarray       # u8 (M, U) canonical UMI(-pair) codes
    read_mol: np.ndarray      # i32 (N,) true molecule id per read
    read_strand: np.ndarray   # bool (N,) true strand per read
    mol_seq2: np.ndarray | None = None  # u8 (M, L) fragment-end-2 truth
    #                                     (paired_reads only)
    read_end2: np.ndarray | None = None  # bool (N,) fragment end per read


def _geometric_sizes(rng, n, mean, max_size):
    sizes = rng.geometric(1.0 / mean, size=n)
    return np.clip(sizes, 1, max_size)


def simulate_batch(cfg: SimConfig) -> tuple[ReadBatch, SimTruth]:
    """Simulate one batch of reads with full ground truth.

    Per-cycle error prob for cycle c is ``base_error + c*cycle_error_slope``.
    Reported quality is drawn uniformly in [qual_lo, qual_hi] and the
    realised error event is sampled from the *true* per-cycle error, so a
    fitted per-cycle error model has a real signal to recover.
    """
    rng = np.random.default_rng(cfg.seed)
    m, l, u = cfg.n_molecules, cfg.read_len, cfg.umi_len

    mol_seq = rng.integers(0, N_REAL_BASES, size=(m, l), dtype=np.uint8)
    pos_choices = (np.arange(cfg.n_positions, dtype=np.int64) + 1) * 1000
    mol_pos = rng.choice(pos_choices, size=m)
    upair = 2 * u if cfg.duplex else u
    # Distinct (pos, UMI) per molecule so ground truth really is 1:1 with
    # exact families (resample collisions; UMI read errors are separate).
    mol_umi = rng.integers(0, N_REAL_BASES, size=(m, upair), dtype=np.uint8)
    for _ in range(100):
        keys = [(mol_pos[i], mol_umi[i].tobytes()) for i in range(m)]
        seen: dict = {}
        dup = [i for i, k in enumerate(keys) if seen.setdefault(k, i) != i]
        if not dup:
            break
        mol_umi[dup] = rng.integers(0, N_REAL_BASES, size=(len(dup), upair), dtype=np.uint8)
    else:
        raise RuntimeError("could not draw distinct (pos, UMI) molecule keys")

    # fragment end 2 has its own true sequence (paired_reads mode):
    # a template's R1 and R2 mates genuinely observe different bases,
    # so mixing them in one consensus family is measurably wrong
    mol_seq2 = (
        rng.integers(0, N_REAL_BASES, size=(m, l), dtype=np.uint8)
        if cfg.paired_reads
        else None
    )

    strands = [True, False] if cfg.duplex else [True]
    per_strand_sizes = {
        s: _geometric_sizes(rng, m, cfg.mean_family_size, cfg.max_family_size)
        for s in strands
    }
    ends = [False, True] if cfg.paired_reads else [False]
    n_reads = int(sum(sz.sum() for sz in per_strand_sizes.values())) * len(ends)

    bases = np.empty((n_reads, l), np.uint8)
    quals = np.empty((n_reads, l), np.uint8)
    umi = np.empty((n_reads, upair), np.uint8)
    pos_key = np.empty((n_reads,), np.int64)
    strand_ab = np.empty((n_reads,), bool)
    frag_end = np.empty((n_reads,), bool)
    read_mol = np.empty((n_reads,), np.int32)

    cycle_err = cfg.base_error + cfg.cycle_error_slope * np.arange(l)
    cycle_err = np.clip(cycle_err, 1e-6, 0.5)

    i = 0
    for s in strands:
        for mol in range(m):
            # paired_reads: the family's k read PAIRS contribute k reads
            # to EACH fragment end (every R1 has its R2 mate)
            k = int(per_strand_sizes[s][mol])
            for e2 in ends:
                sl = slice(i, i + k)
                i += k
                true_seq = mol_seq2[mol] if e2 else mol_seq[mol]
                b = np.broadcast_to(true_seq, (k, l)).copy()
                err = rng.random((k, l)) < cycle_err[None, :]
                # substitution: true base + offset in {1,2,3} mod 4
                offset = rng.integers(1, N_REAL_BASES, size=(k, l), dtype=np.uint8)
                b[err] = (b[err] + offset[err]) % N_REAL_BASES
                if cfg.n_frac > 0:
                    b[rng.random((k, l)) < cfg.n_frac] = BASE_N
                bases[sl] = b
                quals[sl] = rng.integers(cfg.qual_lo, cfg.qual_hi + 1, size=(k, l))
                uread = np.broadcast_to(mol_umi[mol], (k, upair)).copy()
                if cfg.umi_error > 0:
                    uerr = rng.random((k, upair)) < cfg.umi_error
                    uoff = rng.integers(
                        1, N_REAL_BASES, size=(k, upair), dtype=np.uint8
                    )
                    uread[uerr] = (uread[uerr] + uoff[uerr]) % N_REAL_BASES
                umi[sl] = uread
                pos_key[sl] = mol_pos[mol]
                strand_ab[sl] = s
                frag_end[sl] = e2
                read_mol[sl] = mol

    perm = rng.permutation(n_reads)
    batch = ReadBatch(
        bases=bases[perm],
        quals=quals[perm],
        umi=umi[perm],
        pos_key=pos_key[perm],
        strand_ab=strand_ab[perm],
        frag_end=frag_end[perm],
        valid=np.ones((n_reads,), bool),
    )
    truth = SimTruth(
        mol_seq=mol_seq,
        mol_pos_key=mol_pos,
        mol_umi=mol_umi,
        read_mol=read_mol[perm],
        read_strand=strand_ab[perm],
        mol_seq2=mol_seq2,
        read_end2=frag_end[perm],
    )
    return batch, truth


def pad_batch(batch: ReadBatch, n_to: int) -> ReadBatch:
    """Pad a ReadBatch with invalid slots up to n_to reads (static shapes)."""
    n = batch.n_reads
    if n_to < n:
        raise ValueError(f"pad target {n_to} < batch size {n}")
    out = ReadBatch.empty(n_to, batch.read_len, batch.umi_len)
    for name in (
        "bases", "quals", "umi", "pos_key", "strand_ab", "frag_end", "valid"
    ):
        arr = getattr(out, name)
        arr[:n] = getattr(batch, name)
    return out
