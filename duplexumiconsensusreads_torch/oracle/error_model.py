"""NumPy oracle for the per-cycle base-quality error model (config 5).

Fit: empirical per-cycle disagreement rate between raw reads and their
single-strand family consensus (Laplace-smoothed), expressed as a Phred
cap per cycle. Apply: clip every input quality at its cycle's cap, so
over-confident late-cycle qualities are recalibrated before consensus.
This two-pass (fit on first-pass consensus, re-call with recalibrated
qualities) is the framework's definition of benchmark config 5.
"""

from __future__ import annotations

import numpy as np

from duplexumiconsensusreads_torch.constants import N_REAL_BASES, NO_FAMILY
from duplexumiconsensusreads_torch.types import ConsensusBatch, FamilyAssignment, ReadBatch
from duplexumiconsensusreads_torch.utils.phred import phred_cap_from_counts


def fit_cycle_error_model(
    batch: ReadBatch,
    fams: FamilyAssignment,
    ss_consensus: ConsensusBatch,
    max_phred_cap: int = 60,
) -> np.ndarray:
    """Per-cycle Phred cap (L,) u8 from read-vs-consensus mismatch rates.

    Only cycles where both the read base and its family consensus base
    are real (A/C/G/T) contribute. Rate is (mismatch+1)/(n+2).
    """
    bases = np.asarray(batch.bases)
    fam = np.asarray(fams.family_id)
    valid = np.asarray(batch.valid, bool)
    l = batch.read_len
    mism = np.zeros(l, np.int64)
    total = np.zeros(l, np.int64)
    for i in np.nonzero(valid & (fam != NO_FAMILY))[0]:
        f = fam[i]
        if not ss_consensus.valid[f]:
            continue
        cb = ss_consensus.bases[f]
        ok = (bases[i] < N_REAL_BASES) & (cb < N_REAL_BASES)
        total += ok
        mism += ok & (bases[i] != cb)
    return phred_cap_from_counts(mism, total, max_phred_cap)


def apply_cycle_error_model(quals: np.ndarray, cycle_cap: np.ndarray) -> np.ndarray:
    """Clip qualities (N, L) at the per-cycle cap (L,)."""
    return np.minimum(quals, cycle_cap[None, :]).astype(np.uint8)
