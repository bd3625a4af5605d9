"""NumPy oracle for single-strand and duplex consensus calling.

fgbio-style per-cycle Bayesian consensus (general-knowledge math, see
SURVEY.md §7 "Domain background"; the reference mount was empty so this
oracle *defines* the framework's numerics):

  Per family, per cycle, for candidate base b in {A,C,G,T}:
      loglik[b] = sum over contributing reads i of
                    log(1 - e_i)   if read base == b
                    log(e_i / 3)   otherwise
  with e_i the error prob of the (capped) input quality. Consensus base
  is argmax_b posterior; consensus quality is the Phred of
  1 - max posterior, capped. Cycles with zero depth emit N.

Duplex merge combines the AB- and BA-strand single-strand calls:
agreement boosts quality (sum, capped), disagreement keeps the
higher-quality base at the quality difference, ties and N-inputs emit N.
"""

from __future__ import annotations

import numpy as np

from duplexumiconsensusreads_torch.constants import (
    BASE_N,
    N_REAL_BASES,
    NO_CALL_QUAL,
    NO_FAMILY,
)
from duplexumiconsensusreads_torch.types import (
    ConsensusBatch,
    ConsensusParams,
    FamilyAssignment,
    ReadBatch,
)
from duplexumiconsensusreads_torch.utils.phred import error_to_phred, phred_to_error


def single_strand_consensus(
    bases: np.ndarray,
    quals: np.ndarray,
    params: ConsensusParams,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Consensus of one family: bases/quals (K, L) ->
    (base, qual, depth, err) per cycle; err counts contributing reads
    that disagree with the called base (0 where no call)."""
    k, l = bases.shape
    out_base = np.full(l, BASE_N, np.uint8)
    out_qual = np.full(l, NO_CALL_QUAL, np.uint8)
    depth = np.zeros(l, np.int32)
    err = np.zeros(l, np.int32)
    for c in range(l):
        ll = np.zeros(N_REAL_BASES)
        cnt = np.zeros(N_REAL_BASES, np.int32)
        d = 0
        for i in range(k):
            b = bases[i, c]
            if b >= N_REAL_BASES:  # N or PAD: no evidence
                continue
            if int(quals[i, c]) < params.min_input_qual:  # masked base
                continue
            e = phred_to_error(min(int(quals[i, c]), params.max_input_qual))
            ll += np.log(e / 3.0)
            ll[b] += np.log1p(-e) - np.log(e / 3.0)
            cnt[b] += 1
            d += 1
        depth[c] = d
        if d == 0:
            continue
        ll -= ll.max()
        post = np.exp(ll)
        post /= post.sum()
        b = int(np.argmax(post))
        out_base[c] = b
        out_qual[c] = error_to_phred(1.0 - post[b], params.max_qual)
        err[c] = d - cnt[b]
    return out_base, out_qual, depth, err


def duplex_merge(
    base_ab: np.ndarray,
    qual_ab: np.ndarray,
    depth_ab: np.ndarray,
    err_ab: np.ndarray,
    base_ba: np.ndarray,
    qual_ba: np.ndarray,
    depth_ba: np.ndarray,
    err_ba: np.ndarray,
    params: ConsensusParams,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Merge the two strand consensi of one molecule, per cycle. The
    error count is the sum of each strand's own-consensus
    disagreements (strand-level discordance shows up as the duplex
    base/qual, not in ce)."""
    l = len(base_ab)
    out_base = np.full(l, BASE_N, np.uint8)
    out_qual = np.full(l, NO_CALL_QUAL, np.uint8)
    depth = (depth_ab + depth_ba).astype(np.int32)
    err = (err_ab + err_ba).astype(np.int32)
    for c in range(l):
        ba, bb = int(base_ab[c]), int(base_ba[c])
        qa, qb = int(qual_ab[c]), int(qual_ba[c])
        if ba >= N_REAL_BASES or bb >= N_REAL_BASES:
            continue
        if ba == bb:
            out_base[c] = ba
            out_qual[c] = min(qa + qb, params.max_qual)
        elif qa != qb:
            out_base[c] = ba if qa > qb else bb
            out_qual[c] = max(abs(qa - qb), NO_CALL_QUAL)
        # qa == qb with disagreeing bases: stays N
    return out_base, out_qual, depth, err


def call_consensus(
    batch: ReadBatch,
    fams: FamilyAssignment,
    params: ConsensusParams,
    quals_override: np.ndarray | None = None,
) -> ConsensusBatch:
    """Call consensus for every family (ss mode) or molecule (duplex mode).

    Output row f corresponds to dense family id f (single_strand) or
    dense molecule id f (duplex). ``quals_override`` substitutes
    recalibrated qualities (error-model path) without touching bases.
    """
    quals = batch.quals if quals_override is None else quals_override
    bases = np.asarray(batch.bases)
    quals = np.asarray(quals)
    fam = np.asarray(fams.family_id)
    mol = np.asarray(fams.molecule_id)
    strand = np.asarray(batch.strand_ab, bool)
    valid = np.asarray(batch.valid, bool)
    l = batch.read_len

    n_fam = int(fams.n_families)
    ss = {}
    for f in range(n_fam):
        sel = np.nonzero((fam == f) & valid)[0]
        if len(sel) < params.min_reads:
            continue
        ss[f] = single_strand_consensus(bases[sel], quals[sel], params)

    if params.mode == "single_strand":
        out = ConsensusBatch(
            bases=np.full((n_fam, l), BASE_N, np.uint8),
            quals=np.full((n_fam, l), NO_CALL_QUAL, np.uint8),
            depth=np.zeros((n_fam, l), np.int32),
            valid=np.zeros(n_fam, bool),
            err=np.zeros((n_fam, l), np.int32),
        )
        for f, (b, q, d, e) in ss.items():
            out.bases[f], out.quals[f], out.depth[f], out.err[f] = b, q, d, e
            out.valid[f] = True
        return out

    if params.mode != "duplex":
        raise ValueError(f"unknown consensus mode {params.mode!r}")

    n_mol = int(fams.n_molecules)
    out = ConsensusBatch(
        bases=np.full((n_mol, l), BASE_N, np.uint8),
        quals=np.full((n_mol, l), NO_CALL_QUAL, np.uint8),
        depth=np.zeros((n_mol, l), np.int32),
        valid=np.zeros(n_mol, bool),
        err=np.zeros((n_mol, l), np.int32),
    )
    for mid in range(n_mol):
        sel_ab = np.nonzero((mol == mid) & valid & strand)[0]
        sel_ba = np.nonzero((mol == mid) & valid & ~strand)[0]
        if (
            len(sel_ab) < params.min_duplex_reads
            or len(sel_ba) < params.min_duplex_reads
        ):
            continue
        fa = fam[sel_ab[0]]
        fb = fam[sel_ba[0]]
        if fa == NO_FAMILY or fb == NO_FAMILY or fa not in ss or fb not in ss:
            continue
        if fa == fb:
            raise ValueError(
                "duplex consensus requires paired grouping "
                "(GroupingParams(paired=True)); got a shared AB/BA family id"
            )
        b, q, d, e = duplex_merge(*ss[fa], *ss[fb], params)
        out.bases[mid], out.quals[mid], out.depth[mid] = b, q, d
        out.err[mid] = e
        out.valid[mid] = True
    return out
