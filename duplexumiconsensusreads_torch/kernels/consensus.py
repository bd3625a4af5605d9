"""Consensus kernels, batched over the bucket axis: single-strand
log-likelihood calling and the duplex merges (strided and gather-based).

Per-read per-cycle log-likelihood contributions are built as one
(N, R, C) f32 evidence block and reduced into per-family rows by one of
the ssc methods (``SSC_METHODS``): ``segment_gemm`` (the default: the
hand-written kernel of ``kernels/segment_gemm.py`` on CUDA, its plain
version on the CPU), ``matmul`` (the dense one-hot product),
``segment`` (the plain version on any device), and the two
family-sorted methods ``blockseg`` (block-local one-hot products) and
``runsum`` (prefix sums). Numerics mirror the JAX package's
kernels/consensus.py in f32:

  loglik[b] = sum_i [ base_i==b ? log1p(-e_i) : log(e_i/3) ]
  err       = (sum of non-max exp) / (1 + sum of non-max exp)
  qual      = floor(-10*log10(err) + 1e-9) clipped to [2, max_qual]

pow/log1p/log/log10 differ by ULPs between devices and libraries, so a
qual may move by one at a floor boundary against the JAX package; the
integer outputs do not move.
"""

from __future__ import annotations

import torch

from duplexumiconsensusreads_torch.constants import (
    BASE_N,
    MIN_ERROR_PROB,
    N_REAL_BASES,
    NO_CALL_QUAL,
)
from duplexumiconsensusreads_torch.kernels.segment_gemm import (
    segment_gemm,
    segment_gemm_plain,
)

# the port's reduction methods (ops/pipeline.SSC_METHOD_COSTS holds a
# cost function for each): the kernel, the dense one-hot product, the
# plain ascending-row reduction on any device, and the two methods that
# reduce family-sorted rows
SSC_METHODS = ("segment_gemm", "matmul", "segment", "blockseg", "runsum")
_SORTED_METHODS = ("blockseg", "runsum")

# blockseg tile height default: sorted rows per block-local one-hot
# product (PipelineSpec.blockseg_t / ssc_kernel(blockseg_t=...));
# tools/tune_ssc.py sweeps it
BLOCKSEG_T = 128


def _phred_from_err(err: torch.Tensor, max_qual: int) -> torch.Tensor:
    err = torch.clamp(err, min=MIN_ERROR_PROB)
    q = torch.floor(-10.0 * torch.log10(err) + 1e-9)
    return torch.clamp(q, 2, max_qual).to(torch.int32)


def _contributions(bases, quals, valid, max_input_qual, min_input_qual=0):
    """Per-read per-cycle evidence rows, zeroed for N/PAD/invalid and
    for bases below min_input_qual. bases/quals (..., R, L) u8, valid
    (..., R) bool. Returns (contrib (..., R, L, 4) f32, real (..., R, L)
    f32)."""
    real = (bases < N_REAL_BASES) & valid[..., None]
    if min_input_qual > 0:
        real = real & (quals >= min_input_qual)
    q = torch.clamp(quals.to(torch.float32), max=float(max_input_qual))
    e = torch.pow(10.0, -q / 10.0)
    e = torch.clamp(e, min=MIN_ERROR_PROB)
    log_match = torch.log1p(-e)
    log_mis = torch.log(e / 3.0)
    onehot = bases[..., None] == torch.arange(
        N_REAL_BASES, dtype=bases.dtype, device=bases.device
    )
    # log_mis + onehot * (log_match - log_mis) as XLA evaluates it (the
    # multiply by a 0/1 mask becomes a select): a qual-0 cycle (N/PAD)
    # has log_match = -inf, and 0 * -inf would put NaN into its row
    zero = torch.zeros((), dtype=torch.float32, device=bases.device)
    contrib = log_mis[..., None] + torch.where(onehot, (log_match - log_mis)[..., None], zero)
    contrib = contrib * real[..., None].to(torch.float32)
    return contrib, real.to(torch.float32)


def _evidence_columns(
    bases, quals, ok, max_input_qual, min_input_qual, want_err, want_depth=True,
):
    """(N, R, C) evidence block: loglik contributions (4L)[, depth
    indicators (L)], read-count (1)[, real-masked base counts (4L) for
    the err reduction]."""
    n, r, l = bases.shape
    contrib, real = _contributions(bases, quals, ok, max_input_qual, min_input_qual)
    cols = [contrib.reshape(n, r, 4 * l)]
    if want_depth:
        cols.append(real)
    cols.append(ok.to(torch.float32)[..., None])
    if want_err:
        oh = (
            (bases[..., None] == torch.arange(N_REAL_BASES, dtype=bases.dtype, device=bases.device))
            & (real > 0)[..., None]
        ).to(torch.float32)
        cols.append(oh.reshape(n, r, 4 * l))
    return torch.cat(cols, dim=-1)


def _reduce_runsum(big: torch.Tensor, sfid: torch.Tensor, f_max: int) -> torch.Tensor:
    """Family sums of id-sorted rows as differences of prefix sums: one
    cumsum over the rows and a boundary gather per family. Each family
    sum is the difference of two large prefixes, so f32 cancellation
    moves quals at floor boundaries (the reason the method is not a
    default)."""
    n, _, c = big.shape
    z = torch.cat(
        [torch.zeros(n, 1, c, dtype=torch.float32, device=big.device), torch.cumsum(big, dim=1)],
        dim=1,
    )
    ids = torch.arange(f_max + 1, dtype=sfid.dtype, device=sfid.device).expand(n, -1)
    starts = torch.searchsorted(sfid, ids.contiguous(), side="left")
    return (
        torch.take_along_dim(z, starts[:, 1:, None], dim=1)
        - torch.take_along_dim(z, starts[:, :-1, None], dim=1)
    )


def _reduce_blockseg(
    big: torch.Tensor, sfid: torch.Tensor, f_max: int, blockseg_t: int
) -> torch.Tensor:
    """Family sums of id-sorted rows by block-local one-hot products.

    Within each block of T sorted rows, ``local`` is a row's RANK among
    the block's distinct ids (a cumsum of change flags), which fits in
    [0, T) however sparse the id values are (the strided duplex ids
    leave gaps). A (T, T) one-hot product reduces each block exactly;
    the block partials are then added into their family rows block by
    block, in block order: each family row receives at most one partial
    per block, so every output element is a fixed sequence of f32 adds
    and the result does not depend on the order of atomic adds (a
    family longer than T spans three or more blocks). Unused rank slots
    and the overflow id f_max land in a sentinel row that is sliced
    off. 2*R*T*C FLOPs against the dense product's 2*R*F*C."""
    n, r, c = big.shape
    dev = big.device
    t = min(blockseg_t, r)
    nb = -(-r // t)
    pad = nb * t - r
    if pad:
        big = torch.cat([big, torch.zeros(n, pad, c, dtype=torch.float32, device=dev)], dim=1)
        sfid = torch.cat(
            [sfid, torch.full((n, pad), f_max, dtype=sfid.dtype, device=dev)], dim=1
        )
    sfid2 = sfid.reshape(n, nb, t).long()
    chg = torch.zeros(n, nb, t, dtype=torch.int64, device=dev)
    chg[..., 1:] = (sfid2[..., 1:] != sfid2[..., :-1]).long()
    local = torch.cumsum(chg, dim=-1)  # (n, nb, t) ranks in [0, t)
    onehot = (local[..., None] == torch.arange(t, device=dev)).to(torch.float32)
    # (n, nb, rank, C): partial sum of each rank's rows in each block
    partials = torch.matmul(onehot.transpose(-1, -2), big.reshape(n, nb, t, c))
    del onehot
    # the id occupying each rank slot (unused slots keep f_max); rows of
    # one rank all carry the same id, so the duplicate writes agree
    dest = torch.full((n, nb, t), f_max, dtype=torch.int64, device=dev)
    dest.scatter_(-1, local, sfid2)
    dest = dest + torch.arange(n, device=dev)[:, None, None] * (f_max + 1)
    out = torch.zeros(n * (f_max + 1), c, dtype=torch.float32, device=dev)
    for k in range(nb):
        # distinct destinations within one block (ranks are distinct
        # ids), bar the sentinel rows
        out.index_add_(0, dest[:, k].reshape(-1), partials[:, k].reshape(-1, c))
    return out.reshape(n, f_max + 1, c)[:, :f_max]


def _reduce(big: torch.Tensor, fid: torch.Tensor, f_max: int, method: str,
            blockseg_t: int = BLOCKSEG_T) -> torch.Tensor:
    """(N, R, C) rows -> (N, f_max, C) family sums; fid == f_max is the
    overflow id and contributes nowhere. ``blockseg``/``runsum`` want
    rows sorted by id (ssc_kernel sorts them)."""
    if method == "runsum":
        return _reduce_runsum(big, fid, f_max)
    if method == "blockseg":
        return _reduce_blockseg(big, fid, f_max, blockseg_t)
    if method == "segment_gemm":
        return segment_gemm(big, fid, f_max)
    if method == "segment":
        return segment_gemm_plain(big, fid, f_max)
    if method == "matmul":
        onehot = (
            fid[..., None] == torch.arange(f_max, dtype=torch.int32, device=fid.device)
        ).to(torch.float32)
        return torch.bmm(onehot.transpose(1, 2), big)
    raise ValueError(f"unknown ssc method {method!r} (ported: {SSC_METHODS})")


def ssc_kernel(
    bases: torch.Tensor,  # (N, R, L) u8
    quals: torch.Tensor,  # (N, R, L) u8
    family_id: torch.Tensor,  # (N, R) i32, NO_FAMILY for unassigned
    valid: torch.Tensor,  # (N, R) bool
    *,
    f_max: int,
    min_reads: int = 1,
    max_qual: int = 90,
    max_input_qual: int = 50,
    min_input_qual: int = 0,
    method: str = "segment_gemm",
    want_err: bool = False,
    columns: str = "full",
    blockseg_t: int = BLOCKSEG_T,
):
    """Single-strand consensus for all families of all buckets.

    Returns (cons_base (N, F, L) i32, cons_qual (N, F, L) i32,
             depth (N, F, L) i32, fam_size (N, F) i32, fam_valid (N, F)
             bool[, err (N, F, L) i32 with want_err=True]).

    columns="fit" is the error-model pass-1 variant: no depth columns
    in the reduction; returns only (cons_base, fam_size, fam_valid),
    with cons_base the UNMASKED argmax (BASE_N where no read
    contributed: every contributing read's loglik terms are strictly
    negative and exact per-family f32 sums of negatives never reach
    zero, so max(loglik) < 0 iff the family has evidence at that cycle).
    The caller applies fam_valid itself. Exception: method="runsum"
    keeps its depth columns in fit mode — its prefix differences can
    cancel a tiny loglik to exact 0.0, so the sign test is unsound
    there, and the (exact, integer) depth > 0 test is used instead.

    ``blockseg``/``runsum`` first sort the rows of each bucket by id (a
    stable argsort; the u8 inputs are permuted, so the f32 evidence is
    built directly in id order); ``blockseg_t`` is blockseg's tile
    height.
    """
    n, r, l = bases.shape
    if columns not in ("full", "fit"):
        raise ValueError(f"unknown ssc columns mode {columns!r} (ported: full, fit)")
    if method not in SSC_METHODS:
        raise ValueError(f"unknown ssc method {method!r} (ported: {SSC_METHODS})")
    fit_mode = columns == "fit"
    if fit_mode and want_err:
        raise ValueError("columns='fit' is incompatible with want_err")
    want_depth = (not fit_mode) or method == "runsum"
    ok = valid & (family_id >= 0)
    fid = torch.where(ok, family_id, torch.full_like(family_id, f_max))
    if method in _SORTED_METHODS:
        perm = torch.argsort(fid, dim=1, stable=True)
        fid = torch.take_along_dim(fid, perm, dim=1)
        ok = torch.take_along_dim(ok, perm, dim=1)
        bases = torch.take_along_dim(bases, perm[..., None], dim=1)
        quals = torch.take_along_dim(quals, perm[..., None], dim=1)

    big = _evidence_columns(
        bases, quals, ok, max_input_qual, min_input_qual, want_err, want_depth
    )
    out = _reduce(big.contiguous(), fid.contiguous(), f_max, method, blockseg_t=blockseg_t)
    del big

    loglik = out[..., : 4 * l].reshape(n, f_max, l, 4)
    if fit_mode:
        if want_depth:  # runsum: exact integer depth, a sound mask
            fam_size = out[..., 5 * l].to(torch.int32)
            has_evidence = out[..., 4 * l : 5 * l] > 0
        else:
            fam_size = out[..., 4 * l].to(torch.int32)
            has_evidence = loglik.amax(dim=-1) < 0
        cons_base = torch.where(
            has_evidence, loglik.argmax(dim=-1), torch.full_like(has_evidence, BASE_N, dtype=torch.int64)
        ).to(torch.int32)
        return cons_base, fam_size, fam_size >= min_reads
    depth = out[..., 4 * l : 5 * l].to(torch.int32)
    fam_size = out[..., 5 * l].to(torch.int32)

    # err = 1 - p_max from the NON-argmax exponentials only (with the max
    # term included the f32 sum rounds to 1.0 for deep families)
    maxll = loglik.amax(dim=-1, keepdim=True)
    base = loglik.argmax(dim=-1).to(torch.int32)  # ties: first maximum
    not_max = torch.arange(4, dtype=torch.int32, device=base.device) != base[..., None]
    s = (torch.exp(loglik - maxll) * not_max.to(torch.float32)).sum(dim=-1)
    err = s / (1.0 + s)
    qual = _phred_from_err(err, max_qual)

    called = depth > 0
    fam_valid = fam_size >= min_reads
    keep = called & fam_valid[..., None]
    cons_base = torch.where(keep, base, BASE_N)
    cons_qual = torch.where(keep, qual, NO_CALL_QUAL)
    depth = torch.where(fam_valid[..., None], depth, 0)
    if not want_err:
        return cons_base, cons_qual, depth, fam_size, fam_valid
    counts = out[..., 5 * l + 1 : 9 * l + 1].reshape(n, f_max, l, 4).to(torch.int32)
    match = torch.gather(counts, -1, base[..., None].long())[..., 0]
    err_n = torch.where(keep, depth - match, 0)
    return cons_base, cons_qual, depth, fam_size, fam_valid, err_n


def _merge_calls(b_ab, q_ab, b_ba, q_ba, max_qual):
    """Per-cycle duplex call from the two strands' consensus: agreeing
    bases add their quals (capped), a disagreement with unequal quals
    keeps the higher-qual base at qual |qa - qb| (>= 2), else N."""
    both_real = (b_ab < N_REAL_BASES) & (b_ba < N_REAL_BASES)
    agree = both_real & (b_ab == b_ba)
    disagree = both_real & (b_ab != b_ba) & (q_ab != q_ba)
    dx_base = torch.where(
        agree, b_ab, torch.where(disagree, torch.where(q_ab > q_ba, b_ab, b_ba), BASE_N)
    )
    dx_qual = torch.where(
        agree,
        torch.clamp(q_ab + q_ba, max=max_qual),
        torch.where(disagree, torch.clamp((q_ab - q_ba).abs(), min=NO_CALL_QUAL), NO_CALL_QUAL),
    )
    return dx_base, dx_qual


def duplex_kernel(
    cons_base: torch.Tensor,  # (N, F, L) i32 single-strand consensus bases
    cons_qual: torch.Tensor,  # (N, F, L) i32
    depth: torch.Tensor,  # (N, F, L) i32
    fam_valid: torch.Tensor,  # (N, F) bool
    family_id: torch.Tensor,  # (N, R) i32
    molecule_id: torch.Tensor,  # (N, R) i32
    strand_ab: torch.Tensor,  # (N, R) bool
    valid: torch.Tensor,  # (N, R) bool
    ss_err: torch.Tensor | None = None,  # (N, F, L) i32, required iff want_err
    *,
    m_max: int,
    min_duplex_reads: int = 1,
    max_qual: int = 90,
    want_err: bool = False,
):
    """Duplex merge of AB/BA single-strand consensi per molecule when
    the ssc rows are dense family ids (the pipeline's fallback when
    2*m_max != f_max): per-strand family and size tables by segment
    min/sum, then row gathers. Returns (dx_base, dx_qual, dx_depth
    (N, M, L) i32, dx_valid (N, M) bool[, dx_err (N, M, L) i32])."""
    if want_err and ss_err is None:
        raise ValueError("duplex_kernel: ss_err is required when want_err=True")
    n = family_id.shape[0]
    dev = family_id.device
    imax = 2**31 - 1
    ok = valid & (molecule_id >= 0) & (family_id >= 0)
    mid = torch.where(ok, molecule_id, m_max).long()

    def strand_tables(is_ab: bool):
        sel = ok & (strand_ab == is_ab)
        seg = torch.where(sel, mid, m_max)
        fam = torch.full((n, m_max + 1), imax, dtype=torch.int32, device=dev)
        fam.scatter_reduce_(
            1, seg, torch.where(sel, family_id, imax), "amin", include_self=True
        )
        size = torch.zeros(n, m_max + 1, dtype=torch.int32, device=dev)
        size.scatter_add_(1, mid, sel.to(torch.int32))
        return fam[:, :m_max], size[:, :m_max]

    fam_ab, size_ab = strand_tables(True)
    fam_ba, size_ba = strand_tables(False)
    have = (fam_ab < imax) & (fam_ba < imax)
    fa = torch.where(have, fam_ab, 0).long()
    fb = torch.where(have, fam_ba, 0).long()
    l = cons_base.shape[2]

    def rows(t, f):
        return torch.gather(t, 1, f[..., None].expand(-1, -1, l))

    dx_base, dx_qual = _merge_calls(
        rows(cons_base, fa), rows(cons_qual, fa), rows(cons_base, fb), rows(cons_qual, fb),
        max_qual,
    )
    dx_depth = rows(depth, fa) + rows(depth, fb)
    dx_valid = (
        have
        & (fa != fb)  # unpaired grouping: AB == BA would self-merge a family
        & (size_ab >= min_duplex_reads)
        & (size_ba >= min_duplex_reads)
        & torch.gather(fam_valid, 1, fa)
        & torch.gather(fam_valid, 1, fb)
    )
    vv = dx_valid[..., None]
    dx_base = torch.where(vv, dx_base, BASE_N)
    dx_qual = torch.where(vv, dx_qual, NO_CALL_QUAL)
    dx_depth = torch.where(vv, dx_depth, 0)
    if not want_err:
        return dx_base, dx_qual, dx_depth, dx_valid
    dx_err = torch.where(vv, rows(ss_err, fa) + rows(ss_err, fb), 0)
    return dx_base, dx_qual, dx_depth, dx_valid, dx_err


def duplex_merge_strided(
    cons_base: torch.Tensor,  # (N, 2M, L) i32, row 2m = AB strand of unit m, 2m+1 = BA
    cons_qual: torch.Tensor,  # (N, 2M, L) i32
    depth: torch.Tensor,  # (N, 2M, L) i32
    fam_size: torch.Tensor,  # (N, 2M) i32
    fam_valid: torch.Tensor,  # (N, 2M) bool
    ss_err: torch.Tensor | None = None,  # (N, 2M, L) i32, required iff want_err
    *,
    m_max: int,
    min_duplex_reads: int = 1,
    max_qual: int = 90,
    want_err: bool = False,
):
    """Duplex merge of rows keyed by the strided id molecule*2 +
    strand_ba: unit m's strands are rows 2m and 2m+1, so the merge is
    reshape-slicing. A unit missing a strand has an all-zero row
    (fam_size 0) and fails the presence check."""
    if want_err and ss_err is None:
        raise ValueError("duplex_merge_strided: ss_err required when want_err=True")
    n, _, l = cons_base.shape
    b2 = cons_base.reshape(n, m_max, 2, l)
    q2 = cons_qual.reshape(n, m_max, 2, l)
    d2 = depth.reshape(n, m_max, 2, l)
    s2 = fam_size.reshape(n, m_max, 2)
    v2 = fam_valid.reshape(n, m_max, 2)
    dx_base, dx_qual = _merge_calls(b2[:, :, 0], q2[:, :, 0], b2[:, :, 1], q2[:, :, 1], max_qual)
    dx_depth = d2[:, :, 0] + d2[:, :, 1]
    dx_valid = (
        (s2[..., 0] > 0)
        & (s2[..., 1] > 0)
        & (s2[..., 0] >= min_duplex_reads)
        & (s2[..., 1] >= min_duplex_reads)
        & v2[..., 0]
        & v2[..., 1]
    )
    vv = dx_valid[..., None]
    dx_base = torch.where(vv, dx_base, BASE_N)
    dx_qual = torch.where(vv, dx_qual, NO_CALL_QUAL)
    dx_depth = torch.where(vv, dx_depth, 0)
    if not want_err:
        return dx_base, dx_qual, dx_depth, dx_valid
    e2 = ss_err.reshape(n, m_max, 2, l)
    dx_err = torch.where(vv, e2[:, :, 0] + e2[:, :, 1], 0)
    return dx_base, dx_qual, dx_depth, dx_valid, dx_err
