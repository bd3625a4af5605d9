"""UMI-family grouping kernel (exact, directional adjacency, cluster),
batched over the bucket axis.

Every tensor carries a leading bucket axis N: the JAX package vmaps its
per-bucket kernel (kernels/grouping.py there); here the batch axis is
written out. The algorithm is the same, step for step:

1. Reads arrive sorted by (pos, UMI words) with invalid reads at the
   tail (bucketing's contract, ``presorted=True``) or are sorted so
   first, so exact families are run boundaries in the key stream
   (cumsum).
2. A compact unique-(pos, UMI) table of ``u_max`` slots is filled in
   stream order, so the table itself is sorted by (pos, words).
3. Adjacency/cluster additionally, on the table only (u_max << R):
   all-pairs Hamming distances, the directed UMI-tools edge grid,
   compare-count ranks by (-count, words), and propagation of the
   minimum ancestor key ``rank * U + index`` to a fixpoint — each UMI
   joins the minimum-rank node that reaches it, which is the oracle's
   BFS-with-removal seed (see the JAX module's docstring for the
   proof). ``kernels/cluster_fixpoint.py:directional_cluster`` does this
   and step 4's molecule ids in one call: on CUDA one kernel launch
   that builds the edges, ranks and ids of each bucket in shared memory
   (no (N, U, U) tensor), on the CPU the plain version over the grids.
4. Dense ids come from the table: molecule id = rank of the slot's
   cluster key (pos, seed words); family/unit ids = presence-cumsum
   ranks over the (molecule, frag_end, strand) embeddings.

JAX's drop-mode scatters and clamping gathers never fault; torch's
raise. Every scatter below therefore writes into one extra sentinel
slot that is sliced off, and every gather index is clamped first.
"""

from __future__ import annotations

import torch

from duplexumiconsensusreads_torch.constants import NO_FAMILY
from duplexumiconsensusreads_torch.kernels.cluster_fixpoint import directional_cluster
from duplexumiconsensusreads_torch.kernels.encoding import pack_umi_words
from duplexumiconsensusreads_torch.telemetry import steps

I32_MAX = 2**31 - 1


def _run_ids(keys: list[torch.Tensor]) -> torch.Tensor:
    """Dense ids for runs of equal sorted keys: (N, R) i32 via cumsum."""
    n, r = keys[0].shape
    new = torch.zeros(n, r, dtype=torch.bool, device=keys[0].device)
    new[:, 0] = True
    for k in keys:
        new[:, 1:] |= k[:, 1:] != k[:, :-1]
    return new.to(torch.int32).cumsum(dim=1, dtype=torch.int32) - 1


def _scatter_set(n: int, slots: int, tail: tuple, fill, dtype, index, src):
    """Out-of-range-safe ``full(fill).at[index].set(src)`` over the slot
    axis: ``index`` (N, R) in [0, slots]; slot ``slots`` is the drop
    sentinel and is sliced off."""
    out = torch.full((n, slots + 1, *tail), fill, dtype=dtype, device=src.device)
    idx = index.long()
    if tail:
        idx = idx.reshape(*idx.shape, *([1] * len(tail))).expand(*idx.shape, *tail)
    out.scatter_(1, idx, src.to(dtype))
    return out[:, :slots]


def group_kernel(
    pos: torch.Tensor,  # (N, R) i32 bucket-local dense position key
    umi_codes: torch.Tensor,  # (N, R, B) u8 codes in {0..3}
    strand_ab: torch.Tensor,  # (N, R) bool
    frag_end: torch.Tensor,  # (N, R) bool
    valid: torch.Tensor,  # (N, R) bool
    *,
    strategy: str = "exact",
    max_hamming: int = 1,
    count_ratio: int = 2,
    paired: bool = False,
    mate_aware: bool = False,
    u_max: int | None = None,
    presorted: bool = False,
):
    """Returns (family_id, molecule_id, pair_id, n_families, n_molecules,
    n_overflow): (N, R) i32 ids in the input read order with NO_FAMILY
    on invalid or overflowed reads, and (N,) i32 counts — per bucket,
    bit-identical to the JAX package's group_kernel.

    ``presorted=True`` asserts bucketing's output contract (valid reads
    ascending by (pos, UMI words), invalid reads only at the tail) and
    skips the sort. Otherwise each bucket's reads are ordered as JAX's
    ``lexsort`` orders them — torch has none, so by stable sorts from
    the last key to the first — the ids are computed on that order and
    scattered back through it."""
    if strategy not in ("exact", "adjacency", "cluster"):
        raise ValueError(f"unknown grouping strategy {strategy!r}")
    steps.mark("group")
    if strategy == "cluster":
        # UMI-tools cluster == adjacency with the count condition removed
        count_ratio = 0
    n, r = pos.shape
    dev = pos.device
    if u_max is None:
        u_max = r
    words = pack_umi_words(umi_codes)  # (N, R, W)
    w = words.shape[-1]
    imax = torch.full((), I32_MAX, dtype=torch.int32, device=dev)
    spos = torch.where(valid, pos.to(torch.int32), imax)
    swords = torch.where(valid[..., None], words, imax)
    svalid = valid
    order = None
    if not presorted:
        # lexsort by (pos, word 0, .., word W-1): stable sorts by the
        # least significant key first; invalid reads carry I32_MAX keys
        # and keep their input order at the tail
        order = torch.arange(r, device=dev).expand(n, r)
        for key in [swords[..., i] for i in range(w - 1, -1, -1)] + [spos]:
            idx = torch.sort(torch.gather(key, 1, order), dim=1, stable=True).indices
            order = torch.gather(order, 1, idx)
        spos = torch.gather(spos, 1, order)
        swords = torch.gather(swords, 1, order[..., None].expand(-1, -1, w))
        svalid = torch.gather(valid, 1, order)
        strand_ab = torch.gather(strand_ab, 1, order)
        frag_end = torch.gather(frag_end, 1, order)

    uid_raw = _run_ids([spos] + [swords[..., i] for i in range(w)])
    uid = torch.where(svalid, uid_raw, torch.full_like(uid_raw, u_max))
    first = torch.ones_like(svalid)
    first[:, 1:] = uid_raw[:, 1:] != uid_raw[:, :-1]
    first &= svalid
    tslot = torch.where(first, torch.clamp(uid, max=u_max), torch.full_like(uid, u_max))
    u_words = _scatter_set(n, u_max, (w,), I32_MAX, torch.int32, tslot, swords)
    u_pos = _scatter_set(n, u_max, (), I32_MAX, torch.int32, tslot, spos)
    in_table = uid < u_max
    ok_sorted = svalid & in_table

    if strategy == "exact":
        mid_of_slot = torch.arange(u_max, dtype=torch.int32, device=dev).expand(n, u_max)
        n_mol = (u_pos != I32_MAX).sum(dim=1, dtype=torch.int32)
    else:
        cnt_slot = torch.clamp(uid, max=u_max).long()
        u_cnt = torch.zeros(n, u_max + 1, dtype=torch.int32, device=dev)
        u_cnt.scatter_add_(1, cnt_slot, svalid.to(torch.int32))
        u_cnt = u_cnt[:, :u_max]
        steps.mark("cluster")
        _seed, mid_of_slot, n_mol = directional_cluster(
            u_words, u_pos, u_cnt, umi_codes.shape[-1], max_hamming, count_ratio
        )
        steps.mark("group")

    slot_c = torch.clamp(uid, max=u_max - 1).long()
    mid_raw = torch.gather(mid_of_slot, 1, slot_c)
    nofam = torch.full((), NO_FAMILY, dtype=torch.int32, device=dev)
    mid_sorted = torch.where(ok_sorted, mid_raw, nofam)

    def dense_rank(key_raw, k):
        """Dense ids over present (molecule*k + bits) keys via a
        presence scatter + cumsum (sentinel slot k*u_max)."""
        emb = torch.where(ok_sorted, key_raw, torch.full_like(key_raw, k * u_max))
        pres = torch.zeros(n, k * u_max + 1, dtype=torch.int32, device=dev)
        pres.scatter_(1, emb.long(), 1)
        pres = pres[:, : k * u_max]
        rank = pres.cumsum(dim=1, dtype=torch.int32) - 1
        got = torch.gather(rank, 1, torch.clamp(emb, max=k * u_max - 1).long())
        ids = torch.where(ok_sorted, got, nofam)
        return ids, pres.sum(dim=1, dtype=torch.int32)

    sba = (~strand_ab).to(torch.int32)
    e2 = frag_end.to(torch.int32)

    # family key = (molecule[, frag_end][, strand_ba]); the embedding is
    # monotone in the oracle's sorted key
    if mate_aware and paired:
        fid_sorted, n_fam = dense_rank(mid_raw * 4 + e2 * 2 + sba, 4)
    elif mate_aware:
        fid_sorted, n_fam = dense_rank(mid_raw * 2 + e2, 2)
    elif paired:
        fid_sorted, n_fam = dense_rank(mid_raw * 2 + sba, 2)
    else:
        fid_sorted, n_fam = mid_sorted, n_mol

    if mate_aware and paired:
        mid_out, n_mol_out = dense_rank(mid_raw * 2 + e2, 2)
    else:
        mid_out, n_mol_out = mid_sorted, n_mol

    n_overflow = (svalid & ~ok_sorted).sum(dim=1, dtype=torch.int32)
    if order is not None:
        # back to the input order: out[order[i]] = sorted[i]
        fid_sorted, mid_out, mid_sorted = (
            torch.empty_like(a).scatter_(1, order, a) for a in (fid_sorted, mid_out, mid_sorted)
        )
    return fid_sorted, mid_out, mid_sorted, n_fam, n_mol_out, n_overflow
