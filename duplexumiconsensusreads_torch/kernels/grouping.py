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
   proof).
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
from duplexumiconsensusreads_torch.kernels.encoding import pack_umi_words

I32_MAX = 2**31 - 1


def _pairwise_less_eq(primary_less, primary_eq, words):
    """Lexicographic pairwise compare on an (N, U, U) grid: extends the
    primary key's less/eq masks with the word columns of ``words``
    (N, U, W). Orientation: out_less[n, i, j] == key_j < key_i (so a
    row-sum over valid j is key_i's rank)."""
    less, eq = primary_less, primary_eq
    for k in range(words.shape[-1]):
        a = words[..., k]
        aj, ai = a[:, None, :], a[:, :, None]
        less = less | (eq & (aj < ai))
        eq = eq & (aj == ai)
    return less, eq


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


def _directional_cluster(u_words, u_codes, u_pos, u_cnt, u_valid, max_hamming, count_ratio):
    """Seed slot index per unique-UMI slot: (N, U) i32."""
    n, u, b = u_codes.shape
    if (u + 1) * u >= 2**31:
        raise ValueError(f"u_max {u} overflows the i32 combined seed key")
    dev = u_codes.device
    # Hamming distance via a one-hot product. The entries are 0/1, so
    # the f32 product is exact (integer sums far below 2^24) — and stays
    # exact under TF32 too, which rounds inputs but represents 0 and 1.
    onehot = (
        u_codes[..., None] == torch.arange(4, dtype=u_codes.dtype, device=dev)
    ).to(torch.float32).reshape(n, u, 4 * b)
    matches = torch.bmm(onehot, onehot.transpose(1, 2))
    ham = b - matches.to(torch.int32)
    eye = torch.eye(u, dtype=torch.bool, device=dev)
    edge = (
        (ham <= max_hamming)
        & (u_pos[:, :, None] == u_pos[:, None, :])
        & (u_cnt[:, :, None] >= count_ratio * u_cnt[:, None, :] - 1)
        & u_valid[:, :, None]
        & u_valid[:, None, :]
        & ~eye
    )
    del matches, ham

    # rank by (-count, packed UMI words): pairwise compare-count
    cj, ci = u_cnt[:, None, :], u_cnt[:, :, None]
    less, _ = _pairwise_less_eq(cj > ci, cj == ci, u_words)
    rank = (less & u_valid[:, None, :]).sum(dim=2, dtype=torch.int32)
    del less
    idx = torch.arange(u, dtype=torch.int32, device=dev)
    s = torch.where(u_valid, rank, torch.full_like(rank, u)) * u + idx

    # min-ancestor propagation: one sweep reaches one more hop; stop when
    # NO bucket changed (the batched form of the per-bucket while loop —
    # extra sweeps past a bucket's fixpoint are idempotent). Host sync
    # once per sweep.
    big = torch.full((), I32_MAX, dtype=torch.int32, device=dev)
    for _ in range(u):
        cand = torch.where(edge, s[:, :, None], big).amin(dim=1)
        new = torch.minimum(s, cand)
        if not bool((new != s).any()):
            break
        s = new
    return s % u


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
        umi_codes = torch.gather(umi_codes, 1, order[..., None].expand(-1, -1, umi_codes.shape[-1]))
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
    u_valid = u_pos != I32_MAX
    in_table = uid < u_max
    ok_sorted = svalid & in_table

    if strategy == "exact":
        mid_of_slot = torch.arange(u_max, dtype=torch.int32, device=dev).expand(n, u_max)
        n_mol = u_valid.sum(dim=1, dtype=torch.int32)
    else:
        codes = umi_codes.to(torch.int32)
        u_codes = _scatter_set(n, u_max, (codes.shape[-1],), 0, torch.int32, tslot, codes)
        cnt_slot = torch.clamp(uid, max=u_max).long()
        u_cnt = torch.zeros(n, u_max + 1, dtype=torch.int32, device=dev)
        u_cnt.scatter_add_(1, cnt_slot, svalid.to(torch.int32))
        u_cnt = u_cnt[:, :u_max]
        seed = _directional_cluster(
            u_words, u_codes, u_pos, u_cnt, u_valid, max_hamming, count_ratio
        )
        seed_words = torch.gather(u_words, 1, seed.long()[..., None].expand(-1, -1, w))
        key_w = torch.where(u_valid[..., None], seed_words, imax)
        key_p = torch.where(u_valid, u_pos, imax)
        kless, keq = _pairwise_less_eq(
            key_p[:, None, :] < key_p[:, :, None],
            key_p[:, None, :] == key_p[:, :, None],
            key_w,
        )
        idx_u = torch.arange(u_max, device=dev)
        earlier = idx_u[None, :] < idx_u[:, None]
        firstk = ~(keq & earlier).any(dim=2)
        del keq
        fv = firstk & u_valid
        mid_raw_t = (kless & fv[:, None, :]).sum(dim=2, dtype=torch.int32)
        del kless
        n_mol = fv.sum(dim=1, dtype=torch.int32)
        mid_of_slot = torch.where(u_valid, mid_raw_t, imax)

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
