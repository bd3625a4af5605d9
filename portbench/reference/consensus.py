"""Consensus calling, plainly, in PyTorch: the expected output records
of a set of buckets.

The model (fgbio-style, as the port computes it in float32):

- A read's base at a cycle with quality q (capped at ``max_input_qual``)
  and error e = 10^(-q/10) adds log(1 - e) to its base's log-likelihood
  and log(e/3) to each other base's. A family's log-likelihoods are the
  sums over its reads.
- The consensus base is the first maximum. Its error is s / (1 + s),
  with s the sum of exp(ll_b - ll_max) over the other bases, and its
  quality floor(-10 log10(error) + 1e-9), clipped to [2, max_qual].
  A cycle no read covers, or a family smaller than ``min_reads``, calls
  N at quality 2.
- Error model "cycle" (per bucket): a first call with the raw
  qualities; at each cycle, over the reads of valid families whose base
  and family consensus are both real, mismatches m and total t give the
  cap floor(-10 log10((m + 1) / (t + 2))), clipped to [2, 60] (counted
  with float32 threshold comparisons); every quality is clipped at its
  cycle's cap and the families are called again.
- Duplex: a molecule's top (AB) and bottom (BA) families, both present
  with at least ``min_duplex_reads`` reads and both valid, merge per
  cycle: agreeing bases add their qualities (capped at ``max_qual``),
  disagreeing ones with unequal qualities keep the better base at the
  difference (at least 2), anything else is N at 2. Depth adds.
- One record per emitted unit (duplex: molecule; single strand:
  family): its position, its modal UMI (the most frequent among its
  reads, ties to the smaller codes), bases, qualities, the largest
  depth (cD) and the smallest positive one (cM).

``dtype`` is the precision of the likelihood arithmetic: float32 as
the configuration states, or a lower one for the control. A family's
sums add its reads one at a time in file order, as the program's
kernel adds its rows, and the per-quality terms are worked out on the
device the check runs on, so that a quality that sits on a Phred
boundary (a one-read family's error is its read's, exactly on the
boundary) rounds as the program's does on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.grouping import group_bucket
from portbench.reference.partition import umi_words

BASE_N = 4
NO_CALL_QUAL = 2
MAX_CAP = 60


def phred_cap(mism: np.ndarray, total: np.ndarray) -> np.ndarray:
    thr = (10.0 ** (-np.arange(MAX_CAP + 1) / 10.0)).astype(np.float32)
    m = (mism + 1).astype(np.float32)
    t = (total + 2).astype(np.float32)
    count = (m[..., None] <= t[..., None] * thr).sum(axis=-1)
    return np.clip(count - 1, 2, MAX_CAP)


def _qual_tables(max_input_qual: int, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(log(1 - e), log(e/3)) of each u8 quality, worked out in float32 on
    ``device`` (where the program works them out) and then cast."""
    q = torch.clamp(torch.arange(256, dtype=torch.float32, device=device),
                    max=float(max_input_qual))
    e = torch.clamp(torch.pow(10.0, -q / 10.0), min=1e-10)
    return torch.log1p(-e).to(dtype), torch.log(e / 3.0).to(dtype)


def _family_sums(x_of, fam: np.ndarray, n_fam: int, shape: tuple, dtype, device):
    """Per family, the sum of ``x_of(rows)`` over its reads, added one
    read at a time in the reads' order into an accumulator that starts
    at zero."""
    order = np.argsort(fam, kind="stable")
    f = fam[order]
    start = np.searchsorted(f, np.arange(n_fam))
    rank = np.arange(len(f)) - start[f]
    acc = torch.zeros((n_fam, *shape), dtype=dtype, device=device)
    for k in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = rank == k
        acc[torch.as_tensor(f[sel], device=device)] += x_of(order[sel])
    return acc


def _call(bases, quals, fam, n_fam, cons: dict, dtype, device):
    """Per family (F, L): base, qual, depth; and family sizes (F,)."""
    lm, lx = _qual_tables(int(cons["max_input_qual"]), dtype, device)
    l = bases.shape[1]
    zero = torch.zeros((), dtype=dtype, device=device)

    def real_of(rows):
        b = torch.as_tensor(bases[rows], device=device)
        real = b < 4
        if int(cons["min_input_qual"]) > 0:
            real &= torch.as_tensor(quals[rows], device=device) >= int(cons["min_input_qual"])
        return b.long(), real

    def contrib_of(rows):
        b, real = real_of(rows)
        qi = torch.as_tensor(quals[rows], device=device).long()
        onehot = b[..., None] == torch.arange(4, device=device)
        c = lx[qi][..., None] + torch.where(onehot, (lm[qi] - lx[qi])[..., None], zero)
        return c * real[..., None].to(dtype)

    ll = _family_sums(contrib_of, fam, n_fam, (l, 4), dtype, device)
    depth = _family_sums(lambda r: real_of(r)[1].long(), fam, n_fam, (l,), torch.int64, device)
    size = np.bincount(fam, minlength=n_fam)
    maxll = ll.amax(dim=-1, keepdim=True)
    base = ll.argmax(dim=-1)
    not_max = torch.arange(4, device=device) != base[..., None]
    s = (torch.exp(ll - maxll) * not_max.to(dtype)).sum(dim=-1)
    err = torch.clamp(s / (1.0 + s), min=1e-10)
    qual = torch.clamp(torch.floor(-10.0 * torch.log10(err) + 1e-9), 2, int(cons["max_qual"]))
    return base.cpu().numpy(), qual.long().cpu().numpy(), depth.cpu().numpy(), size


def _modal_umi(unit: np.ndarray, umi: np.ndarray) -> np.ndarray:
    """Per unit id 0..U-1: the row of ``umi`` that is its modal UMI."""
    words = umi_words(umi)
    key = np.column_stack([unit, words])
    uniq, first, cnt = np.unique(key, axis=0, return_index=True, return_counts=True)
    order = np.lexsort((*[uniq[:, 1 + i] for i in range(words.shape[1] - 1, -1, -1)],
                        -cnt, uniq[:, 0]))
    take = order[np.r_[True, uniq[order[1:], 0] != uniq[order[:-1], 0]]]
    out = np.zeros(int(unit.max()) + 1, np.int64)
    out[uniq[take, 0]] = first[take]
    return out


def expected_records(reads, buckets: list[np.ndarray], grouping: dict, cons: dict,
                     dtype=torch.float32, device="cpu") -> dict:
    """{(position, UMI bytes): [(bases, quals, cD, cM), ...]} of every
    unit the buckets (arrays of read indices) emit; the likelihood
    arithmetic in ``dtype`` on ``device``."""
    idx = np.concatenate(buckets)
    bucket_of = np.repeat(np.arange(len(buckets)), [len(b) for b in buckets])
    pos, umi = reads.pos[idx], reads.umi[idx]
    strand = reads.strand_ab[idx]
    bases, quals = reads.bases[idx], reads.quals[idx]
    mol = np.empty(len(idx), np.int64)
    off = 0
    for k, b in enumerate(buckets):
        sl = slice(off, off + len(b))
        g = group_bucket(pos[sl], umi[sl], grouping)
        mol[sl] = g["molecule"] + off  # disjoint id blocks per bucket
        off += len(b)
    _, mol = np.unique(mol, return_inverse=True)
    mol = mol.reshape(-1)
    duplex = cons["mode"] == "duplex"
    fam = mol * 2 + (~strand) if grouping.get("paired") else mol
    n_fam = int(fam.max()) + 1
    if cons.get("error_model") == "cycle":
        cb0, _, depth0, size0 = _call(bases, quals, fam, n_fam, cons, dtype, device)
        cb0 = np.where(depth0 > 0, cb0, BASE_N)
        fvalid0 = size0 >= int(cons["min_reads"])
        cb = cb0[fam]
        ok = fvalid0[fam][:, None] & (bases < 4) & (cb < 4)
        mism = np.zeros((len(buckets), bases.shape[1]), np.int64)
        total = np.zeros_like(mism)
        np.add.at(mism, bucket_of, (ok & (bases != cb)).astype(np.int64))
        np.add.at(total, bucket_of, ok.astype(np.int64))
        cap = phred_cap(mism, total)
        quals = np.minimum(quals, cap[bucket_of]).astype(np.uint8)
    base, qual, depth, size = _call(bases, quals, fam, n_fam, cons, dtype, device)
    fvalid = size >= int(cons["min_reads"])
    keep = (depth > 0) & fvalid[:, None]
    base = np.where(keep, base, BASE_N)
    qual = np.where(keep, qual, NO_CALL_QUAL)
    depth = np.where(fvalid[:, None], depth, 0)
    if duplex:
        n_mol = int(mol.max()) + 1
        ab, ba = np.arange(n_mol) * 2, np.arange(n_mol) * 2 + 1
        pad = max(0, 2 * n_mol - n_fam)
        size = np.r_[size, np.zeros(pad, np.int64)]
        fvalid = np.r_[fvalid, np.zeros(pad, bool)]
        base = np.concatenate([base, np.full((pad, base.shape[1]), BASE_N)])
        qual = np.concatenate([qual, np.full((pad, qual.shape[1]), NO_CALL_QUAL)])
        depth = np.concatenate([depth, np.zeros((pad, depth.shape[1]), np.int64)])
        mdr = int(cons["min_duplex_reads"])
        valid = ((size[ab] > 0) & (size[ba] > 0) & (size[ab] >= mdr) & (size[ba] >= mdr)
                 & fvalid[ab] & fvalid[ba])
        ba_, bb_, qa, qb = base[ab], base[ba], qual[ab], qual[ba]
        real = (ba_ < 4) & (bb_ < 4)
        agree = real & (ba_ == bb_)
        disagree = real & (ba_ != bb_) & (qa != qb)
        out_base = np.where(agree, ba_, np.where(disagree, np.where(qa > qb, ba_, bb_), BASE_N))
        out_qual = np.where(agree, np.minimum(qa + qb, int(cons["max_qual"])),
                            np.where(disagree, np.maximum(np.abs(qa - qb), NO_CALL_QUAL),
                                     NO_CALL_QUAL))
        out_depth = depth[ab] + depth[ba]
        unit = mol
    else:
        valid, out_base, out_qual, out_depth = fvalid, base, qual, depth
        unit = fam
    rep = _modal_umi(unit, umi)
    out: dict = {}
    for u in np.nonzero(valid)[0]:
        d = out_depth[u]
        pos_d = d[d > 0]
        key = (int(pos[rep[u]]), umi[rep[u]].tobytes())
        out.setdefault(key, []).append((out_base[u].astype(np.uint8), out_qual[u].astype(np.uint8),
                                        int(d.max()), int(pos_d.min()) if len(pos_d) else 0))
    return out
