"""The fused device pipeline: grouping -> ssc -> error model -> duplex
merge, batched over the bucket axis of one dispatch class.

Every tensor carries a leading bucket axis N (the stacked buckets of a
class); the JAX package runs its per-bucket fused_pipeline under
``jax.vmap`` (parallel/sharded.py there) — here the batch axis is
written out, so each stage is one set of batched tensor operations and
each ssc pass is one launch of the segment_gemm kernel for the whole
class. ``PipelineSpec`` and ``spec_for_buckets`` size the static axes
exactly as the JAX package does, so the two compute the same function
on the same stacked bucket.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from duplexumiconsensusreads_torch.constants import BASE_N
from duplexumiconsensusreads_torch.kernels.consensus import (
    BLOCKSEG_T,
    SSC_METHODS,
    duplex_kernel,
    duplex_merge_strided,
    ssc_kernel,
)
from duplexumiconsensusreads_torch.kernels.encoding import unpack_bitplanes
from duplexumiconsensusreads_torch.kernels.error_model import (
    apply_cycle_cap,
    fit_cycle_cap_from_counts,
    fit_cycle_cap_kernel,
)
from duplexumiconsensusreads_torch.kernels.grouping import group_kernel
from duplexumiconsensusreads_torch.telemetry import steps
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams


# the error model's fit formulations (PipelineSpec.fit_impl)
FIT_IMPLS = ("gather", "counts")


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static geometry + algorithm config of one dispatch class.

    u_max/f_max/m_max default to the read capacity R (worst case: every
    read its own family) — spec_for_buckets() sizes them from the data.
    """

    grouping: GroupingParams = GroupingParams()
    consensus: ConsensusParams = ConsensusParams()
    u_max: int | None = None  # unique-UMI table slots
    f_max: int | None = None  # family-axis rows for the ssc reduction
    m_max: int | None = None  # molecule-axis rows for the duplex merge
    ssc_method: str = "segment_gemm"
    # blockseg tile height (sorted rows per block-local one-hot
    # product): only read when ssc_method == "blockseg"
    blockseg_t: int = BLOCKSEG_T
    # True asserts reads are sorted by (pos, UMI) with padding at the
    # tail — the bucketing layer's output contract
    presorted: bool = False
    # True: the byte-rung wire convention (pack_stacked below) — bases
    # carry base|qual in one byte per cycle, umi 2-bit codes four per
    # byte, pos u16, strand_ab a strand|frag_end|valid flag byte
    # (frag_end/quals/valid become zero-width dummies); decoded on device
    packed_io: bool = False
    # true UMI code count, required to un-pack the 2-bit umi bytes
    umi_len: int | None = None
    # the sub-byte H2D rung (qual-dictionary packing): with packed_io,
    # each cycle's code is base (2 bits) | index into qual_lut (qbits),
    # bit-plane packed to 2 + qbits bits per cycle; the all-ones index
    # marks a non-evidence cycle. Lossless at any qual value (the
    # dictionary carries quals verbatim). None = the byte rung.
    packed_qbits: int | None = None
    # the dictionary: sorted distinct real-cycle input quals
    qual_lut: tuple | None = None
    # true cycle count L, to slice the bit-plane decode
    cycles_len: int | None = None
    # True: also compute per-base disagreement counts (the ce tag)
    per_base_counts: bool = False
    # the error model's fit formulation: "gather" re-visits read space
    # with the consensus row-gather; "counts" tallies the mismatches
    # family-side from 4L extra columns of the fit pass's reduction (on
    # the card, segment_gemm at the wider width). Both exact and
    # bit-identical; "gather" is the default, as in the JAX package.
    fit_impl: str = "gather"

    def __post_init__(self):
        if self.consensus.mode == "duplex" and not self.grouping.paired:
            raise ValueError(
                "duplex consensus requires paired grouping "
                "(GroupingParams(paired=True))"
            )
        if self.fit_impl not in FIT_IMPLS:
            raise ValueError(
                f"unknown fit_impl {self.fit_impl!r} (allowed: {FIT_IMPLS})"
            )
        if self.ssc_method not in SSC_METHODS:
            raise ValueError(
                f"unknown ssc method {self.ssc_method!r} (ported: {SSC_METHODS})"
            )
        if self.packed_qbits is not None and not (
            self.packed_io
            and self.packed_qbits in SUBBYTE_QBITS
            and self.qual_lut
            and len(self.qual_lut) <= (1 << self.packed_qbits) - 1
            and self.cycles_len is not None
        ):
            raise ValueError(
                f"packed_qbits={self.packed_qbits!r} needs packed_io, a width "
                f"in {SUBBYTE_QBITS}, a qual_lut that fits it and cycles_len"
            )


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


# packed byte layout: base code (2 bits) | qual << 2 (6 bits); 0xFF
# marks a non-evidence cycle (N base or padding). Quals clip at 62 —
# lossless whenever max_input_qual <= 62.
PACKED_QUAL_MAX = 62
PACKED_NONE = 255

# sub-byte rung dictionary widths, smallest first: 3 index bits cover
# the <= 7-value alphabets of binned instruments (5 bits/cycle), 5 bits
# cover <= 31 values (7 bits/cycle). One index pattern (all ones) is
# reserved per width as the non-evidence marker.
SUBBYTE_QBITS = (3, 5)


def subbyte_qbits_for(alphabet_size: int) -> int | None:
    """Smallest dictionary width whose capacity covers the alphabet, or
    None (overflow -> byte-rung fallback)."""
    for qbits in SUBBYTE_QBITS:
        if alphabet_size <= (1 << qbits) - 1:
            return qbits
    return None


def qual_alphabet(buckets) -> tuple:
    """Sorted distinct input quals at real base cycles of valid reads
    across ``buckets``: the chunk's qual alphabet. Non-evidence cycles
    (N/PAD bases, invalid rows) pack as the NONE marker and are left
    out."""
    seen = np.zeros(256, bool)
    for bk in buckets:
        sel = (np.asarray(bk.bases) < 4) & np.asarray(bk.valid, bool)[:, None]
        seen[np.asarray(bk.quals)[sel]] = True
    return tuple(int(q) for q in np.nonzero(seen)[0])


def pack_base_qual(bases: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """Host-side pack of (.., L) u8 base codes + quals into one byte per
    cycle (numpy in, numpy out)."""
    real = bases < 4
    return np.where(
        real,
        bases | (np.minimum(quals, PACKED_QUAL_MAX).astype(np.uint8, copy=False) << 2),
        np.uint8(PACKED_NONE),
    ).astype(np.uint8, copy=False)


def pack_stacked(stacked: dict, spec: PipelineSpec | None = None,
                 out: dict | None = None) -> dict:
    """Apply the packed-io convention to a stacked bucket dict IN PLACE
    (the host side of spec.packed_io — fused_pipeline decodes):

      bases      byte rung: base|qual, one byte per cycle
                 (pack_base_qual); sub-byte rung (spec.packed_qbits):
                 base (2 bits) | qual-dictionary index (qbits),
                 bit-plane packed to 2+qbits bits per cycle
      umi        2-bit codes, four per byte
      pos        u16 (bucket-local dense ids < capacity)
      strand_ab  strand | frag_end<<1 | valid<<2 flag byte
      quals/frag_end/valid  zero-width dummies

    ``spec=None`` is the byte rung. The layout is the JAX package's,
    byte for byte. ``out`` (arrays of the packed shapes and dtypes, by
    key, for some of the keys above; the packed pos u16) receives those
    keys' packed arrays, which the dict then holds."""
    if spec is not None and spec.packed_qbits:
        qbits = spec.packed_qbits
        lut = np.asarray(spec.qual_lut, np.uint8)
        none_code = np.uint8((((1 << qbits) - 1) << 2) | 3)
        bases = np.asarray(stacked["bases"])
        # invalid rows' cycles pack as NONE too: the kernels mask them
        real = (bases < 4) & np.asarray(stacked["valid"], bool)[:, :, None]
        quals = np.asarray(stacked["quals"])
        # each qual's dictionary index (searchsorted in the dictionary),
        # read for u8 quals from the index of every u8 value
        qidx = np.minimum(
            np.searchsorted(lut, np.arange(256) if quals.dtype == np.uint8 else quals),
            len(lut) - 1,
        ).astype(np.uint8)
        if quals.dtype == np.uint8:
            qidx = qidx[quals]
        code = np.where(real, (qidx << 2) | bases, none_code)
        stacked["bases"] = np.concatenate(
            [
                # packbits packs each nonzero element as a one bit
                np.packbits(code & np.uint8(1 << b), axis=-1, bitorder="little")
                for b in range(2 + qbits)
            ],
            axis=-1,
        )
    else:
        stacked["bases"] = pack_base_qual(stacked["bases"], stacked["quals"])
    stacked["quals"] = np.zeros(stacked["quals"].shape[:2] + (0,), np.uint8)
    u = np.asarray(stacked["umi"])
    b_, r_, w_ = u.shape
    pad = (-w_) % 4
    if pad:
        u = np.concatenate([u, np.zeros((b_, r_, pad), np.uint8)], axis=2)
    u4 = u.reshape(b_, r_, -1, 4)
    stacked["umi"] = (
        u4[..., 0] | (u4[..., 1] << 2) | (u4[..., 2] << 4) | (u4[..., 3] << 6)
    ).astype(np.uint8)
    pos = np.asarray(stacked["pos"])
    if pos.max(initial=0) >= 1 << 16 or pos.min(initial=0) < 0:
        raise ValueError("packed io: bucket-local pos ids must fit u16")
    stacked["pos"] = pos.astype(np.uint16)
    stacked["strand_ab"] = (
        np.asarray(stacked["strand_ab"], bool).astype(np.uint8)
        | (np.asarray(stacked["frag_end"], bool).astype(np.uint8) << 1)
        | (np.asarray(stacked["valid"], bool).astype(np.uint8) << 2)
    )
    stacked["frag_end"] = np.zeros((b_, 0), np.uint8)
    stacked["valid"] = np.zeros((b_, 0), np.uint8)
    for k, dst in (out or {}).items():
        dst[...] = stacked[k]
        stacked[k] = dst
    return stacked


def spec_for_buckets(
    buckets,
    grouping: GroupingParams,
    consensus: ConsensusParams,
    ssc_method: str = "segment_gemm",
    packed_io: bool = False,
    per_base_counts: bool = False,
    packed_qbits: int | None = None,
    qual_lut: tuple | None = None,
    blockseg_t: int = BLOCKSEG_T,
) -> PipelineSpec:
    """Size the static axes from bucket statistics, exactly as the JAX
    package does: directional adjacency can only MERGE exact families,
    so the unique (pos, UMI) count per bucket bounds the cluster count:
      u_max >= max unique, f_max >= mult*unique, m_max >= unique
    (mult: 2 for the strand, 2 again for the mate-aware fragment end),
    all rounded to powers of two and capped at the read capacity R.
    The fit formulation comes from ``DUT_FIT_IMPL`` ("gather", the
    default, or "counts"), the JAX package's knob."""
    import os

    fit_impl = os.environ.get("DUT_FIT_IMPL", "gather")
    if not buckets:
        return PipelineSpec(
            grouping, consensus, ssc_method=ssc_method, blockseg_t=blockseg_t,
            packed_io=packed_io, per_base_counts=per_base_counts, fit_impl=fit_impl,
        )
    umi_len = int(buckets[0].umi.shape[1]) if packed_io else None
    cycles_len = int(buckets[0].bases.shape[1]) if packed_qbits else None
    r = buckets[0].capacity
    max_u = max(b.n_unique_umi for b in buckets)
    u_max = min(_pow2(max_u), r)
    f_mult = (2 if grouping.paired else 1) * (2 if grouping.mate_aware else 1)
    m_mult = 2 if (grouping.mate_aware and grouping.paired) else 1
    return PipelineSpec(
        grouping=grouping,
        consensus=consensus,
        u_max=u_max,
        f_max=min(_pow2(f_mult * max_u), r),
        m_max=min(_pow2(m_mult * max_u), r),
        ssc_method=ssc_method,
        blockseg_t=blockseg_t,
        presorted=True,  # bucketing's output contract
        packed_io=packed_io,
        umi_len=umi_len,
        packed_qbits=packed_qbits,
        qual_lut=qual_lut,
        cycles_len=cycles_len,
        per_base_counts=per_base_counts,
        fit_impl=fit_impl,
    )


def _ssc_cost_matmul(spec: PipelineSpec, r: int, cols: int) -> float:
    f = spec.f_max or r
    return 2.0 * f * r * cols  # dense one-hot product


def _ssc_cost_blockseg(spec: PipelineSpec, r: int, cols: int) -> float:
    t = min(spec.blockseg_t, r)
    return 2.0 * r * t * cols  # block-local rank one-hot products


def _ssc_cost_reduction(spec: PipelineSpec, r: int, cols: int) -> float:
    return 1.0 * r * cols  # one f32 add per evidence element


# Per-method ssc reduction cost functions, keyed on the port's method
# names (kernels/consensus.SSC_METHODS): a method without an entry
# cannot be costed, and analytic_flops raises on it. runsum's prefix sum
# is one add per evidence element, like the segmented reductions.
SSC_METHOD_COSTS = {
    "segment_gemm": _ssc_cost_reduction,
    "segment": _ssc_cost_reduction,
    "matmul": _ssc_cost_matmul,
    "blockseg": _ssc_cost_blockseg,
    "runsum": _ssc_cost_reduction,
}


def analytic_flops(spec: PipelineSpec, r: int, l: int, b: int) -> float:
    """Floating-point operations of ONE bucket's fused pipeline on an
    (r, l) bucket with b UMI code columns: the Hamming product, a floor
    of two min-propagation sweeps over the (U, U) grid, and the ssc
    reductions via ``SSC_METHOD_COSTS``. Other elementwise work is
    excluded, so it is a lower bound."""
    g, c = spec.grouping, spec.consensus
    u = spec.u_max or r
    fl = 0.0
    if g.strategy in ("adjacency", "cluster"):
        fl += 2.0 * u * u * 4 * b
        fl += 2 * 2.0 * float(u) ** 2
    cols = (5 * l + 1) + ((4 * l + 1) if c.error_model == "cycle" else 0)
    cost = SSC_METHOD_COSTS.get(spec.ssc_method)
    if cost is None:
        raise ValueError(
            f"ssc_method {spec.ssc_method!r} has no registered cost "
            f"function (SSC_METHOD_COSTS: {sorted(SSC_METHOD_COSTS)})"
        )
    fl += cost(spec, r, cols)
    return fl


@functools.lru_cache(maxsize=None)
def _qual_lut_on(qual_lut: tuple, none_idx: int, device: torch.device) -> torch.Tensor:
    """The sub-byte rung's qual alphabet on ``device``, padded to the full
    index range so the NONE index gathers the pad instead of reading past
    the end. Copied there once per alphabet: a copy from pageable host
    memory waits for the card's queue to drain, so a copy per call would
    make the dispatching thread wait on the device."""
    return torch.tensor(qual_lut + (0,) * (none_idx + 1 - len(qual_lut)), dtype=torch.uint8,
                        device=device)


def _decode_packed(pos, umi, strand_ab, bases, spec: PipelineSpec):
    """The packed wire convention (byte or sub-byte rung) -> the
    unpacked tensors."""
    if spec.umi_len is None:
        raise ValueError("packed_io requires spec.umi_len")
    steps.mark("decode")
    n, r = pos.shape
    if spec.packed_qbits:
        none_idx = (1 << spec.packed_qbits) - 1
        code = unpack_bitplanes(bases, spec.cycles_len, 2 + spec.packed_qbits)
        qidx = (code >> 2) & none_idx
        none = qidx == none_idx
        lut = _qual_lut_on(tuple(spec.qual_lut), none_idx, bases.device)
        quals = torch.where(none, 0, lut[qidx.long()]).to(torch.uint8)
        bases = torch.where(none, BASE_N, code & 3).to(torch.uint8)
    else:
        real_b = bases != PACKED_NONE
        quals = torch.where(real_b, bases >> 2, 0).to(torch.uint8)
        bases = torch.where(real_b, bases & 3, BASE_N).to(torch.uint8)
    flags = strand_ab.to(torch.uint8)
    strand_ab = (flags & 1) != 0
    frag_end = (flags & 2) != 0
    valid = (flags & 4) != 0
    # u16 crosses the wire as its int16 bit pattern; widen to i32 here
    pos = pos.view(torch.int16).to(torch.int32) & 0xFFFF
    shifts = torch.arange(4, dtype=torch.uint8, device=umi.device) * 2
    codes = (umi[..., None] >> shifts) & 3
    umi = codes.reshape(n, r, -1)[..., : spec.umi_len].contiguous()
    return pos, umi, strand_ab, frag_end, valid, bases, quals


def _segment_min(values, seg, n_rows):
    """Per-row minimum of (N, R) i32 ``values`` over reads with row id
    ``seg`` in [0, n_rows]; row n_rows is the sentinel and is sliced
    off. Rows no read reaches hold i32 max (the segment-min identity)."""
    n = values.shape[0]
    out = torch.full((n, n_rows + 1), 2**31 - 1, dtype=torch.int32, device=values.device)
    out.scatter_reduce_(1, seg.long(), values.to(torch.int32), "amin", include_self=False)
    return out[:, :n_rows]


def fused_pipeline(
    pos: torch.Tensor,  # (N, R) i32 bucket-local dense position ids
    umi: torch.Tensor,  # (N, R, B) u8
    strand_ab: torch.Tensor,  # (N, R) bool
    frag_end: torch.Tensor,  # (N, R) bool
    valid: torch.Tensor,  # (N, R) bool
    bases: torch.Tensor,  # (N, R, L) u8
    quals: torch.Tensor,  # (N, R, L) u8
    spec: PipelineSpec,
) -> dict:
    """Returns a dict of device tensors, each with the bucket axis N in
    front (the per-bucket JAX outputs, stacked):

      family_id, molecule_id (N, R) i32; n_families, n_molecules,
      n_overflow (N,) i32; cons_base/cons_qual (N, F, L) u8; cons_depth
      (N, F, L) i32; depth_max/depth_min_pos (N, F) i32; cons_valid
      (N, F) bool; cons_mate/cons_end (N, F) u8; cons_pair (N, F) i32
      [; cons_err (N, F, L) i32 with spec.per_base_counts]. Duplex
      mode: F = m_max rows per molecule (unit); ss mode: F = f_max.
    """
    g, c = spec.grouping, spec.consensus
    if spec.packed_io:
        pos, umi, strand_ab, frag_end, valid, bases, quals = _decode_packed(
            pos, umi, strand_ab, bases, spec
        )
    r = pos.shape[1]

    fam, mol, pair, n_fam, n_mol, n_over = group_kernel(
        pos, umi, strand_ab, frag_end, valid,
        strategy=g.strategy,
        max_hamming=g.max_hamming,
        count_ratio=g.effective_count_ratio,
        paired=g.paired,
        mate_aware=g.mate_aware,
        u_max=spec.u_max,
        presorted=spec.presorted,
    )

    f_max = spec.f_max or r
    m_max = spec.m_max or r

    # duplex mode reduces the ssc into rows keyed by the STRIDED id
    # molecule*2 + strand_ba whenever the geometry allows it (2*m_max ==
    # f_max), so the duplex merge is reshape-slicing; otherwise (a class
    # capped at the bucket capacity) rows are dense family ids and the
    # gather-based duplex_kernel merges them
    strided = c.mode == "duplex" and 2 * m_max == f_max
    if strided:
        red = torch.where(
            (mol >= 0) & valid,
            mol * 2 + (~strand_ab).to(torch.int32),
            torch.full_like(mol, -1),
        )
    else:
        red = fam

    def ssc(q, want_err=False, columns="full"):
        return ssc_kernel(
            bases, q, red, valid,
            f_max=f_max,
            min_reads=c.min_reads,
            max_qual=c.max_qual,
            max_input_qual=c.max_input_qual,
            min_input_qual=c.min_input_qual,
            method=spec.ssc_method,
            want_err=want_err,
            columns=columns,
            blockseg_t=spec.blockseg_t,
        )

    quals_eff = quals
    if c.error_model == "cycle":
        if spec.fit_impl == "counts":
            cb0, _sz0, fv0, counts0 = ssc(quals, columns="fit_counts")
            steps.mark("cycle_cap")
            cap = fit_cycle_cap_from_counts(cb0, counts0, fv0)
            del counts0
        else:
            cb0, _sz0, fv0 = ssc(quals, columns="fit")
            steps.mark("cycle_cap")
            cap = fit_cycle_cap_kernel(bases, red, valid, cb0, fv0)
        quals_eff = apply_cycle_cap(quals, cap)
        del cb0, _sz0, fv0
    elif c.error_model is not None:
        raise ValueError(f"unknown error model {c.error_model!r}")

    cb, cq, dep, size, fv, *err_rest = ssc(quals_eff, spec.per_base_counts)
    ss_err = err_rest[0] if err_rest else None

    out_e = None
    if c.mode == "single_strand":
        out_b, out_q, out_d, out_v = cb, cq, dep, fv
        out_e = ss_err
    elif strided:
        steps.mark("duplex_merge")
        out_b, out_q, out_d, out_v, *dx_rest = duplex_merge_strided(
            cb, cq, dep, size, fv, ss_err,
            m_max=m_max,
            min_duplex_reads=c.min_duplex_reads,
            max_qual=c.max_qual,
            want_err=spec.per_base_counts,
        )
        out_e = dx_rest[0] if dx_rest else None
    elif c.mode == "duplex":
        steps.mark("duplex_merge")
        out_b, out_q, out_d, out_v, *dx_rest = duplex_kernel(
            cb, cq, dep, fv, fam, mol, strand_ab, valid, ss_err,
            m_max=m_max,
            min_duplex_reads=c.min_duplex_reads,
            max_qual=c.max_qual,
            want_err=spec.per_base_counts,
        )
        out_e = dx_rest[0] if dx_rest else None
    else:
        raise ValueError(f"unknown consensus mode {c.mode!r}")

    # per-output-row mate/pair metadata, reduced from the read level by
    # segment-mins (constant within a row's reads by construction)
    steps.mark("row_stats")
    duplex_out = c.mode == "duplex"
    out_ids = mol if duplex_out else fam
    n_rows = m_max if duplex_out else f_max
    ok_r = valid & (out_ids >= 0)
    seg = torch.where(ok_r, torch.clamp(out_ids, max=n_rows), torch.full_like(out_ids, n_rows))
    e2_i = frag_end.to(torch.int32)
    ba_i = (~strand_ab).to(torch.int32)
    if duplex_out:
        mate_read, pair_read = e2_i, pair
    elif g.paired:
        mate_read = e2_i ^ ba_i
        pair_read = pair * 2 + ba_i
    else:
        mate_read, pair_read = e2_i, pair
    cons_mate = torch.where(out_v, _segment_min(mate_read, seg, n_rows), 0)
    cons_pair = torch.where(out_v, _segment_min(pair_read, seg, n_rows), -1)
    cons_end = torch.where(out_v, _segment_min(e2_i, seg, n_rows), 0)

    # per-row depth stats on device: the writers need only cD/cM
    d_max = out_d.amax(dim=2)
    pos_d = out_d > 0
    d_min_pos = torch.where(
        pos_d.any(dim=2),
        torch.where(pos_d, out_d, 2**31 - 1).amin(dim=2),
        0,
    )
    steps.mark(steps.END)
    return {
        "family_id": fam,
        "molecule_id": mol,
        "n_families": n_fam,
        "n_molecules": n_mol,
        "n_overflow": n_over,
        "cons_base": out_b.to(torch.uint8),
        "cons_qual": out_q.to(torch.uint8),
        "cons_depth": out_d,
        "depth_max": d_max,
        "depth_min_pos": d_min_pos,
        "cons_valid": out_v,
        "cons_mate": cons_mate.to(torch.uint8),
        "cons_pair": cons_pair,
        "cons_end": cons_end.to(torch.uint8),
        **({"cons_err": out_e} if out_e is not None else {}),
    }


def run_bucket(bucket, spec: PipelineSpec, device="cuda") -> dict:
    """Host entry for one host-side bucket (from bucketing/): its arrays
    go to ``device`` (the card unless "cpu" is asked for; no card
    raises) as a class of one, through :func:`fused_pipeline`. Returns
    the outputs for that bucket alone, as the JAX package's per-bucket
    run_bucket does: every key without the bucket axis, on ``device``."""
    from duplexumiconsensusreads_torch.bucketing import stack_buckets
    from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, stacked_from_numpy
    from duplexumiconsensusreads_torch.runtime.executor import resolve_device

    args = stacked_from_numpy(stack_buckets([bucket]), resolve_device(device))
    out = fused_pipeline(*(args[k] for k in ARRAY_KEYS), spec)
    return {k: v[0] for k, v in out.items()}
