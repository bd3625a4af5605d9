"""Per-cycle base-quality error model (benchmark config 5), batched over
the bucket axis.

Fit: per-cycle read-vs-family-consensus mismatch rates (Laplace
smoothed) -> a Phred cap per cycle and bucket. Apply: clip input
qualities at the cap. Mirrors the JAX package's kernels/error_model.py
bit for bit: the cap comes from f32 multiply/compare against the
shared threshold table (utils.phred.phred_cap_thresholds), never from
a log10, so it does not depend on the device's transcendentals. The
fit has two formulations, as in the JAX package: the read-side gather
(:func:`fit_cycle_cap_kernel`, the default) and the family-side counts
(:func:`fit_cycle_cap_from_counts`, ``DUT_FIT_IMPL=counts``).
"""

from __future__ import annotations

import functools

import torch

from duplexumiconsensusreads_torch.constants import N_REAL_BASES
from duplexumiconsensusreads_torch.utils.phred import phred_cap_thresholds


def fit_cycle_cap_kernel(
    bases: torch.Tensor,  # (N, R, L) u8
    family_id: torch.Tensor,  # (N, R) i32
    valid: torch.Tensor,  # (N, R) bool
    cons_base: torch.Tensor,  # (N, F, L) i32 single-strand consensus
    fam_valid: torch.Tensor,  # (N, F) bool
    *,
    max_phred_cap: int = 60,
) -> torch.Tensor:
    """Per-cycle Phred cap (N, L) i32."""
    n, r, l = bases.shape
    ok = valid & (family_id >= 0)
    fid = torch.where(ok, family_id, 0).long()
    # gather narrow (u8 rows), compare wide
    cb = torch.gather(cons_base.to(torch.uint8), 1, fid[..., None].expand(n, r, l))
    fv = torch.gather(fam_valid, 1, fid)
    contrib = (
        (ok & fv)[..., None]
        & (bases < N_REAL_BASES)
        & (cb < N_REAL_BASES)
    )
    mism = (contrib & (bases != cb)).sum(dim=1, dtype=torch.int32)
    total = contrib.sum(dim=1, dtype=torch.int32)
    thr = _thresholds_on(max_phred_cap, bases.device)
    m = (mism + 1).to(torch.float32)
    t = (total + 2).to(torch.float32)
    count = (m[..., None] <= t[..., None] * thr).sum(dim=-1, dtype=torch.int32)
    return torch.clamp(count - 1, 2, max_phred_cap).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _thresholds_on(max_phred_cap: int, device: torch.device) -> torch.Tensor:
    """The threshold table on ``device``, copied there once: a copy from
    pageable host memory waits for the card's queue to drain, so a copy
    per call would make the pipeline's host thread wait on the device."""
    return torch.as_tensor(phred_cap_thresholds(max_phred_cap), device=device)


def fit_cycle_cap_from_counts(
    cons_base: torch.Tensor,  # (N, F, L) i32 unmasked fit-pass argmax (BASE_N = no call)
    counts: torch.Tensor,  # (N, F, 4L) f32 per-base counts, column l*4+b
    fam_valid: torch.Tensor,  # (N, F) bool
    *,
    max_phred_cap: int = 60,
) -> torch.Tensor:
    """Per-cycle Phred cap (N, L) i32 — the family-side fit.

    Bit-identical to :func:`fit_cycle_cap_kernel`, from the per-family
    per-base counts the fit pass's reduction already produced
    (``ssc_kernel(columns="fit_counts")``) instead of a gather of the
    consensus into read space: mism[l] = sum_f total_f[l] -
    counts[f, l*4 + cons]. The JAX package's fit, batched over buckets;
    the per-family sums are small integers in f32, so their f32 sum
    over families is exact and the order of the adds does not matter.
    """
    mask = fam_valid[..., None] & (cons_base < N_REAL_BASES)  # (N, F, L)
    total_fl = counts[..., 0::4]
    match_fl = torch.where(cons_base == 0, counts[..., 0::4], 0.0)
    for b in range(1, 4):
        c_b = counts[..., b::4]
        total_fl = total_fl + c_b
        match_fl = match_fl + torch.where(cons_base == b, c_b, 0.0)
    total = torch.where(mask, total_fl, 0.0).sum(dim=1).to(torch.int32)
    mism = torch.where(mask, total_fl - match_fl, 0.0).sum(dim=1).to(torch.int32)
    thr = _thresholds_on(max_phred_cap, counts.device)
    m = (mism + 1).to(torch.float32)
    t = (total + 2).to(torch.float32)
    count = (m[..., None] <= t[..., None] * thr).sum(dim=-1, dtype=torch.int32)
    return torch.clamp(count - 1, 2, max_phred_cap).to(torch.int32)


def apply_cycle_cap(quals: torch.Tensor, cycle_cap: torch.Tensor) -> torch.Tensor:
    """Clip qualities (N, R, L) at the per-bucket per-cycle cap (N, L)."""
    return torch.minimum(quals.to(torch.int32), cycle_cap[:, None, :]).to(quals.dtype)
