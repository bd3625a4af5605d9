"""Per-cycle base-quality error model (benchmark config 5), batched over
the bucket axis.

Fit: per-cycle read-vs-family-consensus mismatch rates (Laplace
smoothed) -> a Phred cap per cycle and bucket. Apply: clip input
qualities at the cap. Mirrors the JAX package's kernels/error_model.py
bit for bit: the cap comes from f32 multiply/compare against the
shared threshold table (utils.phred.phred_cap_thresholds), never from
a log10, so it does not depend on the device's transcendentals.
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


def apply_cycle_cap(quals: torch.Tensor, cycle_cap: torch.Tensor) -> torch.Tensor:
    """Clip qualities (N, R, L) at the per-bucket per-cycle cap (N, L)."""
    return torch.minimum(quals.to(torch.int32), cycle_cap[:, None, :]).to(quals.dtype)
