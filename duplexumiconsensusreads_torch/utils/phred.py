"""Phred-scale quality math and base-code helpers (NumPy, host-side).

These are the single source of truth for quality<->probability
conversions; the oracle and the JAX kernels both follow the same
conventions (see kernels/consensus.py for the on-device mirror).
"""

from __future__ import annotations

import numpy as np

from duplexumiconsensusreads_torch.constants import (
    BASE_CHARS,
    CHAR_TO_CODE,
    MAX_PHRED,
    MIN_ERROR_PROB,
)


def phred_to_error(q: np.ndarray) -> np.ndarray:
    """Error probability for integer Phred quality q: e = 10**(-q/10)."""
    return np.maximum(10.0 ** (-np.asarray(q, dtype=np.float64) / 10.0), MIN_ERROR_PROB)


def error_to_phred(e: np.ndarray, max_phred: int = MAX_PHRED) -> np.ndarray:
    """Integer Phred quality for error probability e, clipped to [2, max_phred]."""
    e = np.maximum(np.asarray(e, dtype=np.float64), MIN_ERROR_PROB)
    q = np.floor(-10.0 * np.log10(e) + 1e-9)
    return np.clip(q, 2, max_phred).astype(np.uint8)


def seq_to_codes(seq: str) -> np.ndarray:
    """ACGTN string -> u8 codes (A=0..T=3, N=4)."""
    return np.array([CHAR_TO_CODE.get(c, 4) for c in seq.upper()], dtype=np.uint8)


def codes_to_seq(codes: np.ndarray) -> str:
    """u8 codes -> ACGTN. string (PAD renders as '.')."""
    return "".join(BASE_CHARS[min(int(c), 5)] for c in codes)


def phred_cap_thresholds(max_phred_cap: int) -> np.ndarray:
    """f32 error-rate thresholds 10^(-q/10) for q = 0..max — the ONE
    table both the error-model oracle and device kernel compare
    against; any change here changes both sides together."""
    return (10.0 ** (-np.arange(max_phred_cap + 1) / 10.0)).astype(np.float32)


def phred_cap_from_counts(
    mism: np.ndarray, total: np.ndarray, max_phred_cap: int
) -> np.ndarray:
    """floor(-10*log10((mism+1)/(total+2))) clipped to [2, max], computed
    EXACTLY via f32 threshold comparisons.

    cap = #{q in [0..max] : rate <= 10^(-q/10)} - 1. Both sides of each
    comparison are f32 ((m+1) vs (t+2)*thr[q]); IEEE f32 multiply and
    compare give bit-identical answers on NumPy and XLA/TPU, so the
    device kernel (kernels/error_model.py) reproduces this function
    bit-for-bit — a log10 in f32-on-device vs f64-on-host would flip
    caps at floor boundaries and cascade into second-pass consensus
    differences.
    """
    thr = phred_cap_thresholds(max_phred_cap)
    m = (np.asarray(mism) + 1).astype(np.float32)
    t = (np.asarray(total) + 2).astype(np.float32)
    count = (m[:, None] <= t[:, None] * thr[None, :]).sum(axis=1)
    return np.clip(count - 1, 2, max_phred_cap).astype(np.uint8)


def pack_umi(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit UMI codes (..., U) into a single int64 per UMI.

    Only valid for U <= 31 and codes in {0..3}; N in a UMI should be
    handled upstream (reads with N UMIs are conventionally dropped).
    For longer UMIs use pack_umi_words64 (multi-word, any length).
    """
    codes = np.asarray(codes, dtype=np.int64)
    u = codes.shape[-1]
    if u > 31:
        raise ValueError(f"UMI length {u} > 31 cannot pack into int64")
    if codes.size and (codes.min() < 0 or codes.max() >= 4):
        raise ValueError(
            "pack_umi requires 2-bit codes in {0..3}; reads with N in the "
            "UMI must be dropped upstream (io layer)"
        )
    shifts = np.arange(u, dtype=np.int64)[::-1] * 2
    return (codes << shifts).sum(axis=-1)


def pack_umi_words64(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit UMI codes (N, U) into (N, W) big-endian int64 words
    of up to 31 codes each — any UMI length, and comparing the word
    columns lexicographically orders exactly like comparing the code
    strings lexicographically (the invariant every host sort and
    unique-key count relies on).
    """
    codes = np.asarray(codes, dtype=np.int64)
    n, u = codes.shape
    w = max(-(-u // 31), 1)
    padded = np.zeros((n, w * 31), np.int64)
    padded[:, :u] = codes
    shifts = np.arange(31, dtype=np.int64)[::-1] * 2
    return (padded.reshape(n, w, 31) << shifts).sum(axis=-1)


def umi_sort_keys(umi: np.ndarray) -> list[np.ndarray]:
    """np.lexsort key columns for UMI codes, PRIMARY FIRST (callers
    reverse for lexsort's last-key-primary convention)."""
    words = pack_umi_words64(umi)
    return [words[:, i] for i in range(words.shape[1])]
