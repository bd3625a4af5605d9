"""Batched segmented row reduction — the ssc passes' per-family sum.

    out[b, f, :] = sum of big[b, r, :] over rows r with fid[b, r] == f

for every bucket b of a dispatch class at once. Ids outside [0, f_max)
contribute nowhere, and a family no row reaches comes out as exactly
0.0 (the fit pass reads its evidence mask from the sign of the sums).

Replaces the Pallas TPU kernel duplexumiconsensusreads_tpu/kernels/
pallas_ssc.py:segment_gemm. On CUDA the wrapper launches the
hand-written kernel csrc/segment_gemm.cu (one launch per class, no
float atomics, f32 adds in ascending row order); it is bound by bytes —
one read of ``big`` and one write of ``out``, adds only. On a CPU
tensor it runs :func:`segment_gemm_plain`, which performs the same f32
adds in the same order, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch


def segment_gemm_plain(big: torch.Tensor, fid: torch.Tensor, f_max: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: rows are
    added in ascending order into an f32 accumulator that starts at
    0.0, exactly the kernel's arithmetic. Out-of-range ids land in an
    overflow row that is sliced off."""
    nb, r, c = big.shape
    sel = (fid >= 0) & (fid < f_max)
    slot = torch.where(sel, fid, torch.full_like(fid, f_max)).long()
    out = torch.zeros(nb, f_max + 1, c, dtype=torch.float32, device=big.device)
    rows = torch.arange(nb, device=big.device)
    for i in range(r):
        # one row per bucket: the indices are distinct, so this is a
        # plain elementwise f32 add
        out[rows, slot[:, i]] += big[:, i]
    return out[:, :f_max]


def _check(big: torch.Tensor, fid: torch.Tensor, f_max: int) -> None:
    if big.dtype != torch.float32 or fid.dtype != torch.int32:
        raise TypeError(
            f"segment_gemm wants big f32 and fid i32, got {big.dtype} / {fid.dtype}"
        )
    if big.dim() != 3 or fid.shape != big.shape[:2]:
        raise ValueError(
            f"segment_gemm wants big (N, R, C) and fid (N, R), got "
            f"{tuple(big.shape)} / {tuple(fid.shape)}"
        )
    if big.device != fid.device:
        raise ValueError(f"big on {big.device} but fid on {fid.device}")
    if f_max < 1:
        raise ValueError(f"f_max must be >= 1, got {f_max}")


def segment_gemm(big: torch.Tensor, fid: torch.Tensor, f_max: int) -> torch.Tensor:
    """(N, R, C) f32 rows + (N, R) i32 ids -> (N, f_max, C) f32 sums.

    CUDA tensors launch the hand-written kernel (and raise if it cannot
    launch); CPU tensors take the plain version. Every launch adds one
    to ``segment_gemm.launches``."""
    _check(big, fid, f_max)
    if big.device.type == "cpu":
        return segment_gemm_plain(big, fid, f_max)
    if big.device.type != "cuda":
        raise ValueError(f"segment_gemm runs on cuda or cpu tensors, not {big.device}")
    if not (big.is_contiguous() and fid.is_contiguous()):
        raise ValueError("segment_gemm wants contiguous big and fid")
    from duplexumiconsensusreads_torch.kernels.build import load

    nb, r, c = big.shape
    out = torch.empty(nb, f_max, c, dtype=torch.float32, device=big.device)
    lib = load("segment_gemm")
    fn = lib.segment_gemm_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(big.device):
        stream = torch.cuda.current_stream(big.device).cuda_stream
        rc = fn(big.data_ptr(), fid.data_ptr(), out.data_ptr(), nb, r, c, f_max, stream)
    if rc != 0:
        raise RuntimeError(f"segment_gemm kernel launch failed (cudaError {rc})")
    segment_gemm.launches += 1
    return out


segment_gemm.launches = 0
