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

The kernel copies rows 16 bytes at a time, so on CUDA ``big`` must have
unit column stride and row and bucket strides that are multiples of 4
floats: :func:`padded_rows` allocates such a block (the evidence
columns are written into one), :func:`pad_rows` copies a tensor into
one. :func:`choose_tiles` picks each launch's tile shape.
"""

from __future__ import annotations

import ctypes

import torch

from duplexumiconsensusreads_torch.kernels.build import count_launch, device_guard, load

# the kernel's (columns, families) per block, largest first; columns
# are also its threads per block. None is larger than the kernel's first
# version's (128, 64), so a launch never gets a smaller grid than it
# did; (128, 32) leaves a block a quarter less shared memory, so four fit
# an SM at R = 2048. The last ones split a tail class's few families
# over blocks, one each.
TILES = ((128, 32), (64, 32), (64, 16), (32, 16), (32, 8), (32, 4), (32, 2), (32, 1))
# two blocks on each of the H100's 132 SMs
MIN_BLOCKS = 2 * 132


def grid_blocks(n: int, f_max: int, c: int, ct: int, ft: int) -> int:
    """Blocks of one launch over n buckets at tile (ct, ft)."""
    return -(-c // ct) * -(-f_max // ft) * n


def choose_tiles(n: int, f_max: int, c: int) -> tuple[int, int]:
    """The largest tile of TILES that gives the launch MIN_BLOCKS blocks,
    else the smallest (the most blocks the shape allows)."""
    for ct, ft in TILES:
        if grid_blocks(n, f_max, c, ct, ft) >= MIN_BLOCKS:
            return ct, ft
    return TILES[-1]


def padded_rows(n: int, r: int, c: int, device) -> torch.Tensor:
    """An uninitialised (n, r, c) f32 block whose rows start 16 bytes
    apart: the [..., :c] view of an (n, r, ceil(c/4)*4) buffer."""
    return torch.empty(n, r, -(-c // 4) * 4, dtype=torch.float32, device=device)[..., :c]


def pad_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (n, r, c) f32 copied into a :func:`padded_rows` block."""
    out = padded_rows(*x.shape, x.device)
    out.copy_(x)
    return out


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


def check_kernel_layout(big: torch.Tensor) -> None:
    """Raise unless the kernel can copy ``big``'s rows 16 bytes at a
    time: unit column stride, row and bucket strides that are multiples
    of 4 floats, a 16-byte-aligned start, and storage behind the last
    row up to its next multiple of 4 floats."""
    n, r, c = big.shape
    s0, s1, s2 = big.stride()
    if s2 != 1 or s1 % 4 or s0 % 4 or big.data_ptr() % 16:
        raise ValueError(
            f"segment_gemm's kernel wants unit column stride and row and bucket "
            f"strides that are multiples of 4 floats (see padded_rows), got strides "
            f"{big.stride()} at offset {big.storage_offset()}"
        )
    end = big.storage_offset() + (n - 1) * s0 + (r - 1) * s1 + -(-c // 4) * 4
    if s1 < c or end * 4 > big.untyped_storage().nbytes():
        raise ValueError(
            f"segment_gemm's kernel reads rows in 16-byte chunks: the storage of "
            f"{tuple(big.shape)} at strides {big.stride()} ends inside the last chunk"
        )


def segment_gemm(big: torch.Tensor, fid: torch.Tensor, f_max: int) -> torch.Tensor:
    """(N, R, C) f32 rows + (N, R) i32 ids -> (N, f_max, C) f32 sums.

    CUDA tensors launch the hand-written kernel (and raise if it cannot
    launch); ``big`` must then pass :func:`check_kernel_layout` and
    ``fid`` be contiguous. CPU tensors take the plain version. The
    kernel's grid carries the bucket axis in z, which CUDA caps at
    MAX_GRID_Z, so a class of more buckets (a small ladder rung of a
    large chunk) runs as several launches over consecutive bucket
    ranges, each at the tile :func:`choose_tiles` picks for it. Every
    launch adds one to ``segment_gemm.launches`` and to
    ``segment_gemm.stream_launches[(device index, stream handle)]`` of
    the stream it was queued on (``build.count_launch``: under a lock,
    since several threads launch at once in the streaming executor; a
    launch captured into a CUDA graph counts at each replay)."""
    _check(big, fid, f_max)
    if big.device.type == "cpu":
        return segment_gemm_plain(big, fid, f_max)
    if big.device.type != "cuda":
        raise ValueError(f"segment_gemm runs on cuda or cpu tensors, not {big.device}")
    if not fid.is_contiguous():
        raise ValueError("segment_gemm wants contiguous fid")
    check_kernel_layout(big)
    nb, r, c = big.shape
    out = torch.empty(nb, f_max, c, dtype=torch.float32, device=big.device)
    fn = _kernel()
    s0, s1 = big.stride(0), big.stride(1)
    p_big, p_fid, p_out = big.data_ptr(), fid.data_ptr(), out.data_ptr()
    with device_guard(big.device):
        stream = torch.cuda.current_stream(big.device).cuda_stream
        for b0 in range(0, nb, MAX_GRID_Z):
            n = min(MAX_GRID_Z, nb - b0)
            ct, ft = choose_tiles(n, f_max, c)
            # bucket b0's rows, ids and sums (4-byte elements)
            rc = fn(p_big + 4 * b0 * s0, s0, s1, p_fid + 4 * b0 * r, p_out + 4 * b0 * f_max * c,
                    n, r, c, f_max, ct, ft, stream)
            if rc != 0:
                raise RuntimeError(f"segment_gemm kernel launch failed (cudaError {rc})")
            count_launch(segment_gemm, big.device.index, stream)
    return out


def _kernel():
    """The kernel's C entry point, built and bound at first use."""
    global _FN
    if _FN is None:
        fn = load("segment_gemm").segment_gemm_f32
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


# the largest z extent of a CUDA grid (the kernel's bucket axis)
MAX_GRID_Z = 65535
_FN = None
segment_gemm.launches = 0
segment_gemm.stream_launches = {}
