"""Device-side encodings: multi-word 2-bit UMI packing, one-hot helpers.

UMIs of B bases pack big-endian into ceil(B/15) int32 words (15 2-bit
codes per word keeps the sign bit clear), so lexicographic comparison
of the word tuple equals comparison of the packed UMI, matching the
host oracle's single-int64 ``pack_umi`` ordering for B <= 31.
"""

from __future__ import annotations

import torch

CODES_PER_WORD = 15


def n_umi_words(umi_len: int) -> int:
    return max(1, -(-umi_len // CODES_PER_WORD))


def pack_umi_words(umi_codes: torch.Tensor) -> torch.Tensor:
    """(..., B) codes in {0..3} -> (..., W) i32 big-endian words."""
    b = umi_codes.shape[-1]
    w = n_umi_words(b)
    pad = w * CODES_PER_WORD - b
    c = torch.nn.functional.pad(umi_codes.to(torch.int32), (0, pad))
    c = c.reshape(*umi_codes.shape[:-1], w, CODES_PER_WORD)
    shifts = torch.arange(
        CODES_PER_WORD - 1, -1, -1, dtype=torch.int32, device=c.device
    ) * 2
    return (c << shifts).sum(dim=-1, dtype=torch.int32)


def one_hot_bases(codes: torch.Tensor, n: int = 4, dtype=torch.float32) -> torch.Tensor:
    """(...,) codes -> (..., n) one-hot; codes >= n produce all-zero rows."""
    return (codes[..., None] == torch.arange(n, dtype=codes.dtype, device=codes.device)).to(dtype)


def pack_2bit(codes: torch.Tensor) -> torch.Tensor:
    """(..., l) u8 codes in {0..3} -> (..., ceil(l/4)) u8, four per byte
    (little-endian pairs)."""
    l = codes.shape[-1]
    pad = (-l) % 4
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    c4 = codes.reshape(*codes.shape[:-1], -1, 4)
    return (
        c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4) | (c4[..., 3] << 6)
    ).to(torch.uint8)


def unpack_bitplanes(packed: torch.Tensor, l: int, nbits: int) -> torch.Tensor:
    """(..., nbits*ceil(l/8)) u8 bit-planes -> (..., l) u8 codes.

    The wire layout of the sub-byte H2D rung (ops/pipeline.pack_stacked):
    ``nbits`` separate little-endian bit-planes, each ceil(l/8) bytes,
    concatenated along the last axis — plane b holds bit b of every
    cycle's code. Shifts and masks only; codes stay below 2**nbits <=
    128, so the u8 sum cannot wrap."""
    l8 = packed.shape[-1] // nbits
    lead = packed.shape[:-1]
    planes = packed.reshape(*lead, nbits, l8)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (planes[..., None] >> shifts) & 1  # (..., nbits, l8, 8)
    bits = bits.reshape(*lead, nbits, l8 * 8)[..., :l]
    plane_shifts = torch.arange(nbits, dtype=torch.uint8, device=packed.device)
    return (bits << plane_shifts[:, None]).sum(dim=-2, dtype=torch.uint8)
