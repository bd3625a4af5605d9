"""Each kernel's least time on the card, from the operations and bytes
the cell's own inputs need, against NVIDIA's published H100 SXM peaks
(data sheet, dense; at the full 700 W power limit — a card set lower
runs slower, so a run prints its card's limit beside these shares).

- ``segment_gemm`` (``csrc/segment_gemm.cu``): family sums of an
  (N, R, C) f32 evidence block. The live rows (valid reads) are read
  once at C columns, every id once, every output element (N, F, C)
  written once; an add per live element at the f32 rate outside the
  tensor cores.
- ``directional_cluster`` (``csrc/cluster_fixpoint.cu``): each slot
  the data fills in the unique-UMI table (N, U) of W words, its
  position and count read once, its seed and molecule id written once,
  and a molecule count a bucket; the padding of the table is not
  counted, as the least time need not touch it; against the int32
  operations its data needs: a position group of n unique UMIs has
  n (n - 1) / 2 pairs, each a Hamming distance and limit (5 W), the
  edge test each way (2) and the rank (1 + W); m molecules of a
  position need W + 1 a pair of them; one min a directed edge for the
  fixpoint; 3 a valid slot.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# 64 int32 lanes an SM x 132 SMs x 1.98 GHz boost (Hopper white paper)
I32_OPS = 64 * 132 * 1.98e9


def segment_gemm_seconds(n_buckets: int, rows: int, f_max: int, cols: int, live: int) -> float:
    """Least seconds of one launch over ``n_buckets`` buckets of ``rows``
    rows, ``live`` of them valid, reduced into ``f_max`` families of
    ``cols`` columns."""
    need = live * cols * 4 + n_buckets * rows * 4 + n_buckets * f_max * cols * 4
    return max(need / HBM_BYTES_PER_S, live * cols / F32_FLOPS)


def ssc_columns(read_len: int, fit: bool) -> int:
    """Evidence columns of an ssc pass: 4 log-likelihoods a cycle, a
    depth column a cycle (not in the error model's fit pass) and the
    read count."""
    return 4 * read_len + 1 if fit else 5 * read_len + 1


def cluster_seconds(n_buckets: int, words: int, pairs: int, mol_pairs: int, edges: int,
                    n_valid: int) -> float:
    """Least seconds of one launch over ``n_buckets`` buckets whose
    tables hold ``n_valid`` unique UMIs in all."""
    need = n_valid * (words + 2) * 4 + 2 * n_valid * 4 + n_buckets * 4
    ops = pairs * (6 * words + 4) + mol_pairs * (words + 1) + edges + 3 * n_valid
    return max(need / HBM_BYTES_PER_S, ops / I32_OPS)


def umi_words(n_codes: int) -> int:
    """int32 words of a UMI in the cluster kernel's table (15 codes a
    word)."""
    return -(-n_codes // 15)
