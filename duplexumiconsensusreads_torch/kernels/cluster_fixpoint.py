"""Directional clustering — grouping's whole directional-cluster step:
the UMI-tools edges, the count ranks, the min-ancestor fixpoint and the
molecule ids.

:func:`directional_cluster` maps the unique-UMI slot table of a dispatch
class (packed words, positions, read counts), every bucket n at once, to
each slot's cluster seed, its molecule id and each bucket's molecule
count. This is ``group_kernel``'s adjacency/cluster branch
(``kernels/grouping.py``). On CUDA it launches the kernel
``directional_cluster_i32`` of csrc/cluster_fixpoint.cu, which builds
the directed UMI-tools edges, the count ranks and the molecule ids of
each bucket in shared memory, so no (N, U, U) tensor is written; on a
CPU tensor it runs :func:`directional_cluster_plain`, the plain PyTorch
version over the (N, U, U) grids.

Each unique-UMI slot ends at the least combined key ``rank * U + slot``
among the slots that reach it, which is its cluster seed. The JAX
package propagates in a ``lax.while_loop`` on the device
(duplexumiconsensusreads_tpu/kernels/grouping.py:160), one Jacobi sweep
per iteration until no slot changes, at most U sweeps. PyTorch has no
loop on the device: the plain version (:func:`propagate_min_plain`)
checks for a change on the host once per sweep, while the kernel runs
each bucket to its own fixpoint in one block and the host neither waits
nor reads anything back. The fixpoint is unique, so the sweep order
cannot change it: the kernel updates in place (Gauss-Seidel), visits
only each slot's position-group range (an edge joins two slots of one
position, and the slots are sorted by position; unsorted positions take
a full scan), and returns the plain loop's keys bit for bit.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from duplexumiconsensusreads_torch.kernels.build import count_launch, device_guard, load
from duplexumiconsensusreads_torch.kernels.encoding import CODES_PER_WORD, n_umi_words

I32_MAX = 2**31 - 1
# the kernel keeps a slot index in 16 bits
MAX_U = 16384
# the dynamic shared memory a block may ask for on sm_90 (227 KB, less
# 1 KB for the kernel's static scratch); the kernel's limit on every
# launch (csrc/cluster_fixpoint.cu: SMEM_LIMIT)
SMEM_LIMIT = 231_424
# an SM's shared memory on sm_90 (228 KB), what the runtime keeps of it
# for each resident block, and the kernel's static shared memory (under
# 256 bytes)
SM_SMEM = 233_472
BLOCK_RESERVED = 1024
STATIC_SMEM = 256
# the kernel's block (csrc/cluster_fixpoint.cu: THREADS) and the blocks
# an SM holds at 2048 threads: four, so the card runs 4 x 132 = 528
# buckets in one wave, where each block's shared memory is at most
# RESIDENT_SMEM
THREADS = 512
BLOCKS_PER_SM = 2048 // THREADS
RESIDENT_SMEM = SM_SMEM // BLOCKS_PER_SM - BLOCK_RESERVED - STATIC_SMEM
# the scratch a larger table still gets for its edge masks and
# in-neighbour list (32 KB, 16384 i16 entries), past RESIDENT_SMEM
LIST_CAP = 16384
# the slot table goes into shared memory where that leaves a list of at
# least MIN_LIST entries; else the block reads it from global memory
MIN_LIST = 4096


def propagate_min_plain(edge: torch.Tensor, s0: torch.Tensor, u_pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, on any device: Jacobi sweeps over the whole
    (N, U, U) edge grid until no bucket changed (extra sweeps past a
    bucket's fixpoint are idempotent), at most U sweeps, with one host
    check per sweep. ``u_pos`` is not needed here."""
    del u_pos
    s = s0
    big = torch.full((), I32_MAX, dtype=torch.int32, device=s0.device)
    for _ in range(s0.shape[1]):
        cand = torch.where(edge, s[:, :, None], big).amin(dim=1)
        new = torch.minimum(s, cand)
        if not bool((new != s).any()):
            break
        s = new
    return s


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


def _unpack_codes(u_words: torch.Tensor, u_valid: torch.Tensor, umi_len: int) -> torch.Tensor:
    """(N, U, W) packed words -> (N, U, umi_len) i32 codes in {0..3}
    (encoding.pack_umi_words inverted), 0 on empty slots."""
    n, u, w = u_words.shape
    shifts = torch.arange(CODES_PER_WORD - 1, -1, -1, dtype=torch.int32,
                          device=u_words.device) * 2
    codes = ((u_words[..., None] >> shifts) & 3).reshape(n, u, w * CODES_PER_WORD)
    return torch.where(u_valid[..., None], codes[..., :umi_len], 0)


def cluster_edges_plain(u_words, u_pos, u_cnt, umi_len: int, max_hamming: int,
                        count_ratio: int):
    """The plain edge build: the directed UMI-tools edge grid (N, U, U)
    bool and the start keys s0 = rank * U + slot (N, U) i32, rank by
    (-count, packed words) over the valid slots; an empty slot (u_pos
    I32_MAX) starts at U * U + slot and has no edge. Hamming distances
    come from a one-hot product of the codes: the entries are 0/1, so
    the f32 product is exact (integer sums far below 2^24), and stays
    exact under TF32 too, which rounds inputs but represents 0 and 1."""
    n, u, _ = u_words.shape
    if (u + 1) * u >= 2**31:
        raise ValueError(f"u_max {u} overflows the i32 combined seed key")
    dev = u_words.device
    u_valid = u_pos != I32_MAX
    u_codes = _unpack_codes(u_words, u_valid, umi_len)
    b = u_codes.shape[-1]
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
    s0 = torch.where(u_valid, rank, torch.full_like(rank, u)) * u + idx
    return edge, s0


def directional_cluster_plain(u_words, u_pos, u_cnt, umi_len: int, max_hamming: int,
                              count_ratio: int):
    """Plain PyTorch version, on any device: (seed, mid_of_slot, n_mol).

    The edge grid and start keys of :func:`cluster_edges_plain`, the
    fixpoint by :func:`propagate_min_plain` (seed = key % U), then the
    molecule ids: a slot's cluster key is (pos, words of its seed), and
    mid = the number of distinct valid keys below it, each key counted
    at its first slot; I32_MAX on empty slots. n_mol (N,) counts the
    distinct keys. The JAX package's _directional_cluster and the
    molecule-rank block of its group_kernel, step for step."""
    n, u, w = u_words.shape
    dev = u_words.device
    edge, s0 = cluster_edges_plain(u_words, u_pos, u_cnt, umi_len, max_hamming, count_ratio)
    seed = propagate_min_plain(edge, s0, u_pos) % u
    del edge, s0

    u_valid = u_pos != I32_MAX
    imax = torch.full((), I32_MAX, dtype=torch.int32, device=dev)
    seed_words = torch.gather(u_words, 1, seed.long()[..., None].expand(-1, -1, w))
    key_w = torch.where(u_valid[..., None], seed_words, imax)
    key_p = torch.where(u_valid, u_pos, imax)
    kless, keq = _pairwise_less_eq(
        key_p[:, None, :] < key_p[:, :, None],
        key_p[:, None, :] == key_p[:, :, None],
        key_w,
    )
    idx_u = torch.arange(u, device=dev)
    earlier = idx_u[None, :] < idx_u[:, None]
    firstk = ~(keq & earlier).any(dim=2)
    del keq
    fv = firstk & u_valid
    mid_raw_t = (kless & fv[:, None, :]).sum(dim=2, dtype=torch.int32)
    del kless
    n_mol = fv.sum(dim=1, dtype=torch.int32)
    mid_of_slot = torch.where(u_valid, mid_raw_t, imax)
    return seed, mid_of_slot, n_mol


def cluster_smem_bytes(u: int, w: int, table_in_smem: bool, scratch: int) -> int:
    """The kernel's dynamic shared memory: keys, CSR offsets and group
    ranges (i32 a slot), the slot table if it is held there, then
    ``scratch`` bytes for the edge masks and the i16 in-neighbour list."""
    return 4 * (3 * u + 1) + (4 * u * (w + 2) if table_in_smem else 0) + scratch


def cluster_plan(u: int, w: int) -> tuple[bool, int]:
    """(whether the slot table goes into shared memory, the scratch
    bytes) for a table of u slots of w words: a block of RESIDENT_SMEM
    (four an SM) where the table fits it, else its arrays and LIST_CAP
    list entries, within SMEM_LIMIT."""
    in_smem = cluster_smem_bytes(u, w, True, 2 * MIN_LIST) <= SMEM_LIMIT
    fixed = cluster_smem_bytes(u, w, in_smem, 0)
    total = min(SMEM_LIMIT, max(RESIDENT_SMEM, fixed + 2 * LIST_CAP))
    return in_smem, max(0, total - fixed)


def _check_table(u_words, u_pos, u_cnt, umi_len, max_hamming, count_ratio) -> None:
    if not (u_words.dtype == u_pos.dtype == u_cnt.dtype == torch.int32):
        raise TypeError(
            f"directional_cluster wants i32 words, positions and counts, got "
            f"{u_words.dtype} / {u_pos.dtype} / {u_cnt.dtype}"
        )
    if u_words.dim() != 3 or u_pos.shape != u_words.shape[:2] or u_cnt.shape != u_pos.shape:
        raise ValueError(
            f"directional_cluster wants words (N, U, W), positions and counts (N, U), got "
            f"{tuple(u_words.shape)} / {tuple(u_pos.shape)} / {tuple(u_cnt.shape)}"
        )
    if u_words.shape[-1] != n_umi_words(umi_len):
        raise ValueError(f"{u_words.shape[-1]} words do not hold a {umi_len}-base UMI")
    if not (u_words.device == u_pos.device == u_cnt.device):
        raise ValueError(
            f"words on {u_words.device}, positions on {u_pos.device}, counts on {u_cnt.device}"
        )
    for name, v in (("max_hamming", max_hamming), ("count_ratio", count_ratio)):
        try:
            ok = -(2**31) <= operator.index(v) < 2**31
        except TypeError:
            ok = False
        if not ok:
            raise ValueError(f"{name} must be an i32 integer, got {v!r}")


def directional_cluster(u_words: torch.Tensor, u_pos: torch.Tensor, u_cnt: torch.Tensor,
                        umi_len: int, max_hamming: int, count_ratio: int):
    """The slot table of a dispatch class -- (N, U, W) i32 packed UMI
    words (I32_MAX on empty slots), (N, U) i32 positions (I32_MAX on
    empty slots) and read counts -- and the UMI length, Hamming limit
    and count ratio -> (seed (N, U) i32, mid_of_slot (N, U) i32, n_mol
    (N,) i32), bit-identical to :func:`directional_cluster_plain`.

    CUDA tensors launch the hand-written kernel, one launch per call
    (and raise if it cannot launch), with nothing of size U x U in
    device memory; CPU tensors take the plain version. Every launch adds
    one to ``directional_cluster.launches`` and to
    ``directional_cluster.stream_launches[(device index, stream handle)]``
    of the stream it was queued on (``build.count_launch``: under a
    lock, since the streaming executor's transfer workers launch at
    once; a launch captured into a CUDA graph counts at each replay)."""
    _check_table(u_words, u_pos, u_cnt, umi_len, max_hamming, count_ratio)
    dev = u_words.device
    if dev.type == "cpu":
        return directional_cluster_plain(u_words, u_pos, u_cnt, umi_len, max_hamming,
                                         count_ratio)
    if dev.type != "cuda":
        raise ValueError(f"directional_cluster runs on cuda or cpu tensors, not {dev}")
    n, u, w = u_words.shape
    if u > MAX_U:
        raise ValueError(f"directional_cluster's kernel takes u_max <= {MAX_U}, got {u}")
    out = _cluster_outputs(n, u, dev)
    if n == 0:
        return out
    tabs = [a.contiguous() for a in (u_words, u_pos, u_cnt)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with device_guard(dev):
        rc = _cluster_kernel()(*_cluster_args(tabs, out, max_hamming, count_ratio), stream)
    if rc != 0:
        raise RuntimeError(f"directional_cluster kernel launch failed (cudaError {rc})")
    count_launch(directional_cluster, dev.index, stream)
    return out


def _cluster_outputs(n: int, u: int, dev):
    seed = torch.empty((n, u), dtype=torch.int32, device=dev)
    return seed, torch.empty_like(seed), torch.empty((n,), dtype=torch.int32, device=dev)


def _cluster_args(tabs, out, max_hamming, count_ratio) -> tuple:
    """The C entry's arguments but the stream, for the contiguous
    tables ``tabs`` (words, positions, counts) and the outputs."""
    n, u, w = tabs[0].shape
    in_smem, scratch = cluster_plan(u, w)
    return (*(a.data_ptr() for a in (*tabs, *out)), n, u, w, scratch, int(in_smem),
            operator.index(max_hamming), operator.index(count_ratio))


def _cluster_kernel():
    """directional_cluster's C entry point, built and bound at first use."""
    global _CLUSTER_FN
    if _CLUSTER_FN is None:
        fn = load("cluster_fixpoint").directional_cluster_i32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _CLUSTER_FN = fn
    return _CLUSTER_FN


# the macro of the build with per-phase clock stamps, and a block's row
# of stamps (csrc/cluster_fixpoint.cu: N_STAMPS)
PHASES_MACRO = "DUT_CLUSTER_PHASES"
N_STAMPS = 16


def directional_cluster_stamped(u_words, u_pos, u_cnt, umi_len: int, max_hamming: int,
                                count_ratio: int):
    """The kernel built from the same source with per-phase clock stamps
    (-D``PHASES_MACRO``; scripts/cluster_phases.py), CUDA tensors only:
    ((seed, mid_of_slot, n_mol), the (N, N_STAMPS) i64 stamp rows, the
    phase names). A measurement: it adds no launch to the counts."""
    _check_table(u_words, u_pos, u_cnt, umi_len, max_hamming, count_ratio)
    dev = u_words.device
    if dev.type != "cuda":
        raise ValueError(f"the stamped directional_cluster runs on cuda tensors, not {dev}")
    n, u, _ = u_words.shape
    if u > MAX_U:
        raise ValueError(f"directional_cluster's kernel takes u_max <= {MAX_U}, got {u}")
    lib = load("cluster_fixpoint", (PHASES_MACRO,))
    fn = lib.directional_cluster_i32_phases
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.directional_cluster_phase_names.restype = ctypes.c_char_p
    out = _cluster_outputs(n, u, dev)
    stamps = torch.zeros((n, N_STAMPS), dtype=torch.int64, device=dev)
    tabs = [a.contiguous() for a in (u_words, u_pos, u_cnt)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with device_guard(dev):
        rc = fn(*_cluster_args(tabs, out, max_hamming, count_ratio), stamps.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"stamped directional_cluster launch failed (cudaError {rc})")
    return out, stamps, lib.directional_cluster_phase_names().decode().split(",")


def cluster_blocks_per_sm(u: int, w: int) -> int:
    """How many blocks of the kernel one SM of the current card holds at
    once for a table of u slots of w words (CUDA's occupancy query at
    cluster_plan's shared memory)."""
    in_smem, scratch = cluster_plan(u, w)
    fn = load("cluster_fixpoint").directional_cluster_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(w, cluster_smem_bytes(u, w, in_smem, scratch))


_CLUSTER_FN = None
directional_cluster.launches = 0
directional_cluster.stream_launches = {}
