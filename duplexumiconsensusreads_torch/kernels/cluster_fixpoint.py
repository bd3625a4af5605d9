"""Directional-cluster fixpoint — grouping's min-ancestor propagation.

    s[n, j] = min(s0[n, j], min over every slot i that reaches j along
              the directed edges edge[n, i, j])

for every bucket n of a dispatch class at once: each unique-UMI slot
ends at the least combined key ``rank * U + slot`` among the slots
that reach it, which is its cluster seed (``kernels/grouping.py``).

The JAX package propagates in a ``lax.while_loop`` on the device
(duplexumiconsensusreads_tpu/kernels/grouping.py:160), one Jacobi sweep
per iteration until no slot changes, at most U sweeps. PyTorch has no
loop on the device, so on CUDA the wrapper launches the hand-written
kernel csrc/cluster_fixpoint.cu: one block per bucket sweeps to its own
fixpoint in shared memory, and the host neither waits nor reads
anything back. On a CPU tensor it runs :func:`propagate_min_plain`, the
batched Jacobi loop, which checks for a change on the host once per
sweep.

The fixpoint is unique, so the sweep order cannot change it: the
kernel updates in place (Gauss-Seidel), visits only each slot's
position-group range (an edge joins two slots of one position, and the
slots are sorted by position), and returns the plain loop's keys bit
for bit. Contract: ``edge[n, i, j]`` is set only where
``u_pos[n, i] == u_pos[n, j] != I32_MAX``, an edge between two valid
slots of one position (``_directional_cluster``'s edge grid ANDs both
in).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from duplexumiconsensusreads_torch.kernels.build import device_guard, load

I32_MAX = 2**31 - 1
# the kernel keeps s, u_pos and the CSR offsets in shared memory (12
# bytes a slot) and a slot index in 16 bits
MAX_U = 16384
# the dynamic shared memory a block may ask for on sm_90 (227 KB, less
# 1 KB for the kernel's static scratch)
SMEM_LIMIT = 231_424
# the in-neighbour list's default length, in i16 entries (32 KB): at
# u_max 2048 a block then asks for 57 KB, so three fit an SM. A bucket
# with more in-group edges sweeps over the edge grid instead
LIST_CAP = 16384


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


def _check(edge: torch.Tensor, s0: torch.Tensor, u_pos: torch.Tensor) -> None:
    if edge.dtype != torch.bool or s0.dtype != torch.int32 or u_pos.dtype != torch.int32:
        raise TypeError(
            f"propagate_min wants edge bool, s0 and u_pos i32, got "
            f"{edge.dtype} / {s0.dtype} / {u_pos.dtype}"
        )
    if s0.dim() != 2 or edge.shape != (*s0.shape, s0.shape[1]) or u_pos.shape != s0.shape:
        raise ValueError(
            f"propagate_min wants edge (N, U, U), s0 and u_pos (N, U), got "
            f"{tuple(edge.shape)} / {tuple(s0.shape)} / {tuple(u_pos.shape)}"
        )
    if not (edge.device == s0.device == u_pos.device):
        raise ValueError(f"edge on {edge.device}, s0 on {s0.device}, u_pos on {u_pos.device}")


def smem_bytes(u: int, list_cap: int) -> int:
    """The kernel's dynamic shared memory: s, u_pos and offsets (i32),
    then the i16 in-neighbour list."""
    return 12 * u + 4 + 2 * list_cap


def default_list_cap(u: int) -> int:
    """LIST_CAP entries, or what fits beside the slot arrays."""
    return max(0, min(LIST_CAP, (SMEM_LIMIT - smem_bytes(u, 0)) // 2))


def propagate_min(edge: torch.Tensor, s0: torch.Tensor, u_pos: torch.Tensor) -> torch.Tensor:
    """(N, U, U) bool edges + (N, U) i32 start keys + (N, U) i32 slot
    positions -> (N, U) i32 fixpoint keys.

    CUDA tensors launch the hand-written kernel, one launch per call
    (and raise if it cannot launch); CPU tensors take the plain version.
    The kernel's in-neighbour list holds default_list_cap(U) entries; a
    bucket with more in-group edges re-reads its edge grid every sweep
    instead. Every launch adds one to ``propagate_min.launches`` and to
    ``propagate_min.stream_launches[(device index, stream handle)]`` of
    the stream it was queued on (under a lock: the streaming executor's
    transfer workers launch at once)."""
    _check(edge, s0, u_pos)
    if s0.device.type == "cpu":
        return propagate_min_plain(edge, s0, u_pos)
    if s0.device.type != "cuda":
        raise ValueError(f"propagate_min runs on cuda or cpu tensors, not {s0.device}")
    n, u = s0.shape
    if u > MAX_U:
        raise ValueError(f"propagate_min's kernel takes u_max <= {MAX_U}, got {u}")
    cap = default_list_cap(u)
    out = torch.empty_like(s0)
    if n == 0:
        return out
    edge, s0, u_pos = edge.contiguous(), s0.contiguous(), u_pos.contiguous()
    stream = torch.cuda.current_stream(s0.device).cuda_stream
    with device_guard(s0.device):
        rc = _kernel()(edge.data_ptr(), s0.data_ptr(), u_pos.data_ptr(), out.data_ptr(),
                       n, u, cap, stream)
    if rc != 0:
        raise RuntimeError(f"cluster_fixpoint kernel launch failed (cudaError {rc})")
    with _COUNT_LOCK:
        propagate_min.launches += 1
        on = (s0.device.index, stream)
        propagate_min.stream_launches[on] = propagate_min.stream_launches.get(on, 0) + 1
    return out


def _kernel():
    """The kernel's C entry point, built and bound at first use."""
    global _FN
    if _FN is None:
        fn = load("cluster_fixpoint").cluster_fixpoint_i32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


_FN = None
propagate_min.launches = 0
propagate_min.stream_launches = {}
_COUNT_LOCK = threading.Lock()
