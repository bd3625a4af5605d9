"""Device meshes for bucket- and cycle-parallel execution.

The JAX package's parallel/mesh.py builds a ``jax.sharding.Mesh``; the
port has no GSPMD, so its mesh is a plain grid of ``torch.device``s
that ``parallel/sharded.py`` walks one lane at a time. The workload is
embarrassingly parallel over buckets, so the primary axis is 'data':
each lane of it takes a contiguous block of a class's buckets. An
optional 'cycle' axis splits the read-length axis of each data block
across ``cycle_shards`` lanes (see parallel/sharded.py for what runs
per cycle and what is combined afterwards).

What a device is here:

- **On the card** a lane is a CUDA device, always indexed (``cuda:i``,
  never bare ``cuda``: the per-device caches and launch guards key on
  the index). The pool (:func:`device_pool`) is the visible cards,
  narrowed to an index subset by ``devices`` as the JAX executors
  narrow ``jax.local_devices()``. With ``n_devices=None`` a run takes
  one lane, on the card as on the CPU, unless ``devices`` names a
  subset (then all of it): the JAX package's default is every device,
  but the port issues each lane's eager ops from Python, one lane
  after another, and on four H100s the stream at four lanes ran below
  one lane (ROADMAP Faults 13, PERF.md §6). ``--devices N`` / ``--mesh N`` ask for more.
- **On the CPU** (``device="cpu"``, the tests) a lane is the one CPU
  device, and the pool holds ``CPU_LANES`` logical lanes of it: the
  counterpart of the virtual devices the JAX suite forces with
  ``--xla_force_host_platform_device_count``. ``n_devices=None`` is one
  lane there, so a CPU run without mesh knobs is the one-device run.
- **Several lanes on one card.** :func:`make_mesh` takes an explicit
  device list, as JAX's does, and then may repeat a card (two lanes on
  two CUDA streams of ``cuda:0``: how a one-card machine drives the
  mesh path). No user-facing entry point does that: the pools it
  builds hold distinct cards.

Asking for more devices than the pool holds raises in JAX's words
(``requested N devices, have M``); a mesh never wraps onto fewer cards.
"""

from __future__ import annotations

import dataclasses

import torch

# logical lanes of the CPU device pool (the JAX suite's multi-device
# tests force 8 virtual CPU devices)
CPU_LANES = 8


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A (data,) or (data, cycle) grid of devices. ``grid[d][c]`` is the
    lane that runs data block d's cycle slice c; ``devices`` is the
    grid flattened row-major (data-major), the order in which lanes are
    numbered. Hashable, so per-mesh caches can key on it."""

    grid: tuple
    axis_names: tuple

    @property
    def devices(self) -> list:
        return [d for row in self.grid for d in row]

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    @property
    def n_data(self) -> int:
        return len(self.grid)

    @property
    def n_cycle(self) -> int:
        return len(self.grid[0])


def device_pool(device="cuda", devices=None) -> list:
    """The lanes a run may use: every visible card (``cuda:0`` ..), or
    the single card of an indexed ``device`` such as ``"cuda:2"``, or
    ``CPU_LANES`` lanes of the CPU; narrowed to the index subset
    ``devices`` (distinct indices into that pool, in the order given).
    Raises without a card unless the CPU is asked for, and on an index
    outside the pool in the JAX executors' words."""
    from duplexumiconsensusreads_torch.runtime.executor import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        pool = [dev] * CPU_LANES
    elif dev.index is not None:
        pool = [dev]
    else:
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if devices:
        idx = [int(i) for i in devices]
        if len(set(idx)) != len(idx):
            raise ValueError(f"devices={list(devices)} repeats an index")
        bad = [i for i in idx if not 0 <= i < len(pool)]
        if bad:
            raise ValueError(
                f"devices={list(devices)} out of range: this host has "
                f"{len(pool)} local devices"
            )
        pool = [pool[i] for i in idx]
    return pool


def make_mesh(
    n_devices: int | None = None,
    axis: str = "data",
    cycle_shards: int = 1,
    devices=None,
) -> DeviceMesh:
    """A ('data',) mesh, or ('data', 'cycle') when cycle_shards > 1.

    ``n_devices`` counts TOTAL lanes and must be divisible by
    cycle_shards. ``devices`` is the device pool (default: every
    visible card, :func:`device_pool`); it may repeat a device, which
    then serves several lanes."""
    devs = list(device_pool() if devices is None else devices)
    devs = [torch.device(d) for d in devs]
    if any(d.type == "cuda" and d.index is None for d in devs):
        raise ValueError("mesh devices must be indexed (cuda:i, not cuda)")
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if cycle_shards <= 1:
        return DeviceMesh(tuple((d,) for d in devs[:n]), (axis,))
    if n % cycle_shards:
        raise ValueError(
            f"n_devices {n} not divisible by cycle_shards {cycle_shards}"
        )
    grid = tuple(
        tuple(devs[r * cycle_shards : (r + 1) * cycle_shards])
        for r in range(n // cycle_shards)
    )
    return DeviceMesh(grid, (axis, "cycle"))


def run_mesh(
    device="cuda", n_devices: int | None = None, devices=None, cycle_shards: int = 1
) -> DeviceMesh:
    """The mesh an executor runs on: :func:`make_mesh` over
    :func:`device_pool` (distinct cards, or CPU lanes). ``n_devices``
    None is the whole ``devices`` subset when one is given, else one
    lane (on the card too, where JAX takes every device: ROADMAP Faults
    13)."""
    pool = device_pool(device, devices)
    if n_devices is None:
        n_devices = len(pool) if devices else 1
    return make_mesh(n_devices, cycle_shards=cycle_shards, devices=pool)
