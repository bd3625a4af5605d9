"""Multi-host initialisation and input partitioning, on torch.distributed.

The JAX package's parallel/distributed.py, with its coordination
runtime (``jax.distributed``) replaced by a ``torch.distributed``
``TCPStore``. Every host runs the same program on its own genomic key
range; buckets are independent, so no data moves between hosts: the
store carries only identity, rendezvous and the index election, and
the per-host outputs concatenate (BGZF members) to the whole-file
result.

What torch.distributed, the card and the absence of jit decide here:

- **Identity and rendezvous.** :func:`init_distributed` takes its
  address, world size and rank from its arguments or from torchrun's
  standard environment: ``MASTER_ADDR`` and ``MASTER_PORT`` (the
  store's address; the counterpart of ``JAX_COORDINATOR_ADDRESS``),
  ``WORLD_SIZE`` (of ``JAX_NUM_PROCESSES``) and ``RANK`` (of
  ``JAX_PROCESS_ID``). Host 0 serves the store; the others connect to
  it. A host told to join a store it cannot reach raises
  (``ConnectionError``); a multi-process run without an address or a
  rank raises too: no host ever runs uncoordinated because the store
  was missing. With nothing configured it is a single process, as in
  JAX; ``auto`` is accepted for the JAX signature and adds nothing,
  because torch's only cluster detection is that environment.
- **Devices.** ``local_devices`` is the number of CUDA devices this
  process sees (1 when it runs with ``device="cpu"``);
  ``global_devices`` is the sum over hosts, read through the store.
  Which card a host uses is ``CUDA_VISIBLE_DEVICES``'s choice; two
  hosts may share one card (the smoke's and the tests' one-machine
  runs), each passing ``--device`` through to its stream.
- **Barriers.** :func:`coordination_barrier` is a barrier on the store
  (an arrival counter, a done key set by the last arrival, a leave
  counter that host 0, which serves the store, waits on before it may
  go on and exit). It raises ``TimeoutError`` naming the barrier when
  a host does not arrive in time, and is a no-op for one process.
- **The index election** (:func:`multihost_call`) is the JAX one: every
  host passes both barriers; only host 0 builds the index; the
  done-barrier waits up to 6 h for a sequential scan of a large input.
- **Which bytes agree.** Per-host outputs concatenate to the one-host
  stream's records wherever bucketing cannot move the result (config3:
  identical records but the ``h{pid}_`` name tag). With the cycle error
  model (config5) a host's key range regroups buckets, so per-bucket
  cycle caps and hence quals move against the one-host run, in both
  packages alike (ROADMAP Faults 5, 6 and 11).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

# the store's own timeout for connecting and for a key read (a barrier
# passes its own): long enough for every host's interpreter and torch
# start-up, short of hanging a misconfigured run for ever
STORE_TIMEOUT_S = 300.0
_BARRIER_PREFIX = "duplexumi:barrier:"


@dataclasses.dataclass
class _Coordination:
    store: object  # torch.distributed.TCPStore
    address: str
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int
    generation: dict = dataclasses.field(default_factory=dict)


_STATE: _Coordination | None = None


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def _local_device_count(device) -> int:
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return 1
    return torch.cuda.device_count()


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    auto: bool = False,
    device=None,
    timeout_s: float = STORE_TIMEOUT_S,
) -> dict:
    """Join (or, as host 0, serve) the run's coordination store, from
    the arguments or the environment (MASTER_ADDR/MASTER_PORT,
    WORLD_SIZE, RANK). No-op on a single process. ``device`` is where
    this host computes (None: the card), for the device counts;
    ``timeout_s`` bounds the connect and the start-up rendezvous.

    Returns {"process_id", "num_processes", "local_devices",
    "global_devices"} for logging, the JAX keys."""
    global _STATE
    del auto  # torch's cluster detection is the environment read here
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        )
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    local = _local_device_count(device)
    if not coordinator_address and (num_processes or 1) <= 1:
        if _STATE is not None:
            return _info(_STATE)
        return {"process_id": 0, "num_processes": 1, "local_devices": local,
                "global_devices": local}
    if not coordinator_address:
        raise ValueError(
            f"a {num_processes}-process run needs the coordination store's "
            f"address (coordinator_address or MASTER_ADDR/MASTER_PORT)"
        )
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinated run needs its world size and rank "
            "(num_processes/process_id or WORLD_SIZE/RANK)"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is outside [0, {num_processes})")
    if _STATE is not None:
        if (_STATE.address, _STATE.process_id, _STATE.num_processes) != (
            coordinator_address, process_id, num_processes
        ):
            raise RuntimeError(
                f"already joined {_STATE.address} as process "
                f"{_STATE.process_id}/{_STATE.num_processes}"
            )
        return _info(_STATE)
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"coordinator address must be HOST:PORT (got {coordinator_address!r})"
        )
    from torch.distributed import TCPStore

    try:
        store = TCPStore(
            host, int(port), num_processes, process_id == 0,
            timeout=datetime.timedelta(seconds=timeout_s), wait_for_workers=False,
        )
    except RuntimeError as e:
        raise ConnectionError(
            f"process {process_id}/{num_processes} cannot "
            f"{'serve' if process_id == 0 else 'reach'} the coordination "
            f"store at {coordinator_address}: {e}"
        ) from e
    st = _Coordination(store, coordinator_address, process_id, num_processes, local, 0)
    store.set(f"duplexumi:devices:{process_id}", str(local))
    _STATE = st
    try:
        _barrier(st, "duplexumi:init", int(timeout_s * 1000))
        st.global_devices = sum(
            int(store.get(f"duplexumi:devices:{r}")) for r in range(num_processes)
        )
        _barrier(st, "duplexumi:init:devices", int(timeout_s * 1000))
    except BaseException:
        _STATE = None
        raise
    return _info(st)


def _info(st: _Coordination) -> dict:
    return {
        "process_id": st.process_id,
        "num_processes": st.num_processes,
        "local_devices": st.local_devices,
        "global_devices": st.global_devices,
    }


def shutdown_distributed() -> None:
    """Leave the coordination store (host 0 stops serving it once its
    last reference goes). After it this process is a single process
    again."""
    global _STATE
    _STATE = None


def _barrier(st: _Coordination, name: str, timeout_ms: int) -> None:
    gen = st.generation[name] = st.generation.get(name, 0) + 1
    key = f"{_BARRIER_PREFIX}{name}:{gen}"
    n = st.num_processes
    timeout = datetime.timedelta(milliseconds=timeout_ms)

    def wait(k: str, what: str) -> None:
        try:
            st.store.wait([k], timeout)
        except RuntimeError as e:
            try:
                arrived = f"{st.store.add(key + ':arrive', 0)} of {n} processes arrived"
            except RuntimeError:
                arrived = "the store is gone"
            raise TimeoutError(
                f"coordination barrier {name!r} timed out after {timeout_ms} ms "
                f"waiting for {what} ({arrived}; process "
                f"{st.process_id}/{n}): {e}"
            ) from e

    if st.store.add(key + ":arrive", 1) == n:
        st.store.set(key + ":done", "1")
    wait(key + ":done", "every process to arrive")
    if st.store.add(key + ":left", 1) == n:
        st.store.set(key + ":gone", "1")
    if st.process_id == 0:
        # the store lives in this process: it may go on (and exit) only
        # once every host has read the done key
        wait(key + ":gone", "every process to leave")


def coordination_barrier(name: str, timeout_ms: int = 600_000) -> bool:
    """Rendezvous all processes at ``name`` on the coordination store.
    Returns False (no-op) when not running distributed; raises
    ``TimeoutError`` naming the barrier when a process does not arrive
    within ``timeout_ms``."""
    st = _STATE
    if st is None or st.num_processes <= 1:
        return False
    _barrier(st, name, timeout_ms)
    return True


def _process_index() -> int:
    return _STATE.process_id if _STATE is not None else 0


def _process_count() -> int:
    return _STATE.num_processes if _STATE is not None else 1


def host_tile_range(
    n_tiles: int,
    process_id: int | None = None,
    num_processes: int | None = None,
) -> range:
    """This host's contiguous share of n_tiles genomic tiles.

    Tiles (position-key ranges) are the unit of input partitioning:
    each host streams only its BAM region, so the input pipeline scales
    with hosts exactly like the device pipeline does with cards.
    """
    pid = _process_index() if process_id is None else process_id
    n = _process_count() if num_processes is None else num_processes
    per = -(-n_tiles // n)
    return range(min(pid * per, n_tiles), min((pid + 1) * per, n_tiles))


def host_input_range(
    index,
    process_id: int | None = None,
    num_processes: int | None = None,
):
    """This host's share of a BAM, as a streaming input_range.

    The BamLinearIndex's sampled entries are the tiles host_tile_range
    partitions; each host's tile run maps to (start_voffset, key_lo,
    key_hi) — a BGZF seek point plus a pos_key half-open interval —
    consumable by stream_call_consensus(input_range=...). Returns None
    for an idle host (empty or degenerate share). The ranges of all
    hosts partition the key space exactly: every family lands on
    exactly one host (families never span pos_keys).
    """
    n_tiles = len(index.pos_key)
    if n_tiles == 0:
        pid = _process_index() if process_id is None else process_id
        # record-less file: host 0 runs the normal (no-seek) path so the
        # output still gets a header; everyone else is idle
        return (None, None, None) if pid == 0 else None
    r = host_tile_range(n_tiles, process_id, num_processes)
    if r.start >= r.stop:
        return None
    key_lo = int(index.pos_key[r.start]) if r.start > 0 else None
    key_hi = int(index.pos_key[r.stop]) if r.stop < n_tiles else None
    if key_lo is not None and key_hi is not None and key_lo >= key_hi:
        return None  # a giant same-key run swallowed this host's share
    start = index.start_voffset(key_lo)
    return (start, key_lo, key_hi)


def multihost_call(
    in_path: str,
    out_path: str,
    grouping,
    consensus,
    index_path: str | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
    index_every: int = 100_000,
    **stream_kw,
):
    """Run this host's partition of a consensus call.

    Each host writes ``out_path`` (conventionally suffixed with the
    host id by the caller); concatenating the per-host outputs in host
    order yields the whole-file result. Builds/loads the linear index
    on demand: under a coordination store host 0 alone builds it
    between the two election barriers. ``stream_kw`` goes to
    ``stream_call_consensus`` (``device`` included).
    """
    from duplexumiconsensusreads_torch.io.index import (
        INDEX_SUFFIX,
        BamLinearIndex,
        build_linear_index,
    )
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    idx_path = index_path or in_path + INDEX_SUFFIX
    if _process_count() > 1:
        # Index-build election: EVERY host passes BOTH barriers
        # unconditionally and the exists() check happens only inside
        # host 0's critical section. Hosts must never branch on their
        # own exists() view before a barrier (NFS attribute caches can
        # disagree across hosts, and a host that skipped a barrier
        # would deadlock the rest), and only host 0 ever writes, so
        # concurrent builds of one index file cannot race on shared
        # storage. The done-barrier timeout must outlast a sequential
        # scan of a large input (hours, not the default 10 minutes).
        coordination_barrier("duplexumi:index:elect")
        if _process_index() == 0 and not os.path.exists(idx_path):
            build_linear_index(in_path, every=index_every).save(idx_path)
        coordination_barrier("duplexumi:index:done", timeout_ms=6 * 3600 * 1000)
        index = BamLinearIndex.load(idx_path)
    elif os.path.exists(idx_path):
        index = BamLinearIndex.load(idx_path)
    else:
        index = build_linear_index(in_path, every=index_every)
        index.save(idx_path)
    rng = host_input_range(index, process_id, num_processes)
    pid = _process_index() if process_id is None else process_id
    if rng is None:
        return None  # idle host: no records in range
    return stream_call_consensus(
        in_path,
        out_path,
        grouping,
        consensus,
        input_range=rng,
        name_tag=f"h{pid}_",
        **stream_kw,
    )
