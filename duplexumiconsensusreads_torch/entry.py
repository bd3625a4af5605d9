"""Entry points of the port: a single-card step and a multi-lane
dry run — the counterparts of the JAX package's ``__graft_entry__.py``.

``entry(device="cuda")`` returns the flagship forward step — the fused
duplex pipeline (grouping, ssc, the cycle error model, the duplex
merge) over one padded read bucket — with its example arguments, on
the same example bucket and spec as the JAX entry.

``dryrun_multichip(n, device="cuda")`` runs the JAX dry run's checks
on n mesh lanes (parallel/mesh.py): the sharded call set, the packed-io
identity, (n/2, 2) cycle shards, the streaming executor at n lanes and
at 1 lane byte-identical, and the per-lane balance, printed as one
``MULTICHIP_BALANCE`` JSON line. The lanes are cards, or ``CPU_LANES``
logical lanes of the CPU with ``device="cpu"``.

Both raise without a card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from duplexumiconsensusreads_torch.bucketing import build_buckets, pad_buckets, stack_buckets
from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, stacked_from_numpy
from duplexumiconsensusreads_torch.ops.pipeline import PipelineSpec, fused_pipeline
from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

SPEC = PipelineSpec(
    grouping=GroupingParams(strategy="adjacency", paired=True, mate_aware=True),
    consensus=ConsensusParams(mode="duplex", error_model="cycle"),
    u_max=256,
    # mate-aware paired: up to 4 families per unique (pos, UMI) and 2
    # duplex units (one per fragment end), capped by the read capacity
    f_max=512,
    m_max=256,
)


def _uniform_buckets(batch, capacity):
    """The buckets of the given capacity (an oversized position group
    gives preclustered or jumbo buckets, which need a spec of their
    own)."""
    buckets = build_buckets(batch, capacity=capacity, grouping=SPEC.grouping)
    return [b for b in buckets if b.capacity == capacity and not b.preclustered]


def example_bucket(capacity: int = 256, n_molecules: int = 40, seed: int = 0):
    """The JAX entry's example bucket: the first uniform-geometry bucket
    of a small paired duplex simulation."""
    batch, _ = simulate_batch(SimConfig(
        n_molecules=n_molecules, duplex=True, paired_reads=True, umi_error=0.02, seed=seed,
    ))
    buckets = _uniform_buckets(batch, capacity)
    assert buckets
    return buckets[0]


def entry(device="cuda"):
    """(fn, example_args): the fused duplex pipeline over one bucket, its
    arguments the bucket's arrays on ``device`` with the bucket axis in
    front (N = 1)."""
    from duplexumiconsensusreads_torch.runtime.executor import resolve_device

    args = stacked_from_numpy(stack_buckets([example_bucket()]), resolve_device(device))

    def forward(pos, umi, strand_ab, frag_end, valid, bases, quals):
        return fused_pipeline(pos, umi, strand_ab, frag_end, valid, bases, quals, SPEC)

    return forward, tuple(args[k] for k in ARRAY_KEYS)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the full pipeline over an n-lane mesh and the JAX dry run's
    checks; prints and returns the balance record."""
    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.parallel import mesh as mesh_mod
    from duplexumiconsensusreads_torch.parallel.sharded import gather_outputs, sharded_pipeline
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    pool = mesh_mod.device_pool(device)
    assert len(pool) >= n_devices, f"need {n_devices} devices, have {len(pool)}"

    def run(buckets, spec, mesh):
        return gather_outputs(sharded_pipeline(buckets, spec, mesh), mesh)

    batch, _ = simulate_batch(SimConfig(
        n_molecules=8 * n_devices, n_positions=4 * n_devices, duplex=True, paired_reads=True,
        seed=1,
    ))
    buckets = _uniform_buckets(batch, 64)
    assert buckets, "dry-run sim produced only jumbo buckets"
    mesh = mesh_mod.make_mesh(n_devices, devices=pool)
    out = run(buckets, SPEC, mesh)
    n_called = int(out["cons_valid"].sum())
    assert n_called > 0, "dry run produced no consensus calls"

    # the packed transfer path (the streaming executor's production
    # mode), decoded on the device: the identical call set
    umi_len = int(buckets[0].umi.shape[1])
    out_pk = run(buckets, dataclasses.replace(SPEC, packed_io=True, umi_len=umi_len), mesh)
    for key in ("cons_valid", "family_id", "cons_base"):
        assert np.array_equal(out_pk[key], out[key]), f"packed-io run changed {key}"

    if n_devices % 2 == 0:
        # the (data, cycle) mesh: each data block's read length split
        # over two lanes
        mesh2 = mesh_mod.make_mesh(n_devices, cycle_shards=2, devices=pool)
        out2 = run(buckets, SPEC, mesh2)
        assert int(out2["cons_valid"].sum()) == n_called, "cycle-sharded run changed the call set"

    # the streaming executor end to end at n lanes and at 1 lane: the
    # output BAMs are byte-identical (lane count is a throughput knob)
    sharded_facts = {}
    with tempfile.TemporaryDirectory(prefix="dut_multichip_") as td:
        in_bam = os.path.join(td, "in.bam")
        simulated_bam(SimConfig(
            n_molecules=24 * n_devices, n_positions=6 * n_devices, duplex=True,
            paired_reads=True, umi_error=0.02, seed=3,
        ), path=in_bam, sort=True)
        walls, outs = {}, {}
        for nd in (n_devices, 1):
            out_bam = os.path.join(td, f"out{nd}.bam")
            t0 = time.monotonic()
            rep = stream_call_consensus(
                in_bam, out_bam, SPEC.grouping, SPEC.consensus, capacity=64,
                chunk_reads=max(24 * n_devices, 64), n_devices=nd, device=device,
            )
            walls[nd] = time.monotonic() - t0
            with open(out_bam, "rb") as f:
                outs[nd] = f.read()
            if nd == n_devices:
                sharded_facts = {
                    "n_reads": rep.n_records, "n_consensus": rep.n_consensus,
                    "n_chunks": rep.n_chunks, "mesh_pad_buckets": rep.n_mesh_pad_buckets,
                }
        assert sharded_facts["n_consensus"] > 0, "sharded run produced no consensus records"
        assert outs[n_devices] == outs[1], (
            f"{n_devices}-lane output differs from 1-lane output "
            f"({len(outs[n_devices])} vs {len(outs[1])} bytes)")
        sharded_facts["byte_identical_vs_1dev"] = True
        sharded_facts["wall_s"] = round(walls[n_devices], 3)
        sharded_facts["wall_1dev_s"] = round(walls[1], 3)

    # per-lane balance: whole padded buckets per lane, so every lane
    # has the same bucket count; record each lane's valid reads and
    # step time
    padded = pad_buckets(buckets, n_devices)
    per = len(padded) // n_devices
    shard_reads, shard_step_s = [], []
    for di, dev in enumerate(mesh.devices[:n_devices]):
        sub = padded[di * per:(di + 1) * per]
        shard_reads.append(sum(int(b.valid.sum()) for b in sub))
        m1 = mesh_mod.make_mesh(1, devices=[dev])
        run(sub, SPEC, m1)  # untimed warm-up
        reps = 3
        t0 = time.monotonic()
        for _ in range(reps):
            # the host copy of the outputs is the completion barrier
            run(sub, SPEC, m1)
        shard_step_s.append((time.monotonic() - t0) / reps)
    balance = {
        "n_devices": n_devices,
        "buckets_per_device": per,
        "per_device_reads": shard_reads,
        "per_device_step_s": [round(t, 5) for t in shard_step_s],
        "read_balance_max_min": round(max(shard_reads) / max(min(shard_reads), 1), 3),
        "step_balance_max_min": round(max(shard_step_s) / max(min(shard_step_s), 1e-9), 3),
        "sharded_run": sharded_facts,
        "n_called": n_called,
    }
    print("MULTICHIP_BALANCE " + json.dumps(balance))
    return balance
