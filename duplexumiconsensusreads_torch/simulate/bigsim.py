"""At-scale BAM simulation: write a coordinate-sorted, truth-free BAM
of arbitrary size in bounded memory.

The in-memory simulator (simulator.py) materialises every read at
once — fine for tests, hopeless for the 10M+-read end-to-end benchmark
input (BASELINE.json's north-star is wall-clock on a 200M-read BAM).
This writer simulates independent position-range chunks and appends
each as its own BGZF member run, so peak memory is one chunk and the
output is globally coordinate-sorted (chunk i's positions all precede
chunk i+1's).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from duplexumiconsensusreads_torch.io import bgzf
from duplexumiconsensusreads_torch.io.bam import BamHeader, serialize_bam
from duplexumiconsensusreads_torch.io.convert import readbatch_to_records
from duplexumiconsensusreads_torch.simulate.simulator import SimConfig, simulate_batch


def simulate_bam_file(
    path: str,
    n_molecules: int,
    cfg: SimConfig | None = None,
    chunk_molecules: int = 25_000,
    seed: int = 0,
    paired_end: bool = False,
    progress=None,
) -> dict:
    """Write ``n_molecules`` worth of simulated reads to ``path``.

    cfg supplies per-chunk parameters (read_len, family size, error
    rates, n_positions PER CHUNK); n_molecules/seed are overridden per
    chunk. Returns {"n_reads", "n_molecules", "seconds"}.
    """
    cfg = cfg or SimConfig()
    # monotonic, like every duration in the codebase: the "seconds"
    # field is a delta, and an NTP step mid-simulation must not skew it
    t0 = time.monotonic()
    stride = (cfg.n_positions + 1) * 1000  # chunk i owns one position range
    n_chunks = (n_molecules + chunk_molecules - 1) // chunk_molecules
    if stride * n_chunks >= 1 << 31:
        raise ValueError(
            "position space overflow: lower n_positions or chunk count "
            f"({n_chunks} chunks x stride {stride} exceeds int32 coordinates)"
        )
    header = BamHeader.synthetic(
        ref_lengths=(min(stride * n_chunks + 1000, (1 << 31) - 1),),
        sort_order="coordinate",  # chunks emit in ascending position
    )
    shell = serialize_bam(header, _empty())
    n_reads = 0
    done = 0
    with open(path, "wb") as f:
        f.write(bgzf.compress_fast(shell, eof=False))
        for ci in range(n_chunks):
            m = min(chunk_molecules, n_molecules - done)
            done += m
            ccfg = dataclasses.replace(cfg, n_molecules=m, seed=seed + ci)
            batch, _ = simulate_batch(ccfg)
            batch.pos_key = np.asarray(batch.pos_key) + ci * stride
            order = np.argsort(batch.pos_key, kind="stable")
            batch = batch.take(order)
            recs = readbatch_to_records(
                batch, duplex=cfg.duplex, paired_end=paired_end
            )
            payload = serialize_bam(header, recs)[len(shell):]
            f.write(bgzf.compress_fast(payload, eof=False))
            n_reads += len(recs)
            if progress:
                progress(ci, n_chunks, n_reads)
        f.write(bgzf.BGZF_EOF)
    return {
        "n_reads": n_reads,
        "n_molecules": n_molecules,
        "seconds": round(time.monotonic() - t0, 2),
        "bytes": os.path.getsize(path),
    }


def _empty():
    from duplexumiconsensusreads_torch.io.bam import BamRecords

    return BamRecords(
        names=[],
        flags=np.zeros(0, np.uint16),
        ref_id=np.zeros(0, np.int32),
        pos=np.zeros(0, np.int32),
        mapq=np.zeros(0, np.uint8),
        next_ref_id=np.zeros(0, np.int32),
        next_pos=np.zeros(0, np.int32),
        tlen=np.zeros(0, np.int32),
        lengths=np.zeros(0, np.int32),
        seq=np.zeros((0, 0), np.uint8),
        qual=np.zeros((0, 0), np.uint8),
        cigars=[],
        umi=[],
        aux_raw=[],
    )
