"""The benchmark's own read simulator: a vectorised rewrite of the
port's ``simulate/`` (``simulator.py`` and ``bigsim.py``), owned here so
that a later change to the program cannot change the inputs it is
judged on.

The model is the port's. Molecules are simulated in blocks of
``block_molecules``; block ``k`` owns the position range
``[k * stride, (k + 1) * stride)`` with ``stride = (n_positions + 1) *
1000``, and its molecules sit at ``n_positions`` positions 1000 apart
(the position of a molecule is drawn uniformly). Each molecule has a
random sequence and a random UMI (a UMI pair of ``2 * umi_len`` codes
in duplex mode, stored canonically: top strand first), distinct within
its position. Each strand of it (both in duplex mode) is read
``geometric(1 / mean_family_size)`` times, clipped to
``[1, max_family_size]``. A read carries the molecule's bases with a
substitution at cycle ``c`` with probability ``base_error + c *
cycle_error_slope``, qualities drawn uniformly from ``[qual_lo,
qual_hi]``, and the UMI with a substitution at each code with
probability ``umi_error``. Reads are ordered by position, in random
order within a position, as the port's ``bigsim`` writes them.

The sizes are the same for every seed: the positions of the molecules,
their family sizes and which UMI codes of which reads are misread come
from a fixed seed (``SHAPE_SEED``), so that every seed makes the same
position groups, buckets and dispatch classes, and the same work. The
contents come from ``numpy.random.SeedSequence([seed, block])``: the
molecules' sequences and UMIs, the read errors and their bases, the
qualities, the misread UMI codes' values, and the order of the reads
within a position. The same seed gives the same reads, whatever the
number of threads.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# bumped whenever the reads a seed gives change: it keys the input cache
GEN_VERSION = 2
# the seed of the sizes (see the module docstring)
SHAPE_SEED = 20261018

SIM_KEYS = (
    "n_molecules", "block_molecules", "read_len", "umi_len", "n_positions",
    "mean_family_size", "max_family_size", "base_error", "cycle_error_slope",
    "umi_error", "qual_lo", "qual_hi", "duplex",
)


@dataclasses.dataclass
class Reads:
    """Simulated reads in file order (sorted by position).

    pos:       i64 (N,)   0-based coordinate on the one reference
    umi:       u8 (N, U)  canonical UMI codes (duplex: the top strand's
                          half first, whatever the read's strand)
    strand_ab: bool (N,)  True for a top-strand read
    bases:     u8 (N, L)  0..3
    quals:     u8 (N, L)  Phred
    """

    pos: np.ndarray
    umi: np.ndarray
    strand_ab: np.ndarray
    bases: np.ndarray
    quals: np.ndarray

    @property
    def n(self) -> int:
        return len(self.pos)


def _rng(seed: int, block: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), block]))


def stride(sim: dict) -> int:
    return (int(sim["n_positions"]) + 1) * 1000


def _distinct_umis(rng, pos: np.ndarray, n_codes: int) -> np.ndarray:
    """(M, n_codes) UMI codes, distinct among molecules of one position."""
    m = len(pos)
    umi = rng.integers(0, 4, size=(m, n_codes), dtype=np.uint8)
    weights = (4 ** np.arange(n_codes - 1, -1, -1)).astype(np.int64)
    for _ in range(100):
        key = pos * (4 ** n_codes) + umi.astype(np.int64) @ weights
        _, first = np.unique(key, return_index=True)
        dup = np.setdiff1d(np.arange(m), first)
        if not len(dup):
            return umi
        umi[dup] = rng.integers(0, 4, size=(len(dup), n_codes), dtype=np.uint8)
    raise RuntimeError("could not draw distinct (position, UMI) molecule keys")


def _block(sim: dict, seed: int, k: int, m: int) -> Reads:
    shape, rng = _rng(SHAPE_SEED, k), _rng(seed, k)
    l = int(sim["read_len"])
    n_codes = int(sim["umi_len"]) * (2 if sim["duplex"] else 1)
    pos_choices = (np.arange(int(sim["n_positions"]), dtype=np.int64) + 1) * 1000 + k * stride(sim)
    mol_pos = shape.choice(pos_choices, size=m)
    strands = (True, False) if sim["duplex"] else (True,)
    sizes = [np.clip(shape.geometric(1.0 / float(sim["mean_family_size"]), size=m), 1,
                     int(sim["max_family_size"])) for _ in strands]
    mol = np.concatenate([np.repeat(np.arange(m), s) for s in sizes])
    strand = np.concatenate([np.full(int(s.sum()), st) for s, st in zip(sizes, strands)])
    n = len(mol)
    uerr = shape.random((n, n_codes), dtype=np.float32) < np.float32(sim["umi_error"])

    mol_umi = _distinct_umis(rng, mol_pos, n_codes)
    mol_seq = rng.integers(0, 4, size=(m, l), dtype=np.uint8)
    cycle_err = np.clip(float(sim["base_error"])
                        + float(sim["cycle_error_slope"]) * np.arange(l), 1e-6, 0.5)
    bases = mol_seq[mol]
    err = rng.random((n, l), dtype=np.float32) < cycle_err.astype(np.float32)[None, :]
    offset = rng.integers(1, 4, size=(n, l), dtype=np.uint8)
    bases = np.where(err, (bases + offset) & 3, bases).astype(np.uint8)
    quals = rng.integers(int(sim["qual_lo"]), int(sim["qual_hi"]) + 1, size=(n, l),
                         dtype=np.uint8)
    uoff = rng.integers(1, 4, size=(n, n_codes), dtype=np.uint8)
    umi = np.where(uerr, (mol_umi[mol] + uoff) & 3, mol_umi[mol]).astype(np.uint8)

    perm = rng.permutation(n)
    order = perm[np.argsort(mol_pos[mol][perm], kind="stable")]
    return Reads(pos=mol_pos[mol][order], umi=umi[order], strand_ab=strand[order],
                 bases=bases[order], quals=quals[order])


def simulate(sim: dict, seed: int, threads: int = 4) -> Reads:
    """All reads of a configuration's ``sim`` block for ``seed``, in file
    order; blocks are drawn on ``threads`` threads (numpy's generators
    release the interpreter lock for large fills)."""
    total, per = int(sim["n_molecules"]), int(sim["block_molecules"])
    sizes = [min(per, total - s) for s in range(0, total, per)]
    if stride(sim) * len(sizes) >= 1 << 31:
        raise ValueError("position space overflows int32 coordinates")
    with ThreadPoolExecutor(max(1, threads)) as ex:
        blocks = list(ex.map(lambda km: _block(sim, seed, *km), enumerate(sizes)))
    return Reads(*(np.concatenate([getattr(b, f.name) for b in blocks])
                   for f in dataclasses.fields(Reads)))
