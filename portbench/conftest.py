"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a
tiny size, whose cells run the program's plain kernels on the CPU."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from portbench.lib import cell

# sizes at which a cell runs in seconds on the CPU
TINY_SIM = {"ctdna_duplex": {"n_molecules": 1200, "block_molecules": 400, "n_positions": 16},
            "amplicon_ss": {"n_molecules": 1200, "block_molecules": 600, "n_positions": 3}}
TINY_CAPACITY = 512
TINY_TRAFFIC = {"resident_chunks": {"chunk_reads": 3000},
                "resident_file": {}}


def copy_benchmark(dst: str) -> str:
    """The benchmark's files (BENCHMARK.json and portbench/, without its
    caches) copied under ``dst``; returns the copy's portbench/."""
    pkg = os.path.join(dst, "portbench")
    shutil.copytree(cell.PKG, pkg, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(cell.CHECKOUT, "BENCHMARK.json"), dst)
    return pkg


def shrink(pkg: str) -> None:
    """Cut a copy's configurations and mixes to TINY_*."""
    for name, sim in TINY_SIM.items():
        p = os.path.join(pkg, "configs", name + ".json")
        with open(p) as f:
            c = json.load(f)
        c["sim"].update(sim)
        c["capacity"] = TINY_CAPACITY
        with open(p, "w") as f:
            json.dump(c, f)
    for name, kw in TINY_TRAFFIC.items():
        p = os.path.join(pkg, "traffic", name + ".json")
        with open(p) as f:
            t = json.load(f)
        t.update(kw)
        with open(p, "w") as f:
            json.dump(t, f)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(bench, copy root): the benchmark at TINY_* sizes, with the
    harness pointed at the copy (files and caches)."""
    root = str(tmp_path)
    pkg = copy_benchmark(root)
    shrink(pkg)
    monkeypatch.setattr(cell, "PKG", pkg)
    monkeypatch.setattr(cell, "CHECKOUT", root)
    monkeypatch.setattr(cell, "CACHE", os.path.join(pkg, ".cache"))
    # this process loaded the program from the repository, not the copy
    monkeypatch.setattr(cell, "program_in_checkout", lambda: None)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return bench, root
