"""The torch port's whole-file call against the JAX package's.

The same simulated BAM goes through the JAX ``call_consensus_file``
(backend "tpu", run on the CPU here) and the port's
``call_consensus_file(device="cpu")``; the consensus BAMs must agree
record by record — names, flags, positions, CIGARs, bases and every
aux tag (RX, cD, cM, RG) identical, quals within one per strand (two
for a duplex qual). The output headers differ only in the @PG program
name. Also: the CLI, the report, and the device rules.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.runtime.executor import call_consensus_file as jax_call
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC, GroupingParams as JG
from duplexumiconsensusreads_torch.cli.main import params_for
from duplexumiconsensusreads_torch.io import read_bam
from duplexumiconsensusreads_torch.runtime import executor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_exec")
    out = {}
    for name, paired in (("single", False), ("mates", True)):
        p = str(d / f"{name}.bam")
        simulated_bam(
            SimConfig(n_molecules=120, read_len=40, n_positions=8, umi_error=0.02,
                      cycle_error_slope=0.003, duplex=True, paired_reads=paired,
                      indel_error=0.02, seed=11),
            path=p, sort=True,
        )
        out[name] = p
    return d, out


def _compare(a, b, qual_tol):
    assert len(a) == len(b) > 0
    for f in ("names", "flags", "ref_id", "pos", "mapq", "next_ref_id", "next_pos",
              "tlen", "lengths", "seq"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f)
    assert list(a.cigars) == list(b.cigars)
    assert list(a.aux_raw) == list(b.aux_raw)
    dq = np.abs(np.asarray(a.qual).astype(int) - np.asarray(b.qual).astype(int))
    assert dq.max() <= qual_tol


@pytest.mark.parametrize("config, which", [
    ("config5", "single"),
    ("config5", "mates"),
    ("config1", "single"),
])
def test_call_consensus_file_matches_jax_record_by_record(bams, config, which):
    d, paths = bams
    gp, cp, _ = params_for(config)
    jout, tout = str(d / f"j_{config}_{which}.bam"), str(d / f"t_{config}_{which}.bam")
    jrep = jax_call(paths[which], jout, JG(**vars(gp)), JC(**vars(cp)), capacity=128)
    trep = executor.call_consensus_file(paths[which], tout, gp, cp, capacity=128, device="cpu")
    for f in ("n_records", "n_valid_reads", "n_buckets", "n_families", "n_molecules",
              "n_consensus", "n_consensus_pairs", "mate_aware", "n_size_classes"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.mate_aware == (which == "mates")
    jh, jr = jax_read_bam(jout)
    th, tr = read_bam(tout)
    _compare(jr, tr, qual_tol=2 if cp.mode == "duplex" else 1)
    assert th.text.replace("duplexumiconsensusreads_torch", "duplexumiconsensusreads_tpu") == jh.text


def test_report_is_written(bams):
    d, paths = bams
    gp, cp, _ = params_for("config3")
    rp = str(d / "r.json")
    executor.call_consensus_file(paths["single"], str(d / "r.bam"), gp, cp,
                                 capacity=128, device="cpu", report_path=rp)
    rep = json.load(open(rp))
    assert rep["device"] == "cpu" and rep["n_consensus"] > 0
    assert {"read_input", "bucketing", "device_dispatch", "write_output"} <= set(rep["seconds"])


def test_cli_call_runs_and_refuses_unported_flags(bams):
    d, paths = bams
    env = dict(os.environ, PYTHONPATH=REPO)
    out = str(d / "cli.bam")
    r = subprocess.run(
        [sys.executable, "-m", "duplexumiconsensusreads_torch", "call", paths["single"],
         "-o", out, "--config", "config5", "--capacity", "128", "--device", "cpu",
         "--report", "-"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["n_consensus"] == len(read_bam(out)[1]) > 0
    r = subprocess.run(
        [sys.executable, "-m", "duplexumiconsensusreads_torch", "call", paths["single"],
         "-o", out, "--config", "config5", "--follow"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert r.returncode != 0 and "not supported by the torch port" in r.stderr


def test_cuda_default_raises_without_a_card(bams, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, paths = bams
    gp, cp, _ = params_for("config5")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        executor.call_consensus_file(paths["single"], str(d / "x.bam"), gp, cp)
    with pytest.raises(ValueError):
        executor.resolve_device("mps")


def test_unported_input_options_raise(bams):
    from duplexumiconsensusreads_torch.io import load_input

    d, paths = bams
    with pytest.raises(NotImplementedError):
        load_input(paths["single"], duplex=True, ref_projected=True)
    with pytest.raises(NotImplementedError):
        load_input(paths["single"], duplex=True, umi_whitelist=np.zeros((1, 12), np.uint8))


def test_empty_input_writes_an_empty_bam(tmp_path):
    from duplexumiconsensusreads_torch.io import BamHeader, write_bam
    from duplexumiconsensusreads_torch.simulate.bigsim import _empty

    inp = str(tmp_path / "empty.bam")
    write_bam(inp, BamHeader.synthetic(), _empty())
    gp, cp, _ = params_for("config5")
    rep = executor.call_consensus_file(inp, str(tmp_path / "o.bam"), gp, cp, device="cpu")
    assert rep.n_consensus == 0 and len(read_bam(str(tmp_path / "o.bam"))[1]) == 0
