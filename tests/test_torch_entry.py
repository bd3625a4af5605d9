"""The port's entry points (``duplexumiconsensusreads_torch/entry.py``)
against the JAX package's ``__graft_entry__.py``, on the CPU.

- ``entry(device="cpu")``: the same example bucket (every array equal,
  with the bucket axis in front) and the same step at the parity bar —
  ids, counts, depths, validity and pairing identical, bases identical
  but for strand ties, quals within 2 (a duplex qual is the sum of two
  strand quals).
- ``dryrun_multichip(n, device="cpu")`` on n logical CPU lanes against
  the JAX dry run on n virtual CPU devices (two in-process, as this
  suite's JAX runs; eight in a JAX subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``): the same
  call-set size, the same per-lane bucket and read counts, and the
  same streamed run (reads, consensus records, chunks, mesh-pad
  buckets), byte-identical to one lane on both sides.
- Without a card both raise unless the caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from duplexumiconsensusreads_torch import entry as port_entry
from duplexumiconsensusreads_torch.constants import BASE_N, NO_CALL_QUAL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the dry run's facts that do not depend on the clock
FACTS = ("n_devices", "buckets_per_device", "per_device_reads", "read_balance_max_min")
RUN_FACTS = ("n_reads", "n_consensus", "n_chunks", "mesh_pad_buckets", "byte_identical_vs_1dev")
EXACT = ("family_id", "molecule_id", "n_families", "n_molecules", "n_overflow", "cons_valid",
         "cons_depth", "depth_max", "depth_min_pos", "cons_mate", "cons_pair", "cons_end")


@pytest.fixture(scope="module")
def graft():
    sys.path.insert(0, REPO)
    import __graft_entry__

    return __graft_entry__


@pytest.fixture(scope="module")
def jax_eight_lanes():
    """The JAX dry run on eight virtual devices needs them from process
    start: a subprocess, which also reports its call-set size. Started
    by the first test of the file, so it runs while the others do."""
    script = (
        "import sys; sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})\n"
        "import __graft_entry__ as g, test_torch_entry as t\n"
        "g.dryrun_multichip(8)\n"
        "print('CALLS', t._jax_call_set(g, 8))\n"
    ).format(repo=REPO, tests=os.path.join(REPO, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_entry_runs_the_jax_example_bucket_and_spec(graft, jax_eight_lanes):
    _, jargs = graft.entry()
    fn, args = port_entry.entry(device="cpu")
    assert len(args) == len(jargs) == 7
    for a, j in zip(args, jargs):
        assert a.device.type == "cpu" and a.shape[0] == 1
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(j))
    for f in ("u_max", "f_max", "m_max"):
        assert getattr(port_entry.SPEC, f) == getattr(graft._SPEC, f)
    for f in ("grouping", "consensus"):
        assert vars(getattr(port_entry.SPEC, f)) == vars(getattr(graft._SPEC, f))


def test_entry_step_matches_jax_at_the_parity_bar(graft):
    jfn, jargs = graft.entry()
    jout = {k: np.asarray(v) for k, v in jfn(*jargs).items()}
    fn, args = port_entry.entry(device="cpu")
    out = {k: v[0].numpy() for k, v in fn(*args).items()}
    assert set(out) == set(jout)
    for k in EXACT:
        np.testing.assert_array_equal(out[k].astype(np.int64), jout[k].astype(np.int64),
                                      err_msg=k)
    assert int(out["cons_valid"].sum()) > 0
    sa, sb = out["cons_base"], jout["cons_base"]
    qa, qb = out["cons_qual"].astype(int), jout["cons_qual"].astype(int)
    tie = ((sa == BASE_N) | (sb == BASE_N)) & (qa == NO_CALL_QUAL) & (qb == NO_CALL_QUAL)
    assert not ((sa != sb) & ~tie).any()
    assert np.abs(qa - qb).max() <= 2


def test_entry_and_dryrun_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)


def _balance(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("MULTICHIP_BALANCE "))
    return json.loads(line[len("MULTICHIP_BALANCE "):])


def _jax_call_set(graft, n):
    """The JAX dry run's sharded call-set size on n devices."""
    from duplexumiconsensusreads_tpu.bucketing import build_buckets, stack_buckets
    from duplexumiconsensusreads_tpu.parallel import make_mesh, sharded_pipeline
    from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch

    batch, _ = simulate_batch(SimConfig(n_molecules=8 * n, n_positions=4 * n, duplex=True,
                                        paired_reads=True, seed=1))
    buckets = [b for b in build_buckets(batch, capacity=64, grouping=graft._SPEC.grouping)
               if b.capacity == 64 and not b.preclustered]
    out = sharded_pipeline(stack_buckets(buckets, multiple_of=n), graft._SPEC, make_mesh(n))
    return int(np.asarray(out["cons_valid"]).sum())


def _hold(ours, theirs):
    for k in FACTS:
        assert ours[k] == theirs[k], k
    for k in RUN_FACTS:
        assert ours["sharded_run"][k] == theirs["sharded_run"][k], k
    assert ours["sharded_run"]["byte_identical_vs_1dev"] is True


def test_dryrun_on_two_lanes_matches_jax_on_two_devices(graft, capsys):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graft.dryrun_multichip(2)
    theirs = _balance(buf.getvalue())
    ours = port_entry.dryrun_multichip(2, device="cpu")
    assert _balance(capsys.readouterr().out) == ours
    _hold(ours, theirs)
    assert ours["n_called"] == _jax_call_set(graft, 2)


def test_dryrun_on_eight_lanes_matches_jax_on_eight_devices(jax_eight_lanes):
    ours = port_entry.dryrun_multichip(8, device="cpu")
    out, err = jax_eight_lanes.communicate(timeout=600)
    assert jax_eight_lanes.returncode == 0, err[-3000:]
    _hold(ours, _balance(out))
    calls = next(ln for ln in out.splitlines() if ln.startswith("CALLS "))
    assert ours["n_called"] == int(calls.split()[1])
