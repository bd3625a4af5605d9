"""The port's multi-host call (parallel/distributed.py on a
torch.distributed TCPStore, and the CLI's --n-hosts/--host-id/--index)
against the JAX package's.

- Partitioning: ``host_tile_range`` and ``host_input_range`` equal the
  JAX functions on a table of tile counts, host counts and indexes,
  including the record-less file, an idle host and a giant same-key run.
- In process: ``multihost_call`` for n_hosts in {1, 2, 3, 5}
  concatenates to the one-host config3 stream record for record (names
  aside: each host tags its own); config5, whose per-bucket cycle fit
  moves with a host's key range, is held port-against-JAX host by host
  at the parity bar (quals within 2, bases identical but at strand ties).
- The store: a single process needs none; a host that cannot reach its
  store raises; a barrier that one host never reaches raises
  ``TimeoutError`` naming it within its timeout; an address without a
  rank, or a world without an address, is refused.
- Subprocess hosts, concurrently on one TCPStore with ``--device cpu``:
  with no .dlix at the start both report a 2-process runtime, exactly
  one index is written (bytes equal the ``index`` subcommand's) and the
  outputs concatenate to the whole-file result; SIGKILLed once its
  manifest holds two done chunks, host 1 resumes (alone: host 0 has
  finished and its store is gone) skipping exactly those chunks, and
  the concatenation is unchanged.
- The CLI's refusals of --n-hosts use the JAX words.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.io.index import BamLinearIndex as JaxIndex
from duplexumiconsensusreads_tpu.parallel.distributed import (
    host_input_range as jax_host_input_range,
)
from duplexumiconsensusreads_tpu.parallel.distributed import (
    host_tile_range as jax_host_tile_range,
)
from duplexumiconsensusreads_tpu.parallel.distributed import (
    multihost_call as jax_multihost_call,
)
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.cli.main import params_for
from duplexumiconsensusreads_torch.io import read_bam
from duplexumiconsensusreads_torch.io.index import BamLinearIndex, build_linear_index
from duplexumiconsensusreads_torch.parallel import distributed
from duplexumiconsensusreads_torch.parallel.distributed import (
    coordination_barrier,
    host_input_range,
    host_tile_range,
    init_distributed,
    multihost_call,
    shutdown_distributed,
)
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

from test_torch_stream import _compare

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the host subprocesses keep to two threads each: the suite runs beside
# other files' subprocesses on a shared host
ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
for _k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
    ENV.pop(_k, None)
CLI = [sys.executable, "-m", "duplexumiconsensusreads_torch"]


@pytest.fixture(autouse=True)
def _single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    yield
    shutdown_distributed()


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_distributed")
    out = {}
    for name, (n_mol, n_pos, read_len) in {"small": (120, 12, 40),
                                           "big": (400, 40, 40)}.items():
        p = str(d / f"{name}.bam")
        simulated_bam(SimConfig(n_molecules=n_mol, n_positions=n_pos, read_len=read_len,
                                umi_error=0.02, duplex=True, seed=13), path=p, sort=True)
        out[name] = p
    return d, out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---- partitioning

@pytest.mark.parametrize("n_tiles, n_hosts", [
    (0, 1), (0, 3), (1, 1), (1, 2), (5, 5), (7, 3), (10, 4), (10, 3), (3, 8), (100, 7),
])
def test_host_tile_range_equals_jax(n_tiles, n_hosts):
    seen = []
    for pid in range(n_hosts):
        ours = host_tile_range(n_tiles, process_id=pid, num_processes=n_hosts)
        assert ours == jax_host_tile_range(n_tiles, process_id=pid, num_processes=n_hosts)
        seen.extend(ours)
    assert sorted(seen) == list(range(n_tiles))


def _index_pair(pos_key):
    pos_key = np.asarray(pos_key, np.int64)
    arrays = dict(pos_key=pos_key, coffset=np.arange(len(pos_key), dtype=np.int64) * 100,
                  uoffset=np.arange(len(pos_key), dtype=np.int64) % 7)
    kw = dict(every=10, n_records=10 * len(pos_key))
    return BamLinearIndex(**arrays, **kw), JaxIndex(**arrays, **kw)


@pytest.mark.parametrize("name, pos_key, n_hosts", [
    ("record-less", [], 3),
    ("one tile", [5], 2),  # host 1 idle
    ("even", [1, 4, 9, 12, 20, 33], 3),
    ("more hosts than tiles", [2, 8, 9], 5),
    ("giant same-key run", [3, 7, 7, 7, 7, 7, 7, 7, 7, 8], 3),
    ("all one key", [4, 4, 4, 4], 2),
])
def test_host_input_range_equals_jax(name, pos_key, n_hosts):
    ours_idx, jax_idx = _index_pair(pos_key)
    got = [host_input_range(ours_idx, process_id=p, num_processes=n_hosts)
           for p in range(n_hosts)]
    want = [jax_host_input_range(jax_idx, process_id=p, num_processes=n_hosts)
            for p in range(n_hosts)]
    assert got == want
    if name in ("one tile", "giant same-key run", "more hosts than tiles"):
        assert None in got  # an idle host


@pytest.mark.parametrize("every, n_hosts", [(17, 2), (60, 3), (97, 5)])
def test_host_input_range_on_a_real_index_equals_jax(bams, every, n_hosts):
    from duplexumiconsensusreads_tpu.io.index import build_linear_index as jax_build

    _, paths = bams
    ours, theirs = build_linear_index(paths["small"], every), jax_build(paths["small"], every)
    for p in range(n_hosts):
        assert host_input_range(ours, p, n_hosts) == jax_host_input_range(theirs, p, n_hosts)


# ---- in-process multi-host call

KW = dict(capacity=128, chunk_reads=100)


def _records(paths):
    return [read_bam(p)[1] for p in paths]


def _assert_concat_equals(parts, whole_path):
    _, whole = read_bam(whole_path)
    cat = _records(parts)
    assert sum(len(r) for r in cat) == len(whole) > 0
    for f in ("pos", "seq", "qual", "flags"):
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(getattr(r, f)) for r in cat]),
            np.asarray(getattr(whole, f)), err_msg=f)
    assert [u for r in cat for u in r.umi] == list(whole.umi)


@pytest.fixture(scope="module")
def whole_config3(bams):
    d, paths = bams
    gp, cp, _ = params_for("config3")
    out = str(d / "whole3.bam")
    stream_call_consensus(paths["small"], out, gp, cp, device="cpu", **KW)
    return out


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
def test_multihost_call_concatenates_to_the_one_host_stream(bams, whole_config3, tmp_path,
                                                            n_hosts):
    _, paths = bams
    gp, cp, _ = params_for("config3")
    parts = []
    for pid in range(n_hosts):
        out = str(tmp_path / f"host{pid}.bam")
        rep = multihost_call(paths["small"], out, gp, cp, index_path=str(tmp_path / "i.dlix"),
                             process_id=pid, num_processes=n_hosts, index_every=60,
                             device="cpu", **KW)
        if rep is not None:
            parts.append(out)
            names = read_bam(out)[1].names
            assert all(n.startswith(f"consh{pid}_") for n in names)
    assert len(parts) >= min(n_hosts, 2)
    _assert_concat_equals(parts, whole_config3)


def test_config5_hosts_match_jax_host_by_host(bams, tmp_path):
    """A host's key range regroups buckets, so config5's per-bucket cycle
    fit moves quals against the one-host run; host by host the port
    computes what the JAX package computes."""
    _, paths = bams
    gp, cp, _ = params_for("config5")
    for pid in range(2):
        # capacity 256 puts several position groups in a bucket, so the
        # hosts' caps differ from the one-host run's (ROADMAP Faults 11)
        kw = dict(index_every=100, process_id=pid, num_processes=2, capacity=256,
                  chunk_reads=150)
        jout, tout = str(tmp_path / f"j{pid}.bam"), str(tmp_path / f"t{pid}.bam")
        jrep = jax_multihost_call(paths["big"], jout, JG(**vars(gp)), JC(**vars(cp)),
                                  index_path=str(tmp_path / "j.dlix"), n_devices=1, **kw)
        trep = multihost_call(paths["big"], tout, gp, cp,
                              index_path=str(tmp_path / "t.dlix"), device="cpu", **kw)
        assert (jrep is None) == (trep is None) is False
        assert trep.n_consensus == jrep.n_consensus and trep.n_chunks == jrep.n_chunks
        _compare(jax_read_bam(jout)[1], read_bam(tout)[1], duplex=True)


# ---- the store

def test_single_process_needs_no_store():
    info = init_distributed(device="cpu")
    assert info == {"process_id": 0, "num_processes": 1, "local_devices": 1,
                    "global_devices": 1}
    assert coordination_barrier("nobody") is False
    assert distributed._STATE is None


def test_unreachable_store_raises():
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="cannot reach the coordination store"):
        init_distributed(f"127.0.0.1:{_free_port()}", num_processes=2, process_id=1,
                         device="cpu", timeout_s=1.0)
    assert time.monotonic() - t0 < 30
    assert distributed._STATE is None


@pytest.mark.parametrize("env, match", [
    ({"WORLD_SIZE": "2", "RANK": "1"}, "needs the coordination store's address"),
    ({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "WORLD_SIZE": "2"}, "world size and rank"),
    ({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "WORLD_SIZE": "2", "RANK": "2"},
     "outside"),
])
def test_incomplete_configuration_is_refused(monkeypatch, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        init_distributed(device="cpu")


HOST1 = """
import sys, time
from duplexumiconsensusreads_torch.parallel.distributed import init_distributed
info = init_distributed(sys.argv[1], 2, 1, device="cpu", timeout_s=60)
print(info["num_processes"], info["global_devices"], flush=True)
time.sleep(float(sys.argv[2]))
"""


def test_unreached_barrier_raises_timeout_naming_it():
    addr = f"127.0.0.1:{_free_port()}"
    host1 = subprocess.Popen([sys.executable, "-c", HOST1, addr, "20"], env=ENV,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        info = init_distributed(addr, num_processes=2, process_id=0, device="cpu",
                                timeout_s=60)
        assert info == {"process_id": 0, "num_processes": 2, "local_devices": 1,
                        "global_devices": 2}
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="'duplexumi:never' timed out after 500 ms"):
            coordination_barrier("duplexumi:never", timeout_ms=500)
        assert time.monotonic() - t0 < 10
    finally:
        host1.kill()
        out, _ = host1.communicate(timeout=30)
    assert out.split()[:2] == ["2", "2"]


# ---- subprocess hosts on one store

def _host_cmd(in_path, out, pid, chunk_reads, extra=()):
    return CLI + ["call", in_path, "-o", out, "--config", "config3", "--capacity", "128",
                  "--chunk-reads", str(chunk_reads), "--n-hosts", "2", "--host-id", str(pid),
                  "--device", "cpu", *extra]


def _store_env(port, pid):
    return dict(ENV, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                RANK=str(pid))


def test_concurrent_hosts_on_one_store_elect_one_index_writer(bams, whole_config3, tmp_path):
    d, paths = bams
    in_path = str(tmp_path / "in.bam")
    with open(paths["small"], "rb") as src, open(in_path, "wb") as dst:
        dst.write(src.read())
    assert not os.path.exists(in_path + ".dlix")
    out = str(tmp_path / "mh.bam")
    port = _free_port()
    procs = [subprocess.Popen(_host_cmd(in_path, out, pid, 100), env=_store_env(port, pid),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=240)
        errs.append(err)
        assert p.returncode == 0, err[-3000:]
    for pid, err in enumerate(errs):
        assert f"distributed runtime: process {pid}/2, 1 local / 2 global devices" in err
    assert [n for n in os.listdir(tmp_path) if ".dlix" in n] == ["in.bam.dlix"]
    ref = str(tmp_path / "ref.dlix")
    assert cli_main(["index", in_path, "-o", ref]) == 0
    with open(ref, "rb") as a, open(in_path + ".dlix", "rb") as b:
        assert a.read() == b.read()
    parts = [str(tmp_path / f"mh.host{pid}.bam") for pid in range(2)]
    _assert_concat_equals([p for p in parts if os.path.exists(p)], whole_config3)


def test_concurrent_hosts_kill_and_resume(bams, tmp_path):
    d, paths = bams
    in_path = paths["big"]
    if not os.path.exists(in_path + ".dlix"):
        build_linear_index(in_path, every=100).save(in_path + ".dlix")
    gp, cp, _ = params_for("config3")
    whole = str(tmp_path / "whole.bam")
    stream_call_consensus(in_path, whole, gp, cp, device="cpu", capacity=128, chunk_reads=60)

    out, ckpt = str(tmp_path / "mh.bam"), str(tmp_path / "ckpt")
    port = _free_port()
    extra = ["--checkpoint", ckpt]
    p0, p1 = (subprocess.Popen(_host_cmd(in_path, out, pid, 60, extra),
                               env=_store_env(port, pid), stdout=subprocess.DEVNULL,
                               stderr=subprocess.PIPE, text=True)
              for pid in range(2))
    ckpt1 = ckpt + ".host1"
    deadline = time.monotonic() + 240
    killed = False
    try:
        while time.monotonic() < deadline and p1.poll() is None:
            try:
                with open(ckpt1) as f:
                    done = json.load(f).get("done", {})
            except (OSError, ValueError):
                done = {}
            if len(done) >= 2:
                p1.send_signal(signal.SIGKILL)
                killed = True
                break
            time.sleep(0.02)
        p1.communicate(timeout=60)
        _, err0 = p0.communicate(timeout=240)
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert p0.returncode == 0, err0[-3000:]
    with open(ckpt1) as f:
        done_before = json.load(f).get("done", {})
    assert len(done_before) >= 2
    report = str(tmp_path / "resume_report.json")
    r = subprocess.run(_host_cmd(in_path, out, 1, 60, extra + ["--resume", "--report", report]),
                       env=ENV, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "distributed runtime" not in r.stderr  # alone: the emulation
    with open(report + ".host1") as f:
        rep = json.load(f)
    assert rep["n_chunks_skipped"] == len(done_before)
    if killed:
        assert rep["n_chunks"] > rep["n_chunks_skipped"]
    _assert_concat_equals([str(tmp_path / f"mh.host{pid}.bam") for pid in range(2)], whole)


# ---- the CLI's words

def _exit_message(fn, argv) -> str:
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return str(e.value)


@pytest.mark.parametrize("extra", [
    ["--n-hosts", "2", "--host-id", "0", "--submit", "--spool", "SPOOL"],
    ["--n-hosts", "2", "--host-id", "0", "--submit", "--spool", "SPOOL",
     "--chunk-reads", "100"],
    ["--n-hosts", "2", "--host-id", "0", "--ref-projected"],
    ["--n-hosts", "2", "--host-id", "0", "--umi-whitelist", "WL"],
    ["--n-hosts", "2", "--chunk-reads", "100"],
    ["--n-hosts", "2", "--host-id", "1"],
], ids=lambda v: " ".join(v[4:]) or "no host id")
def test_multihost_refusals_use_the_jax_words(bams, tmp_path, extra):
    _, paths = bams
    wl = tmp_path / "wl.txt"
    wl.write_text("ACGTAC\n")
    extra = [str(tmp_path / "spool") if a == "SPOOL" else str(wl) if a == "WL" else a
             for a in extra]
    out = str(tmp_path / "o.bam")
    argv = ["call", paths["small"], "-o", out, "--config", "config3", *extra]
    theirs = _exit_message(jax_main, argv)
    device = [] if "--submit" in extra else ["--device", "cpu"]
    assert _exit_message(cli_main, argv + device) == theirs != ""
    assert not os.path.exists(out) and not os.path.exists(str(tmp_path / "o.host0.bam"))
