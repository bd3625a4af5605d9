"""Registry pins for the port's knob and thread declarations
(``duplexumiconsensusreads_torch/runtime/knobs.py``), the source the
port's dutlint knob-taint and thread-confinement rules model-check the
tree against — the JAX package's ``tests/test_knobs.py``, case for case.

- Table pins: the registry's defaults, choices and surfaces are what
  the port's CLI and serve layer ship, and equal the JAX package's
  (``KNOB_TABLE`` pinned against JAX's by import).
- Closed-world pins: every ``call`` flag on the port's parser maps to a
  declared knob (or an explicit run-control flag); every thread the
  port package names maps to a ``THREAD_ROLES`` row, and so does every
  thread a real port run starts (a stream with ingest overlap, drain
  workers and a heartbeat; a follow run; a serve daemon with its
  watchdog and worker).
- The byte-identity matrix (``SCHEDULING_MATRIX``): each scheduling job
  knob names the port test proving it byte-neutral. The port's
  knob-taint coverage leg reads this file.

This file is a dutlint test anchor: it is linted like the package.
"""

from __future__ import annotations

import ast
import os
import threading

import pytest

from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.runtime import knobs as jax_knobs
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_torch.runtime import knobs
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "duplexumiconsensusreads_torch")
GP = GroupingParams(strategy="adjacency", paired=True)
CP = ConsensusParams(mode="duplex")

# the byte-identity matrix: scheduling job knob -> the port test proving
# a value change cannot change output bytes. The port's knob-taint
# coverage leg requires every scheduling job_config knob here;
# test_matrix_targets_exist keeps the values honest.
SCHEDULING_MATRIX = {
    "max_inflight": "tests/test_torch_knobs.py::test_max_inflight_ab_byte_identical",
    "drain_workers": "tests/test_torch_stream.py::test_output_bytes_are_invariant",
    "packed": "tests/test_torch_stream.py::test_output_bytes_are_invariant",
    "prefetch_depth": "tests/test_torch_stream.py::test_output_bytes_are_invariant",
    "ingest_overlap": "tests/test_torch_stream.py::test_output_bytes_are_invariant",
    "mesh": "tests/test_torch_mesh.py::test_cli_mesh_flag_streams_byte_identical",
    "bucket_ladder": "tests/test_torch_tuning.py::test_stream_ladder_byte_identity_and_jax_parity",
    "follow": "tests/test_torch_live.py::test_follow_is_byte_identical_to_the_batch_run",
    "finalize_on": "tests/test_torch_live.py::test_follow_is_byte_identical_to_the_batch_run",
    "live_poll_s": "tests/test_torch_live.py::test_follow_is_byte_identical_to_the_batch_run",
    "snapshot_chunks": "tests/test_torch_live.py::test_snapshot_cadence_does_not_move_bytes",
}

# `call` parser dests that are deliberately NOT knobs: run-control and
# service-client plumbing; ``device`` picks the card or the CPU, which
# the port's output bytes never depend on beyond the parity bar
RUN_CONTROL_DESTS = {
    "cmd", "help", "input", "output", "index",
    "checkpoint", "resume", "report", "profile", "trace", "heartbeat",
    "chaos", "n_hosts", "host_id",
    "submit", "spool", "priority", "status", "wait", "wait_timeout",
    "json", "deadline", "shards", "shard_bytes", "config_file",
    "device",
}


def _call_parser_dests():
    from duplexumiconsensusreads_torch.cli.main import build_parser

    p = build_parser()
    sub = next(a for a in p._actions if getattr(a, "choices", None) and "call" in a.choices)
    return {a.dest for a in sub.choices["call"]._actions}


class TestKnobTable:
    def test_classes_and_surfaces_are_closed(self):
        for name, k in knobs.KNOBS.items():
            assert k.knob_class in ("semantic", "scheduling"), name
            assert set(k.surfaces) <= set(knobs.SURFACES), name
        assert knobs.KNOB_TABLE == jax_knobs.KNOB_TABLE
        assert list(knobs.KNOB_TABLE) == list(jax_knobs.KNOB_TABLE)

    def test_job_defaults_pin(self):
        """The resolved job defaults, pinned literally and against the
        JAX package's: editing a KNOB_TABLE default is a behaviour
        change and must fail here."""
        assert knobs.job_config_defaults() == {
            "grouping": "exact", "mode": "ss", "error_model": "none",
            "max_hamming": 1, "count_ratio": 2, "min_reads": 1,
            "min_duplex_reads": 1, "max_qual": 90, "max_input_qual": 50,
            "min_input_qual": 0, "capacity": 2048,
            "chunk_reads": 500_000, "max_inflight": 4,
            "drain_workers": 2, "packed": "auto", "prefetch_depth": 2,
            "ingest_overlap": "auto", "mesh": "auto",
            "bucket_ladder": "off", "mate_aware": "auto", "max_reads": 0,
            "per_base_tags": False, "read_group_id": "A",
            "write_index": False, "follow": False, "finalize_on": "eof",
            "live_poll_s": 0.25, "snapshot_chunks": 0,
        } == jax_knobs.job_config_defaults()

    def test_job_choices_pin(self):
        assert knobs.job_choice_map() == {
            "grouping": {"exact", "adjacency", "cluster"},
            "mode": {"ss", "duplex"},
            "error_model": {"none", "cycle"},
            "mate_aware": {"auto", "on", "off"},
            "packed": {"auto", "byte", "off"},
            "ingest_overlap": {"auto", "on", "off"},
        } == jax_knobs.job_choice_map()

    def test_serve_layer_is_registry_derived(self):
        from duplexumiconsensusreads_torch.serve import job

        assert job.CONFIG_DEFAULTS == knobs.job_config_defaults()
        assert list(job.CONFIG_DEFAULTS) == list(knobs.job_config_defaults())
        assert job._CHOICES == knobs.job_choice_map()
        assert set(knobs.job_min_int_keys()) == {
            "capacity", "max_inflight", "drain_workers", "prefetch_depth",
        }

    def test_streaming_only_set_pin(self):
        assert knobs.streaming_only_keys() == (
            "packed", "prefetch_depth", "ingest_overlap", "mesh",
            "bucket_ladder", "follow", "finalize_on", "live_poll_s",
            "snapshot_chunks",
        ) == jax_knobs.streaming_only_keys()

    def test_every_cli_flag_maps_to_a_declared_knob(self):
        """The closed world: a `call` flag of the port is either a
        KNOB_TABLE row or an explicit RUN_CONTROL_DESTS entry, and every
        declared knob has a flag."""
        dests = _call_parser_dests()
        undeclared = dests - RUN_CONTROL_DESTS - set(knobs.KNOBS)
        assert not undeclared, f"parser flags without a KNOB_TABLE row: {sorted(undeclared)}"
        phantom = {n for n in knobs.KNOBS if n not in dests}
        assert not phantom, f"KNOB_TABLE rows with no parser flag: {sorted(phantom)}"

    def test_config_file_keys_are_exactly_the_knobs(self):
        assert knobs.config_file_keys() == frozenset(knobs.KNOBS)


def _thread_name_literals():
    """(path, name-or-prefix) for every thread the port package names:
    threading.Thread(name=...) and ThreadPoolExecutor
    thread_name_prefix=... literals and f-string heads."""
    found = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                callee = node.func
                cname = (callee.attr if isinstance(callee, ast.Attribute)
                         else callee.id if isinstance(callee, ast.Name) else "")
                if cname not in ("Thread", "ThreadPoolExecutor"):
                    continue
                for kw in node.keywords or ():
                    if kw.arg not in ("name", "thread_name_prefix"):
                        continue
                    v = kw.value
                    if isinstance(v, ast.Constant) and isinstance(v.value, str):
                        found.append((os.path.relpath(path, REPO), v.value))
                    elif isinstance(v, ast.JoinedStr) and v.values:
                        head = v.values[0]
                        if isinstance(head, ast.Constant):
                            found.append((os.path.relpath(path, REPO), str(head.value)))
    return found


def _markers():
    return sorted((str(row["marker"]) for row in knobs.THREAD_ROLES.values() if row.get("marker")),
                  key=len, reverse=True)


def _role_of(name):
    return next((m for m in _markers() if name.startswith(m)), None)


class TestThreadRoles:
    def test_rows_mirror_the_jax_table(self):
        """Same roles, modules, entries, markers and grants as the JAX
        package's table: the port starts the same threads."""
        assert knobs.THREAD_ROLES == jax_knobs.THREAD_ROLES

    def test_every_named_thread_maps_to_a_declared_role(self):
        """A Thread or pool the port names carries a declared
        THREAD_ROLES marker. The bench harness is exempt: its threads
        drive the system under test."""
        found = _thread_name_literals()
        assert {n for _, n in found} >= {"dut-xfer", "dut-drain", "dut-ingest",
                                         "dut-heartbeat", "dut-live-tail", "dut-watchdog",
                                         "dut-serve_"}
        for path, name in found:
            if os.path.basename(path) == "benchmark.py":
                continue
            assert _role_of(name), (
                f"{path}: thread name {name!r} matches no THREAD_ROLES marker")

    def test_declared_entries_exist(self):
        for role, row in knobs.THREAD_ROLES.items():
            entry = str(row["entry"])
            if not entry:
                continue
            with open(os.path.join(PKG, *str(row["module"]).split("/"))) as f:
                tree = ast.parse(f.read())
            names = {n.name for n in ast.walk(tree)
                     if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            assert entry in names, f"THREAD_ROLES[{role!r}] entry {entry}() not found"

    def test_every_thread_a_real_run_starts_maps_to_a_role(self, tmp_path, monkeypatch):
        """Record every thread started while the port runs a traced
        stream (ingest overlap on, two drain workers, a heartbeat), a
        follow pass and a serve daemon (watchdog and one worker), all on
        the CPU: each is a declared role, and each role with a marker
        was really started."""
        from duplexumiconsensusreads_torch.serve import ConsensusService, client

        started = []
        real_start = threading.Thread.start

        def recording_start(self):
            started.append(self.name)
            return real_start(self)

        path = str(tmp_path / "in.bam")
        simulated_bam(SimConfig(n_molecules=40, n_positions=6, umi_error=0.02, seed=5),
                      path=path, sort=True)
        monkeypatch.setattr(threading.Thread, "start", recording_start)
        kw = dict(capacity=128, chunk_reads=90, device="cpu")
        stream_call_consensus(path, str(tmp_path / "s.bam"), GP, CP, ingest_overlap="on",
                              drain_workers=2, trace_path=str(tmp_path / "t.jsonl"),
                              heartbeat_s=0.05, **kw)
        stream_call_consensus(path, str(tmp_path / "f.bam"), GP, CP, follow=True,
                              live_poll_s=0.01, **kw)
        spool = str(tmp_path / "spool")
        client.submit(spool, path, str(tmp_path / "j.bam"),
                      config=dict(grouping="adjacency", mode="duplex", capacity=128,
                                  chunk_reads=90))
        ConsensusService(spool, device="cpu", poll_s=0.02, heartbeat_s=0.05,
                         watchdog_s=30.0).run_until_idle()
        monkeypatch.undo()
        unmapped = sorted({n for n in started if _role_of(n) is None})
        assert not unmapped, f"threads with no THREAD_ROLES row: {unmapped}"
        assert {_role_of(n) for n in started} == set(_markers())


class TestSchedulingMatrix:
    def test_every_scheduling_job_knob_is_in_the_matrix(self):
        declared = {n for n, k in knobs.KNOBS.items()
                    if k.knob_class == "scheduling" and "job_config" in k.surfaces}
        assert declared == set(SCHEDULING_MATRIX)

    def test_matrix_targets_exist(self):
        for knob_name, target in SCHEDULING_MATRIX.items():
            rel, _, obj = target.partition("::")
            path = os.path.join(REPO, rel)
            assert os.path.exists(path), target
            with open(path) as f:
                tree = ast.parse(f.read())
            names = {n.name for n in ast.walk(tree)
                     if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
            assert obj.split("::")[0] in names, f"{knob_name}: {target} names no test in {rel}"


def test_max_inflight_ab_byte_identical(tmp_path):
    """The in-flight window depth is a scheduling knob: a serial window
    (1) and a wide one give byte-identical output."""
    path = str(tmp_path / "in.bam")
    simulated_bam(SimConfig(n_molecules=80, n_positions=8, umi_error=0.02, seed=29),
                  path=path, sort=True)
    outs = {}
    for n in (1, 4):
        out = str(tmp_path / f"mi{n}.bam")
        stream_call_consensus(path, out, GP, CP, capacity=256, chunk_reads=120,
                              max_inflight=n, device="cpu")
        with open(out, "rb") as f:
            outs[n] = f.read()
    assert outs[1] == outs[4]
