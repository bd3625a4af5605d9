"""The port's tiny bench in a subprocess on the CPU: the JAX bench's
stdout contract (tests/test_bench_history.py) through the port's CLI."""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(DUT_BENCH_READS="2500", DUT_BENCH_CPU_SAMPLE="150", DUT_BENCH_REPS="1",
            DUT_BENCH_VEC_REPS="1", DUT_BENCH_VEC_SAMPLE="2000", DUT_BENCH_PER_CONFIG="0",
            DUT_BENCH_E2E_READS="0")


def test_tiny_bench_final_stdout_line_is_compact_json(tmp_path):
    """The JAX bench's stdout contract (tests/test_bench_history.py),
    through the port's CLI on the CPU: the last line parses, carries
    the headline and fits the tail window; the full result rides the
    line above and is mirrored beside the cache."""
    env = dict(os.environ, **TINY, DUT_BENCH_CACHE=str(tmp_path / "cache"),
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    r = subprocess.run(
        [sys.executable, "-m", "duplexumiconsensusreads_torch", "bench", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=400,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) >= 2
    compact = json.loads(lines[-1])
    assert compact["metric"] == "reads_per_sec_duplex_consensus"
    assert compact["value"] > 0 and compact["unit"] == "reads/s"
    assert len(lines[-1]) < 1400
    full = json.loads(lines[-2])
    assert full["value"] == compact["value"] and "vs_baseline" in full
    assert compact.get("full") and os.path.exists(compact["full"])
    assert json.load(open(compact["full"])) == full
    # no card: the MFU is scored against the table's named default
    assert full["peak_entry"] == "default-h100-sxm-f32" and full["device"] == "cpu"
    assert full["ssc_method"] == full["vec_cpu_ssc_method"] == "blockseg"
    # the e2e legs are off here, the mesh A/B with them (as in the JAX
    # bench); no leg is reported as skipped for want of a port
    assert not [k for k in full if k.startswith("e2e_mesh")]
    assert not [k for k in full if k.endswith("_skipped") and k != "wire_probe_skipped"]
    assert not [k for k in full if k.startswith("serve_") and k.endswith("_skipped")]
    # the serve and live legs ride the e2e phase, which TINY turns off
    assert "live_follow_skipped" not in full and "serve_n_jobs_skipped" not in full
    assert "live_follow_reads" not in full and "serve_n_jobs" not in full
    assert "e2e_reads_per_sec" not in full and "tuner_ladder" in full
    assert "consensus_error_rate=" in r.stderr
