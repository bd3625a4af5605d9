"""The port's bench legs on the CPU at a tiny size: the per-config,
e2e, A/B, serve, live and CPU-denominator legs report every key the
card's run reports."""

from __future__ import annotations

import json

from test_torch_bench_tiny import TINY


def test_bench_legs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The per-config, e2e, A/B, serve, live and CPU-denominator legs at a
    tiny size: every key the card's run reports, and no wire probe
    without a wire."""
    from duplexumiconsensusreads_torch import benchmark

    for k, v in dict(TINY, DUT_BENCH_PER_CONFIG="1", DUT_BENCH_CONFIG_READS="800",
                     DUT_BENCH_CONFIG_REPS="1", DUT_BENCH_TUNER="0",
                     DUT_BENCH_E2E_READS="2400", DUT_BENCH_E2E_AB="1600",
                     DUT_BENCH_CPU_E2E_READS="1600", DUT_BENCH_CPU_E2E_REPS="1",
                     DUT_BENCH_SERVE_JOBS="2", DUT_BENCH_SERVE_READS="1600",
                     DUT_BENCH_LIVE_READS="1600", DUT_BENCH_LIVE_SLAB_S="0.01",
                     DUT_BENCH_GATE="0", DUT_BENCH_CACHE=str(tmp_path / "c")).items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    benchmark.main(device="cpu")
    out = capsys.readouterr().out.splitlines()
    full = json.loads(out[-2])
    assert sorted(full["per_config"]) == [f"config{i}" for i in range(1, 6)]
    assert full["per_config"]["config4"]["capacity"] == 4096
    for key in ("e2e_reads_per_sec", "e2e_wire_floor_frac_measured", "e2e_bytes_per_read",
                "e2e_packed_speedup", "e2e_d2h_packed_speedup", "e2e_ingest_overlap",
                "cpu_e2e_reads_per_sec", "e2e_vs_cpu_e2e", "e2e_mfu", "e2e_h2d_bits_per_cycle"):
        assert key in full, key
    # the CPU denominator streams the A/B legs' input, with the same params
    # and the CPU's own fastest reduction, as every leg on the CPU does
    assert full["cpu_e2e_reads"] == full["e2e_unpacked_reads"] < full["e2e_reads"]
    assert full["e2e_ssc_method"] == full["cpu_e2e_ssc_method"] == "blockseg"
    assert full["e2e_device"] == "cpu"
    assert "wire_before_e2e" not in full and full["wire_probe_skipped"]
    assert not any(k.endswith("_error") for k in full)
    # serve_n_jobs and live_follow: the JAX legs' keys
    assert full["serve_n_jobs"] == 2 and len(full["serve_job_walls_s"]) == 2
    assert full["serve_compile_hit_rate"] == 0.5 and full["serve_amortised_speedup"] > 0
    assert full["serve_oneshot_cold_wall_s"] > 0
    assert full["live_follow_reads"] == full["cpu_e2e_reads"]
    assert full["live_snapshots_published"] == full["live_follow_chunks"] >= 1
    assert full["live_first_snapshot_latency_s"] > 0
    for key in ("live_steady_lag_chunks", "live_poll_s", "live_wait_s", "live_trace",
                "serve_wall_s", "serve_trace"):
        assert key in full, key
