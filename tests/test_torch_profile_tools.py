"""The port's profile tools (``tools/profile_components``,
``tools/profile_phases``) run end to end on the CPU when asked, with
the JAX tools' rows, and refuse without a card otherwise."""

from __future__ import annotations

import json

import pytest
import torch


@pytest.mark.parametrize("tool, labels", [
    ("profile_components", ["full", "no_errmodel", "exact_group", "ss_mode"]),
    ("profile_phases", ["full config5 (adj+cycle)", "no error model (adj)",
                        "exact grouping + cycle", "exact, no error model"]),
])
def test_profile_tools_run_on_the_cpu_when_asked(monkeypatch, capsys, tool, labels):
    import importlib

    mod = importlib.import_module(f"duplexumiconsensusreads_torch.tools.{tool}")
    monkeypatch.setenv("DUT_PROF_READS", "1200")
    monkeypatch.setenv("DUT_PROF_REPS", "1")
    assert mod.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    res = json.loads(lines[-1])
    assert res["tool"] == tool and res["device"] == "cpu" and res["ssc_method"] == "blockseg"
    assert list(res["rows"]) == labels
    assert all(r["step_s"] > 0 and r["reads_per_sec"] > 0 for r in res["rows"].values())
    for label in labels:
        assert any(ln.startswith(label) for ln in lines), label
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
