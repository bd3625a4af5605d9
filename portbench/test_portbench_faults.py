"""A run with the timed path broken underneath has to come out not
correct: the look for a card skipped, the program's plain kernels on
the CPU, every cell at a tiny size (in this process, which the test
suite's own imports have given JAX, so the look for it is left to
test_portbench_layout.py's runs in processes of their own)."""

from __future__ import annotations

import pytest
import torch

CELLS = ("ctdna_duplex.resident", "amplicon_ss.resident")


def _altered(out):
    """An answer altered where it is produced: the first cycle of every
    called consensus row gets another base and quality."""
    b = out["cons_base"]
    real = b[..., 0] < 4
    out["cons_base"][..., 0] = torch.where(real, (b[..., 0] + 1) % 4, b[..., 0])
    out["cons_qual"][..., 0] = torch.where(real, out["cons_qual"][..., 0] + 3,
                                           out["cons_qual"][..., 0])
    return out


def _half_left_out(out):
    """Half of the batch left out: the second half of the buckets emit
    nothing."""
    n = out["cons_valid"].shape[0]
    out["cons_valid"][n // 2:] = False
    return out


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(tiny, cell_name):
    from portbench.lib import cell

    res, _ = cell.run_cell(tiny[0], cell_name, 2**31 + 1, 0.1, False, device="cpu",
                           check_modules=False)
    assert res["correct"] is True, res["checks"]
    assert min(m["value"] for m in res["metrics"].values()) > 0 and len(res["metrics"]) == 2


@pytest.mark.parametrize("fault", [_altered, _half_left_out])
@pytest.mark.parametrize("cell_name", CELLS)
def test_broken_step_is_not_correct(tiny, monkeypatch, cell_name, fault):
    from duplexumiconsensusreads_torch.ops import pipeline

    from portbench.lib import cell

    real = pipeline.fused_pipeline
    monkeypatch.setattr(pipeline, "fused_pipeline", lambda *a, **k: fault(real(*a, **k)))
    res, _ = cell.run_cell(tiny[0], cell_name, 2**31 + 1, 0.1, False, device="cpu",
                           check_modules=False)
    assert res["correct"] is False, res["checks"]
