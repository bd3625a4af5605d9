"""Device peak-FLOP/s table — ONE resolution for every MFU consumer.

Every MFU in the port (tools/devstat.py, the device ledger's roofline)
divides by a peak resolved here, so the denominators cannot drift
apart. The table is keyed on the CUDA device name
(``torch.cuda.get_device_name()``), matched as a case-insensitive
substring, first hit wins; ``DUT_PEAK_TFLOPS`` overrides everything.

The peak is the card's f32 rate WITHOUT the tensor cores: the
consensus reduction runs on f32 CUDA cores (the segment_gemm kernel,
and the ``matmul``/``blockseg`` products with TF32 off), so that is the
rate the pipeline's FLOPs can reach. Each entry's name says so.

The resolution NAMES its entry (``("env:...", "h100-sxm-f32", ...)``):
an MFU number without its peak provenance is unauditable, so devstat
carries the entry in ``--json``.
"""

from __future__ import annotations

import os

# f32 (non-tensor-core) peak TFLOP/s per device name, from NVIDIA's H100
# Tensor Core GPU data sheet: FP32 51 TFLOP/s for H100 PCIe and 67
# TFLOP/s for H100 SXM (the exact figures 51.2 and 66.9 are the SM count
# x FP32 lanes x boost clock behind those rounded numbers). Matching is
# case-insensitive substring over the device name, first hit wins — the
# PCIe part must precede the bare "h100" needle, which covers the SXM
# part's name ("NVIDIA H100 80GB HBM3").
PEAK_TFLOPS_TABLE = (
    ("h100-pcie-f32", ("h100 pcie",), 51.2),
    ("h100-sxm-f32", ("h100",), 66.9),
)

# an unknown device name, or no CUDA device at all (offline analysis of
# a capture), resolves to this NAMED entry rather than crashing a
# telemetry path: the card the port targets
DEFAULT_PEAK = ("default-h100-sxm-f32", 66.9)


def device_peak_flops(device_kind: str | None = None) -> tuple[float, str]:
    """Resolve (peak FLOP/s, entry name) for ``device_kind``, a CUDA
    device name.

    ``DUT_PEAK_TFLOPS`` overrides everything; ``device_kind=None`` asks
    torch for device 0's name, only when a CUDA device is available,
    and otherwise takes the default entry (offline capture analysis
    must never need a device)."""
    env = os.environ.get("DUT_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12, f"env:{env}T"
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            return DEFAULT_PEAK[1] * 1e12, DEFAULT_PEAK[0]
        device_kind = torch.cuda.get_device_name(0)
    kind = str(device_kind).lower()
    for entry, needles, tflops in PEAK_TFLOPS_TABLE:
        if any(n in kind for n in needles):
            return tflops * 1e12, entry
    return DEFAULT_PEAK[1] * 1e12, DEFAULT_PEAK[0]


def round_mfu(x: float) -> float:
    """Round an MFU ratio for JSON to 4 significant figures. Fixed
    decimal places would flush small values to zero (a CPU run scored
    against the card's peak sustains ~1e-7), and 0.0 reads as "no
    ledger" rather than "tiny machine"."""
    if not x:
        return 0.0
    from math import floor, log10

    return round(x, 3 - int(floor(log10(abs(x)))))
