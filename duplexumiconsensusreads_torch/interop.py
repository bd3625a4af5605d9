"""Plain values in, port objects out: the seam between host numpy state
(the stacked bucket dicts that ``stack_buckets``/``pack_stacked``
produce, in this package or the JAX package alike) and the port's
device tensors and specs. Nothing here imports the JAX package: a
spec crosses as its field values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from duplexumiconsensusreads_torch.ops.pipeline import PipelineSpec
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

# the stacked arrays fused_pipeline consumes, in argument order
ARRAY_KEYS = ("pos", "umi", "strand_ab", "frag_end", "valid", "bases", "quals")


def stacked_from_numpy(
    stacked: dict, device, pin: bool = False, keep: list | None = None
) -> dict:
    """numpy stacked bucket arrays -> tensors on ``device`` (ARRAY_KEYS
    only; read_index and n_real_buckets stay on the host). u16 lanes
    (the packed pos) cross as their int16 bit pattern, which the
    pipeline's decode widens back. ``pin=True`` stages each array in
    pinned host memory and copies without blocking, on the current
    stream; ``keep`` collects the pinned staging tensors, for a caller
    that holds them until its copies are known to be done."""
    device = torch.device(device)
    out = {}
    for k in ARRAY_KEYS:
        a = np.ascontiguousarray(stacked[k])
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        t = torch.from_numpy(a)
        if pin and device.type == "cuda":
            t = t.pin_memory()
            if keep is not None:
                keep.append(t)
        out[k] = t.to(device, non_blocking=pin)
    return out


# JAX method names -> the port's (the Pallas kernel's counterpart is
# segment_gemm; "segment" is the plain reduction on both sides)
_METHOD_NAMES = {
    "matmul": "matmul",
    "segment": "segment",
    "blockseg": "blockseg",
    "runsum": "runsum",
    "pallas": "segment_gemm",
    "pallas_interpret": "segment_gemm",
    "segment_gemm": "segment_gemm",
}

# JAX spec fields the port does not carry, each with the only value it
# takes
_FIXED_FIELDS = {"fit_impl": "gather"}


def _params(cls, value):
    if isinstance(value, cls):
        return value
    if dataclasses.is_dataclass(value):
        value = {f.name: getattr(value, f.name) for f in dataclasses.fields(value)}
    return cls(**value)


def spec_from_fields(**fields) -> PipelineSpec:
    """The port's PipelineSpec from the field values of a JAX
    PipelineSpec (grouping/consensus may be dataclass instances of
    either package or plain dicts). Raises on a field value the port
    does not implement (the counts fit) or that is inconsistent (a
    sub-byte width without its dictionary)."""
    fields = dict(fields)
    for k, implied in _FIXED_FIELDS.items():
        v = fields.pop(k, implied)
        if v != implied:
            raise ValueError(f"{k}={v!r} is not ported (only {implied!r})")
    method = fields.get("ssc_method", "segment_gemm")
    if method not in _METHOD_NAMES:
        raise ValueError(f"ssc_method {method!r} is not ported")
    fields["ssc_method"] = _METHOD_NAMES[method]
    if "grouping" in fields:
        fields["grouping"] = _params(GroupingParams, fields["grouping"])
    if "consensus" in fields:
        fields["consensus"] = _params(ConsensusParams, fields["consensus"])
    return PipelineSpec(**fields)
