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


def stacked_from_numpy(stacked: dict, device, out: dict | None = None) -> dict:
    """numpy stacked bucket arrays -> tensors on ``device`` (ARRAY_KEYS
    only; read_index and n_real_buckets stay on the host). u16 lanes
    (the packed pos) cross as their int16 bit pattern, which the
    pipeline's decode widens back. A value that is already a tensor (a
    lane's pinned staging buffer, parallel/sharded.py:stage_lanes, whose
    caller keeps and fences it) is copied as it is, without blocking,
    on the current stream. ``out`` (a dict of device tensors of the
    arrays' shapes and dtypes: a step graph's static inputs,
    runtime/graphs.py:bound_inputs) receives the copies instead of new
    tensors."""
    device = torch.device(device)
    res = {}
    for k in ARRAY_KEYS:
        a = stacked[k]
        staged = isinstance(a, torch.Tensor) and device.type == "cuda"
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a.view(np.int16) if a.dtype == np.uint16
                                                      else a))
        if out is not None:
            res[k] = out[k].copy_(a, non_blocking=staged)
        else:
            res[k] = a.to(device, non_blocking=staged)
    return res


def host_shapes(stacked: dict) -> tuple:
    """(shape, torch dtype) of each tensor stacked_from_numpy makes from
    ``stacked`` (without making them), in ARRAY_KEYS order."""
    out = []
    for k in ARRAY_KEYS:
        if isinstance(stacked[k], torch.Tensor):
            out.append((tuple(stacked[k].shape), stacked[k].dtype))
            continue
        dt = np.dtype(stacked[k].dtype)
        out.append((tuple(stacked[k].shape),
                    TORCH_DTYPES[np.dtype(np.int16) if dt == np.uint16 else dt]))
    return tuple(out)


# numpy dtypes of the stacked arrays -> torch's
TORCH_DTYPES = {np.dtype(d): torch.from_numpy(np.empty(0, d)).dtype
                for d in (np.bool_, np.uint8, np.int8, np.int16, np.int32, np.int64,
                          np.float32)}


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
    does not implement (an unknown ssc method or fit formulation) or
    that is inconsistent (a sub-byte width without its dictionary)."""
    fields = dict(fields)
    method = fields.get("ssc_method", "segment_gemm")
    if method not in _METHOD_NAMES:
        raise ValueError(f"ssc_method {method!r} is not ported")
    fields["ssc_method"] = _METHOD_NAMES[method]
    if "grouping" in fields:
        fields["grouping"] = _params(GroupingParams, fields["grouping"])
    if "consensus" in fields:
        fields["consensus"] = _params(ConsensusParams, fields["consensus"])
    return PipelineSpec(**fields)
