"""ConsensusCaller — the operator boundary of the consensus stage.

The JAX package's ops/caller.py:ConsensusCaller:

backend="cpu": the NumPy oracle with the two-pass error-model flow.
backend="cuda": the port's kernels on ``device`` (the GPU unless the
  caller asks for the CPU) with a bucket axis of one: ``ssc_kernel``
  (fit columns, then full), ``fit_cycle_cap_kernel`` /
  ``apply_cycle_cap`` between the two passes, and the gather-based
  ``duplex_kernel``. The default reduction ``method`` is
  ``"segment_gemm"``, the hand-written kernel on the card. The stages
  are composed, not fused: ops/pipeline.py is the fused path the
  executors run; this class keeps the operator-level API.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from duplexumiconsensusreads_torch.kernels.consensus import (
    SSC_METHODS,
    duplex_kernel,
    ssc_kernel,
)
from duplexumiconsensusreads_torch.kernels.error_model import (
    apply_cycle_cap,
    fit_cycle_cap_kernel,
)
from duplexumiconsensusreads_torch.oracle.consensus import call_consensus as _oracle_call
from duplexumiconsensusreads_torch.oracle.error_model import (
    apply_cycle_error_model,
    fit_cycle_error_model,
)
from duplexumiconsensusreads_torch.ops.pipeline import _pow2
from duplexumiconsensusreads_torch.runtime.executor import resolve_device
from duplexumiconsensusreads_torch.types import (
    ConsensusBatch,
    ConsensusParams,
    FamilyAssignment,
    ReadBatch,
)


class ConsensusCaller:
    def __init__(
        self,
        params: ConsensusParams | None = None,
        backend: str = "cuda",
        method: str = "segment_gemm",
        device=None,
    ):
        self.params = params or ConsensusParams()
        if backend not in ("cpu", "cuda"):
            raise ValueError(f"unknown backend {backend!r} (cuda or cpu)")
        if method not in SSC_METHODS:
            raise ValueError(f"unknown ssc method {method!r} (ported: {SSC_METHODS})")
        self.backend = backend
        self.method = method
        self.device = device

    def __call__(self, batch: ReadBatch, fams: FamilyAssignment) -> ConsensusBatch:
        if self.backend == "cpu":
            return self._call_cpu(batch, fams)
        return self._call_cuda(batch, fams)

    def _call_cpu(self, batch, fams):
        p = self.params
        if p.error_model == "cycle":
            ss = _oracle_call(
                batch,
                fams,
                dataclasses.replace(p, mode="single_strand", error_model=None),
            )
            cap = fit_cycle_error_model(batch, fams, ss)
            q2 = apply_cycle_error_model(np.asarray(batch.quals), cap)
            return _oracle_call(batch, fams, p, quals_override=q2)
        return _oracle_call(batch, fams, p)

    def _call_cuda(self, batch, fams):
        p = self.params
        if p.mode not in ("single_strand", "duplex"):
            raise ValueError(f"unknown consensus mode {p.mode!r}")
        dev = resolve_device(self.device)

        def put(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a)[None])
            return t.to(dev, dtype) if dtype is not None else t.to(dev)

        bases = put(np.asarray(batch.bases))
        quals = put(np.asarray(batch.quals))
        valid = put(np.asarray(batch.valid, bool))
        fam = put(np.asarray(fams.family_id), torch.int32)
        # family axis sized from the family count known at this boundary,
        # rounded to a power of two (n_reads would make it quadratic)
        f_max = _pow2(int(fams.n_families))
        kw = dict(f_max=f_max, min_reads=p.min_reads, max_qual=p.max_qual,
                  max_input_qual=p.max_input_qual, min_input_qual=p.min_input_qual,
                  method=self.method)
        quals_eff = quals
        if p.error_model == "cycle":
            cb0, _, fv0 = ssc_kernel(bases, quals, fam, valid, columns="fit", **kw)
            cap = fit_cycle_cap_kernel(bases, fam, valid, cb0, fv0)
            quals_eff = apply_cycle_cap(quals, cap)
        cb, cq, dep, _, fv = ssc_kernel(bases, quals_eff, fam, valid, **kw)
        n = int(fams.n_families)
        if p.mode == "duplex":
            cb, cq, dep, fv = duplex_kernel(
                cb, cq, dep, fv, fam,
                put(np.asarray(fams.molecule_id), torch.int32),
                put(np.asarray(batch.strand_ab, bool)),
                valid,
                m_max=_pow2(int(fams.n_molecules)),
                min_duplex_reads=p.min_duplex_reads,
                max_qual=p.max_qual,
            )
            n = int(fams.n_molecules)
        return ConsensusBatch(
            bases=cb[0, :n].cpu().numpy().astype(np.uint8),
            quals=cq[0, :n].cpu().numpy().astype(np.uint8),
            depth=dep[0, :n].cpu().numpy(),
            valid=fv[0, :n].cpu().numpy(),
        )
