"""duplexumiconsensusreads_torch — the duplex UMI consensus caller on
PyTorch and CUDA (NVIDIA Hopper), beside the JAX package
``duplexumiconsensusreads_tpu``, which stays the reference.

Module paths mirror the JAX package so each counterpart is found at the
same place:
  constants, types, utils/   shared conventions (copied, framework-free)
  simulate/, oracle/, io/,   host side: simulator, grouping oracle,
  bucketing/                 BGZF/BAM codec, bucketing (copied)
  kernels/                   batched torch kernels; segment_gemm is a
                             hand-written CUDA kernel (csrc/)
  ops/pipeline.py            the fused pipeline, batched over buckets
  runtime/executor.py        the whole-file executor (BAM in -> BAM out)
  cli/                       ``python -m duplexumiconsensusreads_torch call``
  interop.py                 numpy stacked buckets / spec fields -> port

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``. Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"

from duplexumiconsensusreads_torch.types import (  # noqa: F401
    ConsensusBatch,
    ConsensusParams,
    FamilyAssignment,
    GroupingParams,
    ReadBatch,
)
