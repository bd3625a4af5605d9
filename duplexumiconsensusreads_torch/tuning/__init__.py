"""Profile-guided tuning: the bucket ladder's cost model and verdicts,
the ssc-method race (tuner.py) and the durable verdict store
(store.py) — the JAX package's tuning/ on torch."""

from duplexumiconsensusreads_torch.tuning.tuner import (  # noqa: F401
    MAX_RUNGS,
    MIN_RUNG,
    TunerVerdict,
    candidate_ladders,
    choose_ladder,
    group_sizes,
    ladder_cost,
    normalize_bucket_ladder,
    profile_key,
    race_ssc_methods,
    single_capacity_cost,
    validate_ladder,
)
from duplexumiconsensusreads_torch.tuning.store import VerdictStore  # noqa: F401
