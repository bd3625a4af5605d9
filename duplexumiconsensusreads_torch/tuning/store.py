"""Durable per-input-profile verdict store.

One JSON file (a serving spool's ``tuner_verdicts.json``): profile key
(tuning.profile_key — input identity x geometry signature) ->
TunerVerdict dict. A serving daemon consults it before an auto-ladder
job slice (a hit skips the profile pass and pins the shape) and
persists the verdict a fresh auto run resolved, so a fleet converges on
the fast shapes for its live traffic mix instead of each daemon
re-deciding per slice. The file format is the JAX package's.

Concurrency contract: same-KEY races are harmless (verdicts are a pure
function of (input bytes, signature), so two daemons racing one key
write the same value), but different-key races are not — a lock-free
read-merge-write would let the last rename discard the other daemon's
freshly profiled key. Every put therefore runs its read-merge-write
under an flock on ``<store>.lock`` (the journal's own discipline,
kernel-released on any death), staged through the durable
tmp+fsync+rename protocol (unique_tmp keeps concurrent stagings from
interleaving). A torn or garbage store is never fatal: reads degrade
to "no verdict" and the next put rewrites it whole.
"""

from __future__ import annotations

import fcntl
import json
import os
import threading

from duplexumiconsensusreads_torch.io.durable import unique_tmp, write_durable

# bounded store: verdicts are tiny, but a long-lived spool serving an
# ever-changing input mix must not grow one unbounded file (insertion
# order approximates recency — json dict order is preserved)
MAX_VERDICTS_KEPT = 512


class VerdictStore:
    """Load-on-demand, durable-on-put verdict map."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else {}
        except (OSError, ValueError):
            return {}

    def get(self, key: str) -> dict | None:
        v = self._load().get(key)
        return v if isinstance(v, dict) else None

    def put(self, key: str, verdict: dict) -> None:
        with self._lock:  # intra-process: one read-merge-write at a time
            # cross-process: flock the whole read-merge-write — two
            # daemons putting DIFFERENT keys must both survive (the
            # fleet-convergence contract), which a lock-free
            # last-rename-wins would break
            with open(self.path + ".lock", "a+") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                doc = self._load()
                doc[key] = verdict
                if len(doc) > MAX_VERDICTS_KEPT:
                    # drop the oldest entries (insertion order)
                    for stale in list(doc)[: len(doc) - MAX_VERDICTS_KEPT]:
                        del doc[stale]
                payload = json.dumps(doc, sort_keys=False).encode()
                write_durable(self.path, payload, tmp=unique_tmp(self.path))

    def __len__(self) -> int:
        return len(self._load())


def spool_store(spool_dir: str) -> VerdictStore:
    """The spool's canonical verdict store path (one per fleet)."""
    return VerdictStore(os.path.join(spool_dir, "tuner_verdicts.json"))
