"""Intentional, audited exceptions to the lint rules.

Policy (ARCHITECTURE.md "Invariants & static analysis"): an entry
suppresses ONE rule in ONE file and must say why the exception is
correct — not why the rule is inconvenient. Entries that no longer
suppress anything are reported by the CLI so the list cannot rot.
Adding an entry is a reviewed change like any other; the default
answer to a finding is to fix the code.
"""

from __future__ import annotations

from duplexumiconsensusreads_torch.analysis.engine import AllowEntry

ALLOWLIST: tuple[AllowEntry, ...] = (
    AllowEntry(
        rule="durability-protocol",
        path="duplexumiconsensusreads_torch/io/bam.py",
        reason="write_bam is the whole-file convenience writer used for "
        "simulated/test INPUTS; nothing trusts its output by existence "
        "across a crash, and the streaming executor never calls it",
    ),
    AllowEntry(
        rule="durability-protocol",
        path="duplexumiconsensusreads_torch/runtime/executor.py",
        reason="write_report emits the diagnostic RunReport JSON: it is "
        "regenerated every run and read by humans and tools immediately, "
        "never trusted by existence after a crash (and --report - means "
        "stdout, which the protocol cannot wrap)",
    ),
)
