"""dutlint: AST-based invariant linter for this codebase.

The paper's core promise — byte-identical duplex consensus output that
survives crashes, faults, and resume — rests on cross-module invariants
that no general-purpose linter knows about: every durable write goes
through ``io.durable``, every phase clock is ``time.monotonic()``,
every ``fault_point`` site is registered and chaos-covered, trace stage
names equal RunReport phase keys, telemetry hooks stay zero-cost when
off. As the streaming executor grew, these conventions came to
span too many files to police by review alone; this package encodes
them as executable rules.

Layout:
  engine.py  corpus loading (path -> ast), the rule registry, the
             allowlist, and ``run_lint`` — the one entry point
  rules.py   the project's invariant rules (registered on import)
  allowlist.py  intentional, reasoned exceptions (path + rule + reason)
  cli.py     ``duplexumiconsensusreads_torch/tools/dutlint.py``

This is the JAX package's linter over the port: the same 16 rules with
the same ids and messages, anchored on the port's test suites
(``tests/test_torch_{chaos,telemetry,serve,knobs}.py``), reading
``torch.cuda.*`` and the port's dispatch and kernel entry points as
device calls. Run ``python duplexumiconsensusreads_torch/tools/dutlint.py``
(exit 1 on any non-allowlisted finding); ``tests/test_torch_lint.py``
runs the same engine in-process, plus per-rule firing/passing
fixtures held against the JAX engine's findings.
"""

from duplexumiconsensusreads_torch.analysis.engine import (  # noqa: F401
    Corpus,
    Finding,
    RULES,
    load_corpus,
    run_lint,
)
from duplexumiconsensusreads_torch.analysis import rules  # noqa: F401  (registers)

__all__ = ["Corpus", "Finding", "RULES", "load_corpus", "run_lint"]
