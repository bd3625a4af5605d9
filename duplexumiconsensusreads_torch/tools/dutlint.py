#!/usr/bin/env python
"""The port's invariant linter — see duplexumiconsensusreads_torch/analysis/.

    python duplexumiconsensusreads_torch/tools/dutlint.py
    python -m duplexumiconsensusreads_torch.tools.dutlint --list-rules
    python -m duplexumiconsensusreads_torch.tools.dutlint --rule state-machine -v
    python -m duplexumiconsensusreads_torch.tools.dutlint --json
    python -m duplexumiconsensusreads_torch.tools.dutlint --strict

Lints the port package (its tools included) and the port's test
anchors. Exit 1 on any non-allowlisted finding (and, under --strict, on
stale allowlist entries); 2 on usage errors.
duplexumiconsensusreads_torch/tools/ci_check.sh runs it as the first leg
of the port's commit gate.
"""

import os
import sys

sys.path.insert(
    0,
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
)

from duplexumiconsensusreads_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
