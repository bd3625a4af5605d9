"""dutlint CLI: run the invariant rules over the port's linted set.

Default file set: the whole ``duplexumiconsensusreads_torch`` package
(its ``tools/`` scripts included; ``_build/`` and ``__pycache__/``
skipped) and the test-side registry anchors
(``tests/test_torch_chaos.py`` for fault-site coverage,
``tests/test_torch_telemetry.py`` for the seconds-keys golden,
``tests/test_torch_serve.py`` for serving-site lease/takeover coverage,
``tests/test_torch_knobs.py`` for the scheduling matrix) — which are
also linted themselves.

Exit status: 0 when clean (allowlisted findings don't count, but are
listed with their reasons under -v), 1 on any non-allowlisted finding,
2 on usage errors. ``--json`` emits a machine-readable report (rule,
file, line, message per finding) for CI and editors; ``--rule ID``
(repeatable) runs/bisects single passes; ``--strict`` — the CI gate's
mode (duplexumiconsensusreads_torch/tools/ci_check.sh) — additionally fails default-set runs whose
allowlist carries stale entries. ``--since REV`` is the fast local
loop: the FULL default corpus still loads (the cross-file registries
need it), but only findings in files changed vs the git rev are
reported — CI keeps the whole-tree ``--strict`` gate.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from duplexumiconsensusreads_torch.analysis.allowlist import ALLOWLIST
from duplexumiconsensusreads_torch.analysis.engine import (
    RULES,
    load_corpus,
    run_lint,
)

PACKAGE = "duplexumiconsensusreads_torch"
# test files the cross-file rules anchor on; linted like everything else
TEST_ANCHORS = (
    "tests/test_torch_chaos.py",
    "tests/test_torch_telemetry.py",
    "tests/test_torch_serve.py",
    "tests/test_torch_knobs.py",
)
# build outputs and bytecode inside the package are not source
SKIP_DIRS = frozenset({"__pycache__", "_build"})


def repo_root() -> str:
    """The directory containing the package (works from a checkout;
    the console-script entry resolves through the installed package)."""
    import duplexumiconsensusreads_torch as pkg

    return os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))


def default_targets(root: str) -> list[str]:
    rels: list[str] = []
    pkg_dir = os.path.join(root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIRS)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                rels.append(
                    os.path.relpath(os.path.join(dirpath, fn), root)
                )
    for anchor in TEST_ANCHORS:
        if os.path.exists(os.path.join(root, anchor)):
            rels.append(anchor)
    return rels


def changed_since(root: str, rev: str) -> set[str] | None:
    """Repo-relative paths changed vs ``rev``: committed diffs plus
    worktree edits plus untracked files — everything the fast local
    loop might have touched. None (usage error) when git fails — an
    unknown rev must not silently lint nothing."""
    try:
        diff = subprocess.run(
            ["git", "-C", root, "diff", "--name-only", rev, "--"],
            capture_output=True, text=True,
        )
        if diff.returncode != 0:
            return None
        untracked = subprocess.run(
            ["git", "-C", root, "ls-files", "--others",
             "--exclude-standard"],
            capture_output=True, text=True,
        )
        if untracked.returncode != 0:
            return None
    except OSError:
        return None
    return {
        line.strip()
        for out in (diff.stdout, untracked.stdout)
        for line in out.splitlines()
        if line.strip()
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dutlint",
        description="AST-based invariant linter (clocks, durability, "
        "fault sites, phase registries, lock discipline, hook guards, "
        "and the serving fleet's protocol model: state machine, txn/"
        "fence dominance, exception contracts)",
    )
    ap.add_argument(
        "paths", nargs="*",
        help="repo-relative files to lint (default: the package, its "
        "tools/ and the test anchors)",
    )
    ap.add_argument("--root", default=None, help="repo root (default: "
                    "the checkout containing the package)")
    ap.add_argument("--rule", action="append", dest="rules", metavar="ID",
                    help="run only this rule (repeatable)")
    ap.add_argument(
        "--since", metavar="REV", default=None,
        help="incremental mode: load the full default corpus (the "
        "cross-file registries need it) but report only findings in "
        "files changed vs this git rev (committed + worktree + "
        "untracked); CI keeps the whole-tree --strict gate",
    )
    ap.add_argument("--json", action="store_true", help="JSON report")
    ap.add_argument(
        "--strict", action="store_true",
        help="also exit 1 on stale allowlist entries (default-set runs "
        "only — an explicit file subset legitimately misses most "
        "entries); the CI gate runs with this on",
    )
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also list allowlist-suppressed findings")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            print(f"{rid:<22} {RULES[rid].title}")
        return 0

    root = os.path.abspath(args.root) if args.root else repo_root()
    if args.since and args.paths:
        print("dutlint: --since and explicit paths are mutually "
              "exclusive (--since picks the file set itself)",
              file=sys.stderr)
        return 2
    rels = args.paths or default_targets(root)
    if args.rules:
        bad = [r for r in args.rules if r not in RULES]
        if bad:
            print(f"dutlint: unknown rule(s): {', '.join(bad)}",
                  file=sys.stderr)
            return 2
    changed: set[str] | None = None
    if args.since:
        changed = changed_since(root, args.since)
        if changed is None:
            print(f"dutlint: --since {args.since}: not a resolvable "
                  f"git rev in {root}", file=sys.stderr)
            return 2
    try:
        corpus = load_corpus(root, rels)
    except OSError as e:
        print(f"dutlint: {e}", file=sys.stderr)
        return 2
    result = run_lint(corpus, ALLOWLIST, only_rules=args.rules)
    if changed is not None:
        # the registries were read from the FULL corpus above; only the
        # reporting narrows. A finding in an unchanged file still means
        # the tree is dirty — but that is CI's whole-tree job, not the
        # fast local loop's.
        result.findings = [f for f in result.findings if f.path in changed]
        result.suppressed = [
            (f, a) for f, a in result.suppressed if f.path in changed
        ]
    # --strict folds allowlist staleness into the exit status, but only
    # against the full default set (see the warning path below);
    # --since is a subset view, so staleness stays out of its verdict
    stale_fails = bool(
        args.strict and not args.paths and not args.since
        and result.unused_allowlist
    )

    if args.json:
        ok = result.ok and not stale_fails
        print(json.dumps({
            "root": root,
            "n_files": len(corpus.trees) + len(corpus.parse_failures),
            "findings": [vars(f) for f in result.findings],
            "suppressed": [
                {**vars(f), "reason": a.reason}
                for f, a in result.suppressed
            ],
            "unused_allowlist": [vars(a) for a in result.unused_allowlist],
            "ok": ok,
        }, indent=2))
        return 0 if ok else 1

    for f in result.findings:
        print(f.format())
    if args.verbose:
        for f, a in result.suppressed:
            print(f"allowed: {f.format()}\n         reason: {a.reason}")
    if not args.paths and not args.since:
        # staleness is only meaningful against the full default set: an
        # explicit file subset legitimately misses most entries. Stale
        # suppressions are warnings here (failures under --strict — the
        # CI gate); the tier-1 gate (tests/test_torch_lint.py) also forces
        # pruning.
        severity = "error" if args.strict else "warning"
        for a in result.unused_allowlist:
            print(
                f"dutlint: {severity}: unused allowlist entry "
                f"({a.rule}, {a.path}) — prune it",
                file=sys.stderr,
            )
    n_files = len(corpus.trees) + len(corpus.parse_failures)
    if result.ok and not stale_fails:
        print(
            f"dutlint: OK — {n_files} files, "
            f"{len(RULES) if not args.rules else len(args.rules)} rules, "
            f"{len(result.suppressed)} allowlisted"
        )
        return 0
    if result.ok and stale_fails:
        print(
            f"dutlint: {len(result.unused_allowlist)} stale allowlist "
            f"entr(y/ies) under --strict",
            file=sys.stderr,
        )
        return 1
    print(
        f"dutlint: {len(result.findings)} finding(s) in {n_files} files "
        f"({len(result.suppressed)} allowlisted)",
        file=sys.stderr,
    )
    return 1


if __name__ == "__main__":
    sys.exit(main())
