"""Lint engine: corpus loading, rule registry, allowlist, findings.

Deliberately stdlib-``ast`` only (the container has no flake8 plugins,
and these rules are project-semantic anyway). The engine is dumb on
purpose: it parses a set of files once, hands every rule the whole
parsed corpus (rules are routinely CROSS-file — a fault site is a
property of faults.py, its call sites, and the chaos suite at once),
and matches the resulting findings against the allowlist.

Allowlist contract: an entry is (rule, path, reason) — suppression is
per rule per file, never blanket, and every entry must carry a reason
so the exception stays audited. Entries that suppress nothing are
reported back (``unused``) so the list cannot silently rot after the
underlying code is fixed.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Callable, Iterable, Iterator

# the port's command-line scripts: linted, but not package code
PORT_TOOLS = "duplexumiconsensusreads_torch/tools/"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file:line, with a fix hint."""

    rule: str
    path: str  # corpus-relative posix path
    line: int
    message: str
    hint: str = ""

    def format(self) -> str:
        s = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            s += f"  (fix: {self.hint})"
        return s


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    """One intentional exception: suppresses every finding of ``rule``
    in ``path``. ``reason`` is mandatory — an unexplained suppression
    is indistinguishable from a forgotten one."""

    rule: str
    path: str
    reason: str

    def __post_init__(self):
        if not self.reason.strip():
            raise ValueError(
                f"allowlist entry ({self.rule}, {self.path}) needs a reason"
            )


class Corpus:
    """A parsed file set: corpus-relative posix path -> (source, AST).

    Every AST node carries a ``_lint_parent`` backpointer so rules can
    walk ancestor chains (lock bodies, guard ``if``s, enclosing
    functions) without reimplementing scope tracking each time.
    """

    def __init__(self, root: str):
        self.root = root
        self.sources: dict[str, str] = {}
        self.trees: dict[str, ast.Module] = {}
        self.parse_failures: list[Finding] = []

    def add(self, rel_path: str, source: str) -> None:
        rel_path = rel_path.replace(os.sep, "/")
        self.sources[rel_path] = source
        try:
            tree = ast.parse(source, filename=rel_path)
        except SyntaxError as e:
            # a file the linter cannot parse is itself a finding — the
            # invariants it might violate are unverifiable
            self.parse_failures.append(
                Finding(
                    rule="parse",
                    path=rel_path,
                    line=e.lineno or 1,
                    message=f"file does not parse: {e.msg}",
                    hint="fix the syntax error so the linter can see the file",
                )
            )
            return
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                child._lint_parent = node  # type: ignore[attr-defined]
        self.trees[rel_path] = tree

    def find(self, suffix: str) -> str | None:
        """The corpus path ending with ``suffix`` (posix), or None.
        Anchor files (faults.py, trace.py, the chaos suite) are located
        this way so fixture corpora in tests can mirror the layout
        under any root."""
        suffix = suffix.replace(os.sep, "/")
        for p in self.trees:
            if p == suffix or p.endswith("/" + suffix):
                return p
        return None

    def package_paths(self) -> list[str]:
        """Paths inside the package proper (not tools/, not tests/).
        The port keeps its scripts under the package
        (``duplexumiconsensusreads_torch/tools/``); they count as tools."""
        return [
            p for p in self.trees
            if not p.startswith(("tools/", "tests/", PORT_TOOLS))
            and "/tests/" not in p
        ]


# Shared AST cache: (abspath) -> (mtime_ns, size, source, tree).
# The tier-1 suite and the CLI load the same ~90-file corpus dozens of
# times per run (whole-tree gate, per-rule bisections, ci_check legs);
# parsing is the dominant cost, and trees are never mutated by rules,
# so identical on-disk files share one parse. Keyed by mtime+size so
# an edited file re-parses; in-memory fixture corpora (Corpus.add) are
# not cached. CACHE_STATS backs the lint-suite runtime budget test.
_AST_CACHE: dict[str, tuple[int, int, str, ast.Module]] = {}
CACHE_STATS = {"hits": 0, "misses": 0}


def load_corpus(root: str, rel_paths: Iterable[str]) -> Corpus:
    corpus = Corpus(root)
    for rel in sorted(set(rel_paths)):
        full = os.path.join(root, rel)
        key = os.path.abspath(full)
        st = os.stat(full)
        cached = _AST_CACHE.get(key)
        if (
            cached is not None
            and cached[0] == st.st_mtime_ns
            and cached[1] == st.st_size
        ):
            CACHE_STATS["hits"] += 1
            rel_posix = rel.replace(os.sep, "/")
            corpus.sources[rel_posix] = cached[2]
            corpus.trees[rel_posix] = cached[3]
            continue
        CACHE_STATS["misses"] += 1
        with open(full, "r", encoding="utf-8") as f:
            source = f.read()
        corpus.add(rel, source)
        rel_posix = rel.replace(os.sep, "/")
        tree = corpus.trees.get(rel_posix)
        if tree is not None:  # parse failures are re-reported per load
            _AST_CACHE[key] = (st.st_mtime_ns, st.st_size, source, tree)
    return corpus


# --------------------------------------------------------- rule registry

@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    title: str
    check: Callable[[Corpus], Iterator[Finding]]


RULES: dict[str, Rule] = {}


def register(rule_id: str, title: str):
    """Decorator: add a check function to the registry under ``rule_id``."""

    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, title, fn)
        return fn

    return deco


# --------------------------------------------------------------- running

@dataclasses.dataclass
class LintResult:
    findings: list[Finding]  # non-suppressed, sorted
    suppressed: list[tuple[Finding, AllowEntry]]
    unused_allowlist: list[AllowEntry]

    @property
    def ok(self) -> bool:
        return not self.findings


def run_lint(
    corpus: Corpus,
    allowlist: Iterable[AllowEntry] = (),
    only_rules: Iterable[str] | None = None,
) -> LintResult:
    """Run every registered rule (or ``only_rules``) over ``corpus``."""
    allow = list(allowlist)
    rule_ids = list(only_rules) if only_rules is not None else sorted(RULES)
    unknown = [r for r in rule_ids if r not in RULES]
    if unknown:
        raise ValueError(
            f"unknown rule id(s): {', '.join(unknown)} "
            f"(known: {', '.join(sorted(RULES))})"
        )
    raw: list[Finding] = list(corpus.parse_failures)
    for rid in rule_ids:
        raw.extend(RULES[rid].check(corpus))
    kept: list[Finding] = []
    suppressed: list[tuple[Finding, AllowEntry]] = []
    used: set[int] = set()
    for f in raw:
        entry = next(
            (a for a in allow if a.rule == f.rule and a.path == f.path), None
        )
        if entry is not None:
            suppressed.append((f, entry))
            used.add(id(entry))
        else:
            kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    unused = [
        a for a in allow
        if id(a) not in used
        # an entry for a rule that wasn't run can't have fired; only
        # call it unused when its rule actually participated
        and (a.rule in rule_ids or a.rule == "parse")
    ]
    return LintResult(kept, suppressed, unused)


# ----------------------------------------------------------- AST helpers
#
# Shared by several rules; kept here so rules.py stays about the
# invariants, not AST plumbing.

def call_name(node: ast.Call) -> str:
    """Terminal callee name: ``open(...)`` -> "open",
    ``tr.span(...)`` -> "span", ``faults.fault_point(...)`` ->
    "fault_point". Empty string for exotic callees."""
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def str_tuple_assign(tree: ast.Module, name: str) -> tuple[list[str], int]:
    """Module-level ``NAME = ("a", "b", ...)`` -> (values, lineno).

    Returns ([], 0) when the assignment is missing or not a literal
    string tuple/list — callers treat that as "registry not found"."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                val = node.value
                if isinstance(val, (ast.Tuple, ast.List)):
                    out = [str_const(e) for e in val.elts]
                    if all(v is not None for v in out):
                        return [v for v in out if v is not None], node.lineno
    return [], 0


def str_dict_assign(
    tree: ast.Module, name: str
) -> tuple[dict[str, tuple[str, ...]], int]:
    """Module-level ``NAME = {"a": ("b", ...), ...}`` -> (dict, lineno).

    The declared-graph shape (the state machine's TRANSITIONS table):
    string keys, tuple/list-of-string values. Returns ({}, 0) when the
    assignment is missing or not fully literal — callers treat that as
    "registry not found", same contract as :func:`str_tuple_assign`."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        for t in targets:
            if not (isinstance(t, ast.Name) and t.id == name):
                continue
            val = node.value
            if not isinstance(val, ast.Dict):
                continue
            out: dict[str, tuple[str, ...]] = {}
            ok = True
            for k, v in zip(val.keys, val.values):
                key = str_const(k) if k is not None else None
                if key is None or not isinstance(v, (ast.Tuple, ast.List)):
                    ok = False
                    break
                elts = [str_const(e) for e in v.elts]
                if any(e is None for e in elts):
                    ok = False
                    break
                out[key] = tuple(e for e in elts if e is not None)
            if ok and out:
                return out, node.lineno
    return {}, 0


def literal_assign(tree: ast.Module, name: str):
    """Module-level ``NAME = <pure literal>`` -> the evaluated Python
    value (via ``ast.literal_eval``), or None when the assignment is
    missing or not a literal. The registry-reading contract for the
    declared-model rules (KNOB_TABLE, THREAD_ROLES): registries are
    read FROM THE CORPUS, never imported, so fixture corpora declare
    their own miniatures and "not a literal" degrades to "registry not
    found" like :func:`str_tuple_assign`."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                try:
                    return ast.literal_eval(node.value)
                except (ValueError, SyntaxError, TypeError):
                    return None
    return None


def function_defs(tree: ast.Module) -> dict[str, ast.AST]:
    """Every (async) function def in the file by name, nested defs
    included (thread entries and their closures live inside
    ``stream_call_consensus``). First definition wins, so the mapping
    is deterministic."""
    defs: dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    return defs


def reachable_functions(
    defs: dict[str, ast.AST], root_name: str
) -> list[ast.AST]:
    """``root_name`` plus every same-file function it (transitively)
    calls by name — a thread entry's static call scope. Imported
    callees are out of scope: they are the shared vocabulary of the
    whole program and carry their own rules."""
    if root_name not in defs:
        return []
    scope = {root_name}
    frontier = [defs[root_name]]
    while frontier:
        fn = frontier.pop()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in defs and name not in scope:
                scope.add(name)
                frontier.append(defs[name])
    return [defs[n] for n in sorted(scope)]


def inside_named_lock(node: ast.AST, lock_name: str) -> bool:
    """Is ``node`` lexically inside ``with <lock_name>:``? Name-based
    like :func:`inside_lock_body`, but for ONE declared lock — the
    thread-confinement registry names which lock guards which shared
    structure, so "some lock" is not good enough."""
    for a in ancestors(node):
        if not isinstance(a, (ast.With, ast.AsyncWith)):
            continue
        for item in a.items:
            for n in ast.walk(item.context_expr):
                if isinstance(n, ast.Name) and n.id == lock_name:
                    return True
                if isinstance(n, ast.Attribute) and n.attr == lock_name:
                    return True
    return False


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_lint_parent", None)


def enclosing_function(node: ast.AST) -> ast.AST | None:
    for a in ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return a
    return None


def node_mentions_lock(node: ast.AST) -> bool:
    """Does this expression reference something named like a lock?
    (``phase_lock``, ``self._lock``, ``lock`` — name-based on purpose:
    the codebase's convention IS the name.)"""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and "lock" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "lock" in n.attr.lower():
            return True
    return False


def inside_lock_body(node: ast.AST) -> bool:
    """Is ``node`` lexically inside a ``with <lock>:`` body?"""
    for a in ancestors(node):
        if isinstance(a, (ast.With, ast.AsyncWith)) and any(
            node_mentions_lock(item.context_expr) for item in a.items
        ):
            return True
    return False


def expr_path(node: ast.AST) -> str | None:
    """Dotted-name path of a Name/Attribute chain (``tr`` ->
    "tr", ``self._recorder`` -> "self._recorder"); None for anything
    else (calls, subscripts) — those have no stable identity to match
    a guard against."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = expr_path(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def guarded_not_none(node: ast.AST, var: str) -> bool:
    """Is ``node`` inside the branch of an ``if`` proving ``var`` (a
    dotted-name path) is not None? Accepts ``if var is not None:
    <body>``, ``if var is None: ... else: <body>``, and ``var is not
    None`` as a conjunct of an ``and`` (``if var is not None and
    resume:``)."""

    def _cmp(test: ast.AST) -> str | None:
        # returns "not_none" / "none" when test proves it for `var`
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            # every conjunct of an `and` holds in the body
            if any(_cmp(v) == "not_none" for v in test.values):
                return "not_none"
            return None
        if not (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and expr_path(test.left) == var
            and len(test.comparators) == 1
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
        ):
            return None
        if isinstance(test.ops[0], ast.IsNot):
            return "not_none"
        if isinstance(test.ops[0], ast.Is):
            return "none"
        return None

    child = node
    for a in ancestors(node):
        if isinstance(a, ast.If):
            kind = _cmp(a.test)
            if kind == "not_none" and _contains(a.body, child):
                return True
            if kind == "none" and _contains(a.orelse, child):
                return True
        child = a
    return False


def _contains(stmts: list[ast.stmt], node: ast.AST) -> bool:
    return any(node is s or node in set(ast.walk(s)) for s in stmts)
