"""The project's invariant rules.

Each rule encodes one convention the correctness story depends on, as
documented in ARCHITECTURE.md "Invariants & static analysis". Rules are
cross-file on purpose: most of these invariants live BETWEEN modules
(a registry here, its call sites there, the test that pins them third),
which is exactly the drift a per-file linter cannot see.

Anchor files are located by path suffix (``Corpus.find``) so the same
rules run over the real tree and over the miniature fixture corpora in
``tests/test_torch_lint.py``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from duplexumiconsensusreads_torch.analysis.engine import (
    Corpus,
    Finding,
    ancestors,
    call_name,
    enclosing_function,
    expr_path,
    function_defs,
    guarded_not_none,
    inside_lock_body,
    inside_named_lock,
    literal_assign,
    reachable_functions,
    register,
    str_const,
    str_dict_assign,
    str_tuple_assign,
)

# ------------------------------------------------------------- rule: clock

@register(
    "clock-discipline",
    "phase/duration accounting must use time.monotonic(), never time.time()",
)
def check_clock(corpus: Corpus) -> Iterator[Finding]:
    """``RunReport.seconds`` and every duration in the codebase are
    monotonic-clock deltas: an NTP step mid-run must not be able to
    produce negative or inflated phases (see runtime/stream.py's
    accounting and the telemetry epoch). Any ``time.time()`` call is
    therefore suspect — genuine wall-clock needs are allowlisted."""
    for path, tree in corpus.trees.items():
        # names `from time import time [as x]` binds in this module
        aliased = {
            a.asname or a.name
            for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module == "time"
            for a in node.names
            if a.name == "time"
        }
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            hit = (
                isinstance(fn, ast.Attribute)
                and fn.attr == "time"
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "time"
            ) or (isinstance(fn, ast.Name) and fn.id in aliased)
            if hit:
                yield Finding(
                    rule="clock-discipline",
                    path=path,
                    line=node.lineno,
                    message="time.time() used for timing",
                    hint="use time.monotonic() — wall-clock steps (NTP) "
                    "corrupt duration deltas and RunReport.seconds",
                )


# -------------------------------------------------------- rule: durability

_DURABLE_PROTOCOL_CALLS = {"write_durable", "replace_durable", "rewrite_from"}


def _open_write_mode(node: ast.Call) -> bool:
    if call_name(node) != "open" or not isinstance(node.func, ast.Name):
        return False
    mode = None
    if len(node.args) >= 2:
        mode = str_const(node.args[1])
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = str_const(kw.value)
    # '+' catches update modes ("r+b"): an in-place patch of a trusted
    # file is the same torn-write hazard as a fresh write
    return mode is not None and any(c in mode for c in "wax+")


@register(
    "durability-protocol",
    "persistent writes in io//runtime//serve/ must use the "
    "tmp+fsync+rename protocol",
)
def check_durability(corpus: Corpus) -> Iterator[Finding]:
    """A file a later run trusts by existence (shards, manifests, the
    finalised BAM, indexes, the service's queue journal and spooled
    jobs) written with a bare ``open(.., "w")`` can survive a crash
    looking complete while holding torn bytes — the exact failure mode
    io/durable.py exists for. In ``io/``, ``runtime/`` and ``serve/``
    (whose entire crash-recovery story rests on the journal being
    durable), every write-mode open must sit in a function that routes
    through the protocol (write_durable / replace_durable /
    rewrite_from); anything else is a finding (intentional diagnostics
    writers are allowlisted, with reasons)."""
    for path, tree in corpus.trees.items():
        parts = path.split("/")
        if not any(seg in ("io", "runtime", "serve") for seg in parts[:-1]):
            continue
        if path.endswith("io/durable.py"):
            continue  # the protocol implementation itself
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and _open_write_mode(node)):
                continue
            fn = enclosing_function(node)
            scope = fn if fn is not None else tree
            uses_protocol = any(
                isinstance(n, ast.Call)
                and call_name(n) in _DURABLE_PROTOCOL_CALLS
                for n in ast.walk(scope)
            )
            if not uses_protocol:
                yield Finding(
                    rule="durability-protocol",
                    path=path,
                    line=node.lineno,
                    message="bare write-mode open() outside the durable "
                    "write protocol",
                    hint="route through io.durable.write_durable (tmp + "
                    "fsync + atomic rename + dir fsync), or stage into a "
                    ".tmp via rewrite_from/replace_durable",
                )


# ----------------------------------------------------- rule: fault registry

@register(
    "fault-registry",
    "fault_point sites, faults.KNOWN_SITES, and the chaos suite must agree",
)
def check_fault_registry(corpus: Corpus) -> Iterator[Finding]:
    """Three-way consistency: (a) every site literal at a
    ``fault_point``/``_io_retry`` call is registered in
    runtime/faults.py KNOWN_SITES (an unregistered site raises at
    runtime — but only when a plan is installed, i.e. exactly when you
    need it); (b) every registered site is actually threaded through
    the code (a dead site gives false chaos-coverage confidence); (c)
    every registered site is exercised by tests/test_torch_chaos.py, either
    as a literal or via a parametrize over KNOWN_SITES."""
    faults_path = corpus.find("runtime/faults.py")
    if faults_path is None:
        return
    known, known_line = str_tuple_assign(
        corpus.trees[faults_path], "KNOWN_SITES"
    )
    if not known:
        yield Finding(
            rule="fault-registry",
            path=faults_path,
            line=1,
            message="KNOWN_SITES literal tuple not found",
            hint="keep KNOWN_SITES a module-level tuple of string literals "
            "so the registry stays statically checkable",
        )
        return
    known_set = set(known)

    # (a) + usage collection: literals at fault_point()/_io_retry() sites
    used: dict[str, tuple[str, int]] = {}
    for path in corpus.package_paths():
        if path == faults_path:
            continue
        for node in ast.walk(corpus.trees[path]):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) not in ("fault_point", "_io_retry"):
                continue
            if not node.args:
                continue
            site = str_const(node.args[0])
            if site is None:
                continue  # variable site (the fault_point(site) relay)
            used.setdefault(site, (path, node.lineno))
            if site not in known_set:
                yield Finding(
                    rule="fault-registry",
                    path=path,
                    line=node.lineno,
                    message=f"fault site {site!r} is not registered in "
                    f"faults.KNOWN_SITES",
                    hint="add it to KNOWN_SITES (and cover it in "
                    "tests/test_torch_chaos.py) or fix the typo",
                )

    # (b) registered but never threaded through the code
    for site in known:
        if site not in used:
            yield Finding(
                rule="fault-registry",
                path=faults_path,
                line=known_line,
                message=f"KNOWN_SITES entry {site!r} has no "
                f"fault_point/_io_retry call site",
                hint="thread the site through the step it names, or drop "
                "the dead registry entry",
            )

    # (c) chaos coverage. Skipped when the chaos suite isn't in the
    # corpus (explicit-path runs, installed-package runs): the tier-1
    # gate lints the default set, which always anchors it in a checkout
    # (tests/test_torch_lint.py pins that).
    chaos_path = corpus.find("tests/test_torch_chaos.py")
    if chaos_path is None:
        return
    chaos_tree = corpus.trees[chaos_path]
    blanket = any(
        isinstance(node, ast.Call)
        and call_name(node) == "parametrize"
        and any(
            (isinstance(a, ast.Attribute) and a.attr == "KNOWN_SITES")
            or (isinstance(a, ast.Name) and a.id == "KNOWN_SITES")
            for a in node.args
        )
        for node in ast.walk(chaos_tree)
    )
    if blanket:
        return  # a parametrize over the registry covers every site
    # only literals that reach CODE count as coverage — strings inside
    # call arguments (schedule specs, parametrize lists) or assigned
    # data (a BOUNDARY_KILLS-style table later fed to parametrize). A
    # docstring or comment-string mentioning a site must not read as
    # exercising it (docstrings are bare Expr statements: excluded).
    roots: list[ast.AST] = []
    for node in ast.walk(chaos_tree):
        if isinstance(node, ast.Call):
            roots.extend(node.args)
            roots.extend(kw.value for kw in node.keywords)
        elif isinstance(node, ast.Assign):
            roots.append(node.value)
    literals = [
        lit
        for root in roots
        for sub in ast.walk(root)
        if (lit := str_const(sub)) is not None
    ]
    for site in known:
        if not any(site in lit for lit in literals):
            yield Finding(
                rule="fault-registry",
                path=chaos_path,
                line=1,
                message=f"fault site {site!r} is never exercised by the "
                f"chaos suite",
                hint="add a schedule hitting it, or parametrize a test "
                "over faults.KNOWN_SITES",
            )


# ----------------------------------------------------- rule: phase registry

# rep.seconds carries these beside the per-stage busy keys; the golden
# test's key set is the stage set plus exactly these
_DERIVED_SECONDS_KEYS = {"drain_utilization", "total"}


@register(
    "phase-registry",
    "trace stages, DRAIN_PHASES, the phase dict, and the seconds golden "
    "must be one set",
)
def check_phase_registry(corpus: Corpus) -> Iterator[Finding]:
    """The tracing-era drift class: a stage added to the executor's phase
    dict but not KNOWN_STAGES (the capture validator rejects healthy
    traces), or to both but not the report golden (the report-facing
    schema silently changes), or a span recorded under a name the sum
    check can't match. One set, four mirrors; this rule diffs them."""
    trace_path = corpus.find("telemetry/trace.py")
    if trace_path is None:
        return
    stages, stages_line = str_tuple_assign(
        corpus.trees[trace_path], "KNOWN_STAGES"
    )
    events, _ = str_tuple_assign(corpus.trees[trace_path], "KNOWN_EVENTS")
    # byte-ledger registry (absent in pre-ledger corpora: the xfer
    # check simply has nothing to pin literals against there)
    xfer_dirs, _ = str_tuple_assign(
        corpus.trees[trace_path], "KNOWN_XFER_DIRS"
    )
    # h2d ledger-record attr registry (the bucket-tuner's fill-factor
    # audit fields ride h2d records; absent in pre-tuner corpora)
    h2d_attrs, _ = str_tuple_assign(
        corpus.trees[trace_path], "KNOWN_H2D_XFER_ATTRS"
    )
    # literal-lane registry (mesh execution's dev-N device lanes, the
    # service's job-<id> lanes; absent in pre-mesh corpora, where the
    # lane check simply skips)
    lane_prefixes, _ = str_tuple_assign(
        corpus.trees[trace_path], "KNOWN_LANE_PREFIXES"
    )
    # fleet timeline registries (telemetry/fleet.py): segment/gap kinds
    # the cross-daemon stitcher constructs and the SLO/prom surfaces key
    # on — absent in pre-fleet corpora, where the checks simply skip
    fleet_path = corpus.find("telemetry/fleet.py")
    seg_kinds: list[str] = []
    gap_kinds: list[str] = []
    fleet_reg_line = 1
    if fleet_path is not None:
        seg_kinds, fleet_reg_line = str_tuple_assign(
            corpus.trees[fleet_path], "FLEET_SEGMENT_KINDS"
        )
        gap_kinds, _ = str_tuple_assign(
            corpus.trees[fleet_path], "FLEET_GAP_KINDS"
        )
    if not stages:
        yield Finding(
            rule="phase-registry",
            path=trace_path,
            line=1,
            message="KNOWN_STAGES literal tuple not found",
            hint="keep KNOWN_STAGES a module-level tuple of string literals",
        )
        return
    stage_set = set(stages)

    # DRAIN_PHASES ⊆ KNOWN_STAGES
    exec_path = corpus.find("runtime/executor.py")
    if exec_path is not None:
        drain, drain_line = str_tuple_assign(
            corpus.trees[exec_path], "DRAIN_PHASES"
        )
        for ph in drain:
            if ph not in stage_set:
                yield Finding(
                    rule="phase-registry",
                    path=exec_path,
                    line=drain_line,
                    message=f"DRAIN_PHASES entry {ph!r} is not a known "
                    f"trace stage",
                    hint="DRAIN_PHASES must be a subset of "
                    "telemetry.trace.KNOWN_STAGES",
                )

    # the streaming executor's phase-accounting dict == KNOWN_STAGES
    stream_path = corpus.find("runtime/stream.py")
    if stream_path is not None:
        phase_keys, phase_line = _phase_dict_keys(corpus.trees[stream_path])
        if phase_keys is not None:
            for k in phase_keys - stage_set:
                yield Finding(
                    rule="phase-registry",
                    path=stream_path,
                    line=phase_line,
                    message=f"phase dict key {k!r} is not a known trace "
                    f"stage",
                    hint="add it to telemetry.trace.KNOWN_STAGES in the "
                    "same change (stage set == phase-key set)",
                )
            for k in stage_set - phase_keys:
                yield Finding(
                    rule="phase-registry",
                    path=stream_path,
                    line=phase_line,
                    message=f"known trace stage {k!r} missing from the "
                    f"phase accounting dict",
                    hint="every stage must accrue busy seconds (the "
                    "trace_report sum-check is phrased over all stages)",
                )

    # every literal span stage / event name recorded in the package is
    # registered (a typo'd stage fails the capture schema check only at
    # runtime, with a trace flag set — exactly too late)
    for path in corpus.package_paths():
        if path == trace_path:
            continue
        for node in ast.walk(corpus.trees[path]):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = call_name(node)
            lit = str_const(node.args[0])
            if lit is None:
                continue
            if name == "span" and lit not in stage_set:
                yield Finding(
                    rule="phase-registry",
                    path=path,
                    line=node.lineno,
                    message=f"span recorded under unknown stage {lit!r}",
                    hint="register the stage in telemetry.trace."
                    "KNOWN_STAGES (and the phase dict + golden)",
                )
            if (
                name in ("event", "emit_event")
                and events
                and lit not in events
            ):
                yield Finding(
                    rule="phase-registry",
                    path=path,
                    line=node.lineno,
                    message=f"event recorded under unknown name {lit!r}",
                    hint="register the event in telemetry.trace.KNOWN_EVENTS",
                )
            if name == "xfer" and xfer_dirs and lit not in xfer_dirs:
                # byte-ledger records: an unregistered direction fails
                # the capture schema only at runtime (wirestat/
                # check_trace exit 1 on a healthy run) — same drift
                # class as a typo'd span stage, same gate
                yield Finding(
                    rule="phase-registry",
                    path=path,
                    line=node.lineno,
                    message=f"xfer recorded under unknown dir {lit!r}",
                    hint="register the direction in telemetry.trace."
                    "KNOWN_XFER_DIRS (and the ledger analysis + "
                    "ARCHITECTURE.md schema)",
                )
            if name == "seg_rec" and seg_kinds and lit not in seg_kinds:
                # fleet timeline records: an unregistered segment kind
                # forks the stitched-timeline schema the SLO gates and
                # the Perfetto export key on — same drift class as a
                # typo'd span stage (the constructor also refuses at
                # runtime; this catches it at lint time)
                yield Finding(
                    rule="phase-registry",
                    path=path,
                    line=node.lineno,
                    message=f"fleet segment recorded under unknown kind "
                    f"{lit!r}",
                    hint="register the kind in telemetry.fleet."
                    "FLEET_SEGMENT_KINDS (and ARCHITECTURE.md's fleet "
                    "observability schema)",
                )
            if name == "gap_rec" and gap_kinds and lit not in gap_kinds:
                yield Finding(
                    rule="phase-registry",
                    path=path,
                    line=node.lineno,
                    message=f"fleet gap recorded under unknown kind "
                    f"{lit!r}",
                    hint="register the kind in telemetry.fleet."
                    "FLEET_GAP_KINDS (and ARCHITECTURE.md's fleet "
                    "observability schema)",
                )
            if name in ("span", "event", "emit_event", "xfer") and lane_prefixes:
                # literal lane families must be registered: a typo'd
                # lane= ("gpu-0", f"chip{i}") silently forks the
                # grouping key wirestat's device table, the fleet
                # stitcher and the chrome export all key on. Dynamic
                # lanes (current_lane(), a variable) are thread-derived
                # and stay out of scope; an f-string is checked by its
                # leading literal, so a placeholder-first lane is
                # unpinnable and flagged too.
                for kw in node.keywords or ():
                    if kw.arg != "lane":
                        continue
                    head = _lane_head(kw.value)
                    if head is None:
                        continue
                    ok = head == "main" or any(
                        p.endswith("-") and head.startswith(p)
                        for p in lane_prefixes
                    )
                    if not ok:
                        yield Finding(
                            rule="phase-registry",
                            path=path,
                            line=node.lineno,
                            message=f"literal lane {head!r}... is not "
                            f"registered",
                            hint="lane literals must be 'main' or start "
                            "with a telemetry.trace.KNOWN_LANE_PREFIXES "
                            "entry (dev-/job-/...)",
                        )
            if name == "xfer" and lit == "h2d" and h2d_attrs:
                # h2d records carry the packing/fill audit attrs; an
                # unregistered keyword is a silent schema fork — the
                # xfer envelope golden and wirestat's fill reader both
                # key on the registered set
                for kw in node.keywords or ():
                    if kw.arg in (None, "chunk", "lane", "resumed"):
                        continue
                    if kw.arg not in h2d_attrs:
                        yield Finding(
                            rule="phase-registry",
                            path=path,
                            line=node.lineno,
                            message=f"h2d xfer attr {kw.arg!r} is not "
                            f"registered",
                            hint="register it in telemetry.trace."
                            "KNOWN_H2D_XFER_ATTRS (and the xfer schema "
                            "golden + ARCHITECTURE.md)",
                        )

    # dead-registry detection, the fault-registry rule's second
    # direction: a fleet kind nothing in the stitcher ever produces is
    # a schema entry consumers will wait on forever. Literals inside
    # the registry tuples themselves don't count as use.
    if fleet_path is not None and (seg_kinds or gap_kinds):
        skip_nodes = set()
        for node in ast.walk(corpus.trees[fleet_path]):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in (
                    "FLEET_SEGMENT_KINDS", "FLEET_GAP_KINDS"
                )
            ):
                skip_nodes.update(id(n) for n in ast.walk(node))
        used = {
            lit
            for node in ast.walk(corpus.trees[fleet_path])
            if id(node) not in skip_nodes
            and (lit := str_const(node)) is not None
        }
        for kind in list(seg_kinds) + list(gap_kinds):
            if kind not in used:
                yield Finding(
                    rule="phase-registry",
                    path=fleet_path,
                    line=fleet_reg_line,
                    message=f"fleet kind {kind!r} is registered but the "
                    f"stitcher never produces it",
                    hint="emit it in telemetry/fleet.py or prune the "
                    "registry entry",
                )

    # the RunReport streaming-seconds golden in tests == stages + derived
    golden_path = corpus.find("tests/test_torch_telemetry.py")
    if golden_path is not None:
        golden, golden_line = _golden_seconds_set(corpus.trees[golden_path])
        if golden is not None:
            want = stage_set | _DERIVED_SECONDS_KEYS
            for k in sorted(golden - want):
                yield Finding(
                    rule="phase-registry",
                    path=golden_path,
                    line=golden_line,
                    message=f"seconds-keys golden has {k!r}, which is "
                    f"neither a known stage nor a derived key",
                    hint="stage keys come from telemetry.trace."
                    "KNOWN_STAGES; derived keys are "
                    f"{sorted(_DERIVED_SECONDS_KEYS)}",
                )
            for k in sorted(want - golden):
                yield Finding(
                    rule="phase-registry",
                    path=golden_path,
                    line=golden_line,
                    message=f"seconds-keys golden is missing {k!r}",
                    hint="extend test_streaming_seconds_keys_golden in the "
                    "same change that adds the stage",
                )


def _lane_head(v) -> str | None:
    """Leading literal of a ``lane=`` argument: the full string for a
    plain literal, the pre-placeholder prefix for an f-string (""
    when the f-string STARTS with a placeholder — an unpinnable lane
    family, flagged), None for dynamic expressions (thread-derived
    lanes like ``current_lane()`` or a variable — out of scope)."""
    lit = str_const(v)
    if lit is not None:
        return lit
    if isinstance(v, ast.JoinedStr):
        if (
            v.values
            and isinstance(v.values[0], ast.Constant)
            and isinstance(v.values[0].value, str)
        ):
            return v.values[0].value
        return ""
    return None


def _phase_dict_keys(tree: ast.Module) -> tuple[set[str] | None, int]:
    """Keys of the ``phase = {...}`` accounting dict (all-str-key dict
    literal assigned to a name ``phase``, at any scope)."""
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "phase"
            and isinstance(node.value, ast.Dict)
        ):
            continue
        keys = [str_const(k) for k in node.value.keys if k is not None]
        if keys and all(k is not None for k in keys):
            return {k for k in keys if k is not None}, node.lineno
    return None, 0


def _golden_seconds_set(tree: ast.Module) -> tuple[set[str] | None, int]:
    """The literal set compared in test_streaming_seconds_keys_golden."""
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.FunctionDef)
            and node.name == "test_streaming_seconds_keys_golden"
        ):
            best: tuple[set[str], int] | None = None
            for n in ast.walk(node):
                if isinstance(n, ast.Set):
                    vals = [str_const(e) for e in n.elts]
                    if vals and all(v is not None for v in vals):
                        s = {v for v in vals if v is not None}
                        if best is None or len(s) > len(best[0]):
                            best = (s, n.lineno)
            if best:
                return best
    return None, 0


# ----------------------------------------------------- rule: lock discipline

_BLOCKING_NAMES = {"open", "fsync", "fsync_file", "result", "sleep"}
_MUTATORS = {
    "append", "extend", "insert", "remove", "clear", "update", "pop",
    "popitem", "setdefault", "add", "discard", "appendleft", "popleft",
}


@register(
    "lock-discipline",
    "no blocking I/O inside lock bodies; module-level mutable state "
    "mutated only under a lock",
)
def check_lock_discipline(corpus: Corpus) -> Iterator[Finding]:
    """The executor's locks serialize ACCOUNTING (dict += under
    phase_lock, one buffered line under the recorder lock) — cheap by
    contract. Blocking work inside a lock body (file open, fsync,
    compression, a future's ``result()``, sleep) turns every other
    worker's bookkeeping into convoyed wall time; the pipelined drain's
    whole point evaporates. Scope: runtime/stream.py and
    telemetry/trace.py, the two files whose locks sit on the per-chunk
    hot path. The second check is the inverse: module-level mutable
    containers written OUTSIDE any lock are cross-thread races waiting
    for load (the executor's pools share module state)."""
    for suffix in ("runtime/stream.py", "telemetry/trace.py"):
        path = corpus.find(suffix)
        if path is None:
            continue
        tree = corpus.trees[path]

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            blocking = name in _BLOCKING_NAMES or "compress" in name.lower()
            if blocking and inside_lock_body(node):
                yield Finding(
                    rule="lock-discipline",
                    path=path,
                    line=node.lineno,
                    message=f"blocking call {name}() inside a lock body",
                    hint="do the I/O/compute outside the lock; hold the "
                    "lock only for the shared-state update",
                )

        module_mutables = {
            t.id
            for stmt in tree.body
            if isinstance(stmt, ast.Assign)
            for t in stmt.targets
            if isinstance(t, ast.Name) and _is_mutable_ctor(stmt.value)
        }
        if not module_mutables:
            continue
        for node in ast.walk(tree):
            target_name = _mutated_module_name(node, module_mutables)
            if target_name is None:
                continue
            if enclosing_function(node) is None:
                continue  # module-level init writes are single-threaded
            if not inside_lock_body(node):
                yield Finding(
                    rule="lock-discipline",
                    path=path,
                    line=node.lineno,
                    message=f"module-level mutable {target_name!r} mutated "
                    f"outside any lock",
                    hint="take the module's lock around the mutation (the "
                    "executor's worker pools share this state)",
                )


def _is_mutable_ctor(value: ast.AST) -> bool:
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
        return True
    return isinstance(value, ast.Call) and call_name(value) in (
        "dict", "list", "set", "deque", "defaultdict", "Counter",
    )


def _mutated_module_name(node: ast.AST, names: set[str]) -> str | None:
    """Name from ``names`` this node mutates, if any: subscript/aug
    assignment or a mutating method call on the bare module-level name."""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and t.value.id in names
            ):
                return t.value.id
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _MUTATORS
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id in names
    ):
        return node.func.value.id
    return None


# ----------------------------------------------- rule: lease discipline

@register(
    "lease-discipline",
    "serve/ lease/journal state may only move durably: fenced sites "
    "registered, serving-suite covered, mutations persisted",
)
def check_lease_discipline(corpus: Corpus) -> Iterator[Finding]:
    """The fleet's exactly-once story rests on three conventions that
    drift independently of the generic rules:

    (a) every ``serve.*`` fault-site literal used in ``serve/`` (at
        ``fault_point``/``_io_retry``) is registered in
        ``faults.KNOWN_SITES`` — a typo'd lease site would silently
        skip chaos coverage of a step the takeover proof depends on;
    (b) every registered ``serve.*`` site is exercised by the serving
        suite (``tests/test_torch_serve.py``) AS A LITERAL — the chaos
        blanket parametrize covers transients generically, but the
        lease/fence/expire sites also need the serving-layer kill/
        takeover scenarios, which only live there;
    (c) in ``serve/queue.py``, any function that mutates lease state
        (a ``"lease"``/``"token"`` key assignment, or popping the
        lease) must durably persist in the same function (``save``/
        ``write_durable``) — an in-memory-only lease transition is a
        fleet split-brain the moment two daemons read the journal."""
    faults_path = corpus.find("runtime/faults.py")
    known: set[str] = set()
    if faults_path is not None:
        sites, _ = str_tuple_assign(corpus.trees[faults_path], "KNOWN_SITES")
        known = set(sites)

    # (a) serve.* literals at fault hooks inside serve/ must be registered
    for path, tree in corpus.trees.items():
        parts = path.split("/")
        if "serve" not in parts[:-1]:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            if call_name(node) not in ("fault_point", "_io_retry"):
                continue
            site = str_const(node.args[0])
            if site is None or not site.startswith("serve."):
                continue
            if known and site not in known:
                yield Finding(
                    rule="lease-discipline",
                    path=path,
                    line=node.lineno,
                    message=f"serving fault site {site!r} is not registered "
                    f"in faults.KNOWN_SITES",
                    hint="register it (and cover it in tests/test_torch_serve.py) "
                    "or fix the typo",
                )

    # (b) registered serve.* sites must be serving-suite literals
    serve_anchor = corpus.find("tests/test_torch_serve.py")
    if serve_anchor is not None and known:
        roots: list[ast.AST] = []
        for node in ast.walk(corpus.trees[serve_anchor]):
            if isinstance(node, ast.Call):
                roots.extend(node.args)
                roots.extend(kw.value for kw in node.keywords)
            elif isinstance(node, ast.Assign):
                roots.append(node.value)
        literals = [
            lit
            for root in roots
            for sub in ast.walk(root)
            if (lit := str_const(sub)) is not None
        ]
        for site in sorted(s for s in known if s.startswith("serve.")):
            if not any(site in lit for lit in literals):
                yield Finding(
                    rule="lease-discipline",
                    path=serve_anchor,
                    line=1,
                    message=f"serving fault site {site!r} is never "
                    f"exercised by the serving suite",
                    hint="add a kill/takeover (or registry-pin) case "
                    "naming it in tests/test_torch_serve.py",
                )

    # (c) lease-state mutations in serve/queue.py persist in-function
    queue_path = corpus.find("serve/queue.py")
    if queue_path is not None:
        for fn in ast.walk(corpus.trees[queue_path]):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            line = _lease_mutation_line(fn)
            if line is None:
                continue
            persists = any(
                isinstance(n, ast.Call)
                and (
                    "save" in call_name(n)
                    or call_name(n) in ("write_durable", "replace_durable")
                )
                for n in ast.walk(fn)
            )
            if not persists:
                yield Finding(
                    rule="lease-discipline",
                    path=queue_path,
                    line=line,
                    message=f"lease state mutated in {fn.name}() without a "
                    f"durable persist in the same function",
                    hint="call save() (the journal's durable write) in the "
                    "same transaction that moves lease/token state",
                )


def _lease_mutation_line(fn: ast.AST) -> int | None:
    """First line in ``fn`` that mutates lease state: an assignment
    whose target touches a ``"lease"``/``"token"`` subscript, or a
    ``.pop("lease")`` call."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Subscript) and str_const(
                        sub.slice
                    ) in ("lease", "token"):
                        return node.lineno
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "pop"
            and node.args
            and str_const(node.args[0]) == "lease"
        ):
            return node.lineno
    return None


# ------------------------------------------------ rule: deadline discipline

# the time-stamp key family in the serving journal: anything from it
# must carry the domain suffix — "_m" (a time.monotonic() reading) or
# "_s" (a duration). A bare "deadline"/"expires" key is exactly the
# place a wall-clock reading sneaks in and survives review, because it
# works until the first NTP step (or cross-restart comparison) voids
# every expiry at once.
_STAMP_KEY_PREFIXES = ("deadline", "expires", "progress", "admitted",
                       "claimed")


@register(
    "deadline-discipline",
    "serve/ deadlines/expiries live in the monotonic domain; every "
    "journal state literal is registered and serving-suite exercised",
)
def check_deadline_discipline(corpus: Corpus) -> Iterator[Finding]:
    """Three checks, all cheap to drift past review:

    (a) STAMP-KEY NAMING: in ``serve/``, any journal key from the
        time-stamp family (deadline/expires/progress/admitted/claimed)
        must end in ``_m`` (monotonic stamp) or ``_s`` (duration) —
        the naming convention IS the domain annotation the clock rule
        cannot see across a dict boundary;
    (b) MONOTONIC DERIVATION: a function that writes a ``*_m`` key
        must read ``time.monotonic()`` in the same scope — a ``*_m``
        key fed from anything else is a lie wearing the convention;
    (c) STATE REGISTRY: every literal a ``serve/`` file assigns into a
        journal entry's ``state`` is registered in
        ``serve/queue.py`` JOB_STATES, and every registered state is
        exercised by ``tests/test_torch_serve.py`` as a literal — an
        unregistered terminal state (expired, quarantined, ...) would
        silently fall out of compaction/idle/status logic."""
    serve_paths = [
        p for p in corpus.trees
        if "serve" in p.split("/")[:-1]
    ]

    # (a) stamp-key naming
    for path in serve_paths:
        for lit, line in _dict_key_literals(corpus.trees[path]):
            if not lit.startswith(_STAMP_KEY_PREFIXES):
                continue
            if lit.endswith(("_m", "_s")):
                continue
            yield Finding(
                rule="deadline-discipline",
                path=path,
                line=line,
                message=f"time-stamp key {lit!r} without a clock-domain "
                f"suffix",
                hint="name monotonic stamps '<key>_m' and durations "
                "'<key>_s' — the suffix is the domain annotation the "
                "deadline arithmetic is checked against",
            )

    # (b) *_m keys must be derived from time.monotonic() in-function
    for path in serve_paths:
        for fn in ast.walk(corpus.trees[path]):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            line = _monotonic_stamp_assign_line(fn)
            if line is None:
                continue
            # a lease-store clock read (``store.now()`` /
            # ``store.capture_epoch()``) counts as a monotonic
            # derivation: the store IS the stamp clock (local = machine
            # monotonic; sharedfs = the calibrated fs clock), and
            # forcing raw time.monotonic() back into those functions
            # would undo exactly the domain seam host-locality guards
            mentions = any(
                (isinstance(n, ast.Attribute) and n.attr == "monotonic")
                or (isinstance(n, ast.Name) and "monotonic" in n.id)
                or (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in ("now", "capture_epoch")
                    and "store" in (expr_path(n.func.value) or "")
                )
                for n in ast.walk(fn)
            )
            if not mentions:
                yield Finding(
                    rule="deadline-discipline",
                    path=path,
                    line=line,
                    message=f"monotonic-domain key written in {fn.name}() "
                    f"without a time.monotonic() reading in scope",
                    hint="compute *_m stamps from time.monotonic() in the "
                    "same function (wall clocks void every expiry on an "
                    "NTP step)",
                )

    # (c) state-literal registry + serving-suite exercise. The
    # registry anchor is serve/states.py (the declared state machine);
    # pre-refactor corpora (the fixture corpora in tests/test_torch_lint.py)
    # that still keep JOB_STATES in serve/queue.py anchor there.
    states_anchor = corpus.find("serve/states.py")
    if states_anchor is None:
        states_anchor = corpus.find("serve/queue.py")
    if states_anchor is None:
        return
    states, states_line = str_tuple_assign(
        corpus.trees[states_anchor], "JOB_STATES"
    )
    if not states:
        yield Finding(
            rule="deadline-discipline",
            path=states_anchor,
            line=1,
            message="JOB_STATES literal tuple not found",
            hint="keep JOB_STATES a module-level tuple of string literals "
            "so the state machine stays statically checkable",
        )
        return
    state_set = set(states)
    for path in serve_paths:
        for lit, line in _journal_state_literals(corpus.trees[path]):
            if lit not in state_set:
                yield Finding(
                    rule="deadline-discipline",
                    path=path,
                    line=line,
                    message=f"journal state literal {lit!r} is not "
                    f"registered in the JOB_STATES registry "
                    f"(serve/states.py)",
                    hint="register the state (and cover it in "
                    "tests/test_torch_serve.py) or fix the typo",
                )
    serve_anchor = corpus.find("tests/test_torch_serve.py")
    if serve_anchor is None:
        return
    roots: list[ast.AST] = []
    for node in ast.walk(corpus.trees[serve_anchor]):
        if isinstance(node, ast.Call):
            roots.extend(node.args)
            roots.extend(kw.value for kw in node.keywords)
        elif isinstance(node, ast.Assign):
            roots.append(node.value)
        elif isinstance(node, ast.Compare):
            # `assert status["state"] == "expired"` is the natural way
            # a test exercises a state — comparisons count, docstrings
            # still don't (bare Expr statements are never roots)
            roots.extend(node.comparators)
    literals = [
        lit
        for root in roots
        for sub in ast.walk(root)
        if (lit := str_const(sub)) is not None
    ]
    for state in states:
        if not any(state in lit for lit in literals):
            yield Finding(
                rule="deadline-discipline",
                path=serve_anchor,
                line=1,
                message=f"journal state {state!r} is never exercised by "
                f"the serving suite",
                hint="add a test driving a job through it (or a "
                "registry-pin naming it) in tests/test_torch_serve.py",
            )


def _dict_key_literals(tree: ast.Module) -> Iterator[tuple[str, int]]:
    """String literals in DICT-KEY position: dict-literal keys,
    subscript slices, and the key arg of .get/.pop/.setdefault — the
    places a journal field name can appear."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if k is None:
                    continue
                s = str_const(k)
                if s is not None:
                    yield s, k.lineno
        elif isinstance(node, ast.Subscript):
            s = str_const(node.slice)
            if s is not None:
                yield s, node.lineno
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("get", "pop", "setdefault")
            and node.args
        ):
            s = str_const(node.args[0])
            if s is not None:
                yield s, node.lineno


def _monotonic_stamp_assign_line(fn: ast.AST) -> int | None:
    """First line in ``fn`` assigning a subscript whose literal key
    ends in ``_m`` (a monotonic stamp write)."""
    for node in ast.walk(fn):
        if not isinstance(node, (ast.Assign, ast.AugAssign)):
            continue
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Subscript):
                    s = str_const(sub.slice)
                    if s is not None and s.endswith("_m"):
                        return node.lineno
    return None


def _journal_state_literals(tree: ast.Module) -> Iterator[tuple[str, int]]:
    """State literals written INTO journal entries: ``<x>["state"] =
    "lit"`` subscript assignments, and the ``"state"`` value of any
    dict literal ASSIGNED to a name or into a container (which covers
    both ``self.jobs[id] = {"state": ...}`` and the temporary-dict
    pattern ``entry = {"state": ...}; self.jobs[id] = entry``).
    Read-side literals built inline in ``return`` expressions (status
    rendering, client pseudo-states like "submitted") are not journal
    writes and are deliberately out of scope."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if (
                isinstance(t, ast.Subscript)
                and str_const(t.slice) == "state"
            ):
                s = str_const(node.value)
                if s is not None:
                    yield s, node.lineno
        if isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                if k is not None and str_const(k) == "state":
                    s = str_const(v)
                    if s is not None:
                        yield s, node.lineno


# --------------------------------------------------------- rule: hook guard

@register(
    "hook-guard",
    "recorder span/event/xfer hooks on hot paths must be behind a "
    "single None check",
)
def check_hook_guard(corpus: Corpus) -> Iterator[Finding]:
    """The zero-cost-when-off contract (same discipline as
    ``faults.fault_point``): with tracing off, every telemetry hook in
    the per-chunk path must cost one None check — so a direct
    ``tr.span(...)`` / ``tr.event(...)`` / ``tr.xfer(...)`` on a local
    recorder variable must sit inside ``if tr is not None:`` (or the
    ``else`` of ``if tr is None:``) — dotted receivers (``ctx.tr.span``,
    ``self._recorder.event``) included, guarded on the same dotted
    path. Module-hook helpers (``emit_event``, ``fault_point``) carry
    the check internally and are exempt; a bare ``self.span(...)`` is
    the recorder's own internals and is exempt too."""
    from duplexumiconsensusreads_torch.analysis.engine import expr_path

    for path in corpus.package_paths():
        tree = corpus.trees.get(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (
                isinstance(fn, ast.Attribute)
                and fn.attr in ("span", "event", "xfer")
            ):
                continue
            var = expr_path(fn.value)
            if var is None or var == "self":
                continue  # no stable identity / recorder internals
            if not guarded_not_none(node, var):
                yield Finding(
                    rule="hook-guard",
                    path=path,
                    line=node.lineno,
                    message=f"unguarded telemetry hook {var}.{fn.attr}(...)",
                    hint=f"wrap in `if {var} is not None:` — hooks must be "
                    "a single None check when tracing is off",
                )


# ------------------------------------------------------ rule: state machine

# calls that prove (by raising JobFenced otherwise) that the entry is
# in a CLAIMED state — fence checks are from-state evidence exactly
# like an explicit state comparison
_FENCE_GUARD_CALLS = ("_check_fence", "check_fence")


def _state_views(states: list, transitions: dict) -> dict:
    """The derived state families, recomputed from the declared graph
    with the same formulas serve/states.py uses (tests/test_torch_serve.py
    pins both against the same literals, so they cannot drift apart
    silently). Keyed by the registry NAMES so membership tests like
    ``entry.get("state") in CLAIMED_STATES`` resolve to member sets.
    JOB_STATES is deliberately NOT an evidence family: membership in
    the full state set proves nothing about the from-state, and
    counting it would let `if state in JOB_STATES` launder any write
    past the terminal/undeclared checks."""
    return {
        "TERMINAL_STATES": {s for s in states if not transitions.get(s)},
        "CLAIMED_STATES": {
            s for s in states if "quarantined" in transitions.get(s, ())
        },
        "OPEN_STATES": {s for s in states if transitions.get(s)},
    }


def _from_state_evidence(fn: ast.AST, state_set: set, views: dict) -> set:
    """The set of from-states the enclosing function proves it is
    handling: literal state comparisons (``== / != / in / not in``,
    asserts included — Compare nodes all), membership tests against a
    named state family, and fence-guard calls (which prove CLAIMED)."""
    ev: set = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and call_name(n) in _FENCE_GUARD_CALLS:
            ev |= views["CLAIMED_STATES"]
        if not isinstance(n, ast.Compare):
            continue
        for e in (n.left, *n.comparators):
            s = str_const(e)
            if s is not None and s in state_set:
                ev.add(s)
            name = (
                e.id if isinstance(e, ast.Name)
                else e.attr if isinstance(e, ast.Attribute)
                else None
            )
            if name in views:
                ev |= views[name]
            if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
                for el in e.elts:
                    s = str_const(el)
                    if s is not None and s in state_set:
                        ev.add(s)
    return ev


def _is_jobs_expr(e: ast.AST) -> bool:
    return (isinstance(e, ast.Name) and e.id == "jobs") or (
        isinstance(e, ast.Attribute) and e.attr == "jobs"
    )


def _dict_reaches_jobs(node: ast.Assign, tree: ast.Module) -> bool:
    """Does this dict-literal assignment land in the jobs cache —
    directly (``jobs[x] = {...}``) or via the temporary-dict pattern
    (``entry = {...}; ... jobs[x] = entry`` in the same scope)? A
    status/response dict that never reaches the cache is read-side
    rendering, not a journal-entry creation."""
    def _into_jobs(t: ast.AST) -> bool:
        return isinstance(t, ast.Subscript) and _is_jobs_expr(t.value)

    if any(_into_jobs(t) for t in node.targets):
        return True
    names = {t.id for t in node.targets if isinstance(t, ast.Name)}
    if not names:
        return False
    scope = enclosing_function(node) or tree
    return any(
        isinstance(n, ast.Assign)
        and isinstance(n.value, ast.Name)
        and n.value.id in names
        and any(_into_jobs(t) for t in n.targets)
        for n in ast.walk(scope)
    )


def _state_write_sites(tree: ast.Module, state_set: set):
    """Yield (kind, to_states, node): "create" for a dict literal with
    a literal ``state`` key that reaches the jobs cache (direct
    subscript or accept_one's temporary-dict pattern — see
    :func:`_dict_reaches_jobs`), "transition" for a ``<x>["state"] =
    ...`` subscript write. to_states collects every registered literal
    in the written value (an IfExp write like claim's contributes all
    of its branches); writes with no registered literal are variable
    relays — unverifiable here, and the registration rule already
    polices unregistered literals."""
    for node in ast.walk(tree):
        # method-call writes: entry.update({"state": ...}) /
        # entry.update(state=...) / entry.setdefault("state", ...) —
        # the same journal move in call clothing; without these the
        # gate would be fail-open for exactly the writes a subscript
        # grep can't see
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("update", "setdefault")
        ):
            tos: set = set()
            if node.func.attr == "setdefault":
                if (
                    len(node.args) >= 2
                    and str_const(node.args[0]) == "state"
                    and (s := str_const(node.args[1])) is not None
                    and s in state_set
                ):
                    tos.add(s)
            else:
                for a in node.args:
                    if isinstance(a, ast.Dict):
                        for k, v in zip(a.keys, a.values):
                            if k is not None and str_const(k) == "state":
                                s = str_const(v)
                                if s is not None and s in state_set:
                                    tos.add(s)
                for kw in node.keywords:
                    if kw.arg == "state":
                        s = str_const(kw.value)
                        if s is not None and s in state_set:
                            tos.add(s)
            if tos:
                yield "transition", tos, node
            continue
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Subscript) and str_const(t.slice) == "state":
                tos = {
                    s for sub in ast.walk(node.value)
                    if (s := str_const(sub)) is not None and s in state_set
                }
                if tos:
                    yield "transition", tos, node
        if isinstance(node.value, ast.Dict) and _dict_reaches_jobs(
            node, tree
        ):
            for k, v in zip(node.value.keys, node.value.values):
                if k is not None and str_const(k) == "state":
                    s = str_const(v)
                    if s is not None and s in state_set:
                        yield "create", {s}, node


@register(
    "state-machine",
    "serve/ journal states move only along serve/states.py TRANSITIONS: "
    "no undeclared edges, no terminal writes, no unreachable or dead "
    "declared states",
)
def check_state_machine(corpus: Corpus) -> Iterator[Finding]:
    """The protocol model-check. serve/states.py declares the graph
    (JOB_STATES / INITIAL_STATES / TRANSITIONS); this rule rebuilds the
    graph the CODE implements — every state write in ``serve/``,
    sourced with its from-state evidence (state comparisons, asserts,
    fence-guard calls in the same function) — and diffs the two:

    (a) registry self-consistency: every state has a TRANSITIONS row,
        every edge endpoint is registered, initial states registered;
    (b) reachability: every state is reachable from the initial states
        (an unreachable state is dead protocol the sweeps/compaction
        still pay for);
    (c) every observed write is a declared edge: a creation writes an
        INITIAL state, a transition write's target is a declared
        successor of at least one evidenced from-state — and a write
        whose only evidence is terminal states is resurrecting a
        finished job;
    (d) a transition write with NO from-state evidence is itself a
        finding: un-evidenced writes are how undeclared edges ship;
    (e) dead declared edges: a declared transition no write site
        implements is protocol fiction — prune it or implement it;
    (f) the serving suite exercises the declared graph: a registry-pin
        or parametrize referencing TRANSITIONS, or per-edge
        ``"src->dst"`` literals."""
    states_path = corpus.find("serve/states.py")
    if states_path is None:
        return
    tree = corpus.trees[states_path]
    states, states_line = str_tuple_assign(tree, "JOB_STATES")
    transitions, t_line = str_dict_assign(tree, "TRANSITIONS")
    initial, _ = str_tuple_assign(tree, "INITIAL_STATES")
    if not states or not transitions:
        yield Finding(
            rule="state-machine",
            path=states_path,
            line=1,
            message="JOB_STATES / TRANSITIONS literals not found",
            hint="keep JOB_STATES a literal string tuple and TRANSITIONS "
            "a literal {state: (successor, ...)} dict so the model "
            "checker can read the declared graph",
        )
        return
    state_set = set(states)

    # (a) self-consistency
    for s in states:
        if s not in transitions:
            yield Finding(
                rule="state-machine",
                path=states_path,
                line=t_line,
                message=f"state {s!r} has no TRANSITIONS row",
                hint="every registered state needs a row — () for "
                "terminal states",
            )
    for src, succs in transitions.items():
        if src not in state_set:
            yield Finding(
                rule="state-machine",
                path=states_path,
                line=t_line,
                message=f"TRANSITIONS key {src!r} is not in JOB_STATES",
                hint="register the state or drop the row",
            )
        for dst in succs:
            if dst not in state_set:
                yield Finding(
                    rule="state-machine",
                    path=states_path,
                    line=t_line,
                    message=f"TRANSITIONS edge {src!r} -> {dst!r} targets "
                    f"an unregistered state",
                    hint="register the state or fix the typo",
                )
    roots = [s for s in initial if s in state_set] or (
        ["queued"] if "queued" in state_set else []
    )
    for s in initial:
        if s not in state_set:
            yield Finding(
                rule="state-machine",
                path=states_path,
                line=states_line,
                message=f"INITIAL_STATES entry {s!r} is not in JOB_STATES",
                hint="register the state or fix the typo",
            )

    # (b) reachability from admission
    seen = set(roots)
    frontier = list(roots)
    while frontier:
        for dst in transitions.get(frontier.pop(), ()):
            if dst in state_set and dst not in seen:
                seen.add(dst)
                frontier.append(dst)
    for s in states:
        if s not in seen:
            yield Finding(
                rule="state-machine",
                path=states_path,
                line=states_line,
                message=f"state {s!r} is unreachable from the initial "
                f"states (no admission path reaches it)",
                hint="declare a transition chain from an INITIAL_STATES "
                "entry, or drop the dead state",
            )

    # (c)/(d) observed writes vs the declared graph
    views = _state_views(states, transitions)
    initial_set = set(initial) or {"queued"}
    observed: set = set()
    serve_paths = [
        p for p in corpus.package_paths()
        if "serve" in p.split("/")[:-1] and p != states_path
    ]
    for path in serve_paths:
        for kind, tos, node in _state_write_sites(
            corpus.trees[path], state_set
        ):
            if kind == "create":
                for t in sorted(tos):
                    if t not in initial_set:
                        yield Finding(
                            rule="state-machine",
                            path=path,
                            line=node.lineno,
                            message=f"journal entry created in non-initial "
                            f"state {t!r}",
                            hint="entries are created in INITIAL_STATES "
                            "(admission); every other state must be "
                            "reached via a declared transition",
                        )
                continue
            fn = enclosing_function(node)
            ev = (
                _from_state_evidence(fn, state_set, views)
                if fn is not None else set()
            )
            if not ev:
                name = getattr(fn, "name", "<module>")
                yield Finding(
                    rule="state-machine",
                    path=path,
                    line=node.lineno,
                    message=f"state transition written in {name}() with no "
                    f"from-state evidence in scope",
                    hint="guard (or assert) the entry's current state — "
                    "or fence it — in the same function, so the "
                    "transition's source is checkable",
                )
                continue
            for t in sorted(tos):
                legal_from = {
                    f for f in ev if t in transitions.get(f, ())
                }
                if legal_from:
                    observed |= {(f, t) for f in legal_from}
                    continue
                if ev <= views["TERMINAL_STATES"]:
                    yield Finding(
                        rule="state-machine",
                        path=path,
                        line=node.lineno,
                        message=f"write of {t!r} over a terminal-state "
                        f"entry (evidence: {sorted(ev)})",
                        hint="terminal states have no successors — a "
                        "finished job's journal entry may never be "
                        "rewritten (its results/ file is the record)",
                    )
                else:
                    yield Finding(
                        rule="state-machine",
                        path=path,
                        line=node.lineno,
                        message=f"undeclared transition "
                        f"{sorted(ev)} -> {t!r}",
                        hint="declare the edge in serve/states.py "
                        "TRANSITIONS (and cover it) or fix the write",
                    )

    # (e) declared edges no code implements
    for src in states:
        for dst in transitions.get(src, ()):
            if dst in state_set and (src, dst) not in observed:
                yield Finding(
                    rule="state-machine",
                    path=states_path,
                    line=t_line,
                    message=f"declared transition {src!r} -> {dst!r} has "
                    f"no write site in serve/",
                    hint="implement the edge (a guarded state write) or "
                    "prune the declaration — a fictional edge hides "
                    "real drift",
                )

    # (f) the serving suite exercises the declared graph
    anchor = corpus.find("tests/test_torch_serve.py")
    if anchor is None:
        return
    anchor_tree = corpus.trees[anchor]
    blanket = any(
        (isinstance(n, ast.Name) and n.id == "TRANSITIONS")
        or (isinstance(n, ast.Attribute) and n.attr == "TRANSITIONS")
        for n in ast.walk(anchor_tree)
    )
    if blanket:
        return  # a registry-pin/parametrize over the table covers it
    roots_: list[ast.AST] = []
    for n in ast.walk(anchor_tree):
        if isinstance(n, ast.Call):
            roots_.extend(n.args)
            roots_.extend(kw.value for kw in n.keywords)
        elif isinstance(n, ast.Assign):
            roots_.append(n.value)
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            # `for edge in ("a->b", ...):` — the natural shape of a
            # per-edge driving loop
            roots_.append(n.iter)
        elif isinstance(n, ast.Compare):
            roots_.extend(n.comparators)
    literals = [
        lit
        for root in roots_
        for sub in ast.walk(root)
        if (lit := str_const(sub)) is not None
    ]
    for src in states:
        for dst in transitions.get(src, ()):
            edge = f"{src}->{dst}"
            if not any(edge in lit for lit in literals):
                yield Finding(
                    rule="state-machine",
                    path=anchor,
                    line=1,
                    message=f"declared transition {edge} is never "
                    f"exercised by the serving suite",
                    hint="add a test driving it (or a registry pin "
                    "walking serve.states.TRANSITIONS) in "
                    "tests/test_torch_serve.py",
                )


# ------------------------------------------------------ rule: txn discipline

# calls that hold the device, the disk, or the clock hostage: none may
# run while journal.lock is held — every other daemon's every journal
# move convoys behind it
_TXN_SLOW_CALLS = {
    "fsync", "fsync_file", "sleep", "result",
    "stream_call_consensus", "run_slice", "splice_shards", "plan_shards",
}


def _is_journal_receiver(e: ast.AST) -> bool:
    """Does this ``.save()`` receiver look like the journal queue —
    ``self`` (inside SpoolQueue) or a ``*queue*``-named handle (the
    service's ``self.queue``)? Anything else (a figure, a config
    object, a report writer) has its own save semantics and is not a
    journal persist."""
    from duplexumiconsensusreads_torch.analysis.engine import expr_path

    path = expr_path(e)
    if path is None:
        return False
    last = path.split(".")[-1]
    return last == "self" or "queue" in last.lower()


def _inside_txn(node: ast.AST) -> bool:
    """Is ``node`` lexically inside a ``with <x>._txn():`` body?"""
    for a in ancestors(node):
        if isinstance(a, (ast.With, ast.AsyncWith)) and any(
            isinstance(item.context_expr, ast.Call)
            and call_name(item.context_expr) == "_txn"
            for item in a.items
        ):
            return True
    return False


def _jobs_mutation(node: ast.AST) -> str | None:
    """Describe a mutation of the ``jobs`` journal cache, or None:
    subscript/attribute (re)assignment, ``del jobs[...]``, or a
    mutating method call on a ``jobs`` receiver (the receiver test is
    :func:`_is_jobs_expr`, shared with the state-machine rule so the
    two passes can never disagree about what the cache is)."""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        for t in targets:
            if isinstance(t, ast.Subscript) and _is_jobs_expr(t.value):
                return "jobs[...] assignment"
            if _is_jobs_expr(t):
                return "jobs cache rebind"
    if isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript) and _is_jobs_expr(t.value):
                return "del jobs[...]"
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _MUTATORS
        and _is_jobs_expr(node.func.value)
    ):
        return f"jobs.{node.func.attr}(...)"
    return None


@register(
    "txn-discipline",
    "serve/ journal/jobs-cache mutations happen inside a _txn; no slow "
    "ops or nested txn acquisition inside a txn body",
)
def check_txn_discipline(corpus: Corpus) -> Iterator[Finding]:
    """The flock'd-transaction contract (serve/queue.py \"Fleet
    transactions\"): every journal mutation is reload -> mutate ->
    durable persist under journal.lock. Three drift classes:

    (a) a ``jobs``-cache mutation or ``save()`` persist outside any
        ``with self._txn():`` body — unless the enclosing function is
        declared caller-holds-the-lock (``*_locked`` suffix, the
        ``TXN_CACHE_HELPERS`` registry in serve/queue.py, or
        ``__init__``): an untransacted mutation is the refresh()
        lost-renewal bug class, a silent fleet write race;
    (b) a slow call (fsync/sleep/compress/a future's result()/device
        dispatch) lexically inside a txn body: journal.lock serializes
        the WHOLE fleet's journal moves, so holding it across slow work
        convoys every daemon (the deliberate exception — the durable
        result write sharing mark_done's fence transaction — routes
        through write_durable, which is not in the slow-call set);
    (c) nested txn acquisition: a txn body opening another txn (a
        second ``_txn()`` with, or a call to any method that opens one)
        self-deadlocks the daemon under flock."""
    serve_paths = [
        p for p in corpus.package_paths() if "serve" in p.split("/")[:-1]
    ]
    if not serve_paths:
        return
    # methods that OPEN a transaction, collected across serve/: any
    # call to one of these inside a txn body is a nested acquisition
    txn_methods: set = set()
    for path in serve_paths:
        for fn in ast.walk(corpus.trees[path]):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and any(
                isinstance(n, (ast.With, ast.AsyncWith))
                and any(
                    isinstance(i.context_expr, ast.Call)
                    and call_name(i.context_expr) == "_txn"
                    for i in n.items
                )
                for n in ast.walk(fn)
            ):
                txn_methods.add(fn.name)
    # caller-holds-the-lock helpers declared in the queue module
    helpers: set = {"__init__"}
    queue_path = corpus.find("serve/queue.py")
    if queue_path is not None:
        declared, _ = str_tuple_assign(
            corpus.trees[queue_path], "TXN_CACHE_HELPERS"
        )
        helpers |= set(declared)

    for path in serve_paths:
        tree = corpus.trees[path]
        for node in ast.walk(tree):
            # (c) direct nesting: a txn `with` whose ancestors already
            # hold one (the call-a-txn-method form is handled below)
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(i.context_expr, ast.Call)
                and call_name(i.context_expr) == "_txn"
                for i in node.items
            ) and _inside_txn(node):
                yield Finding(
                    rule="txn-discipline",
                    path=path,
                    line=node.lineno,
                    message="nested journal transaction: `with _txn()` "
                    "inside a txn body",
                    hint="flock self-deadlocks on re-acquisition from a "
                    "second fd — one transaction owns the whole move",
                )
            # (a) mutations + persists must be transacted
            desc = _jobs_mutation(node)
            is_save = (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "save"
                and _is_journal_receiver(node.func.value)
            )
            if (desc or is_save) and not _inside_txn(node):
                fn = enclosing_function(node)
                name = getattr(fn, "name", None)
                exempt = name is not None and (
                    name.endswith("_locked") or name in helpers
                )
                if not exempt:
                    what = desc or "journal save()"
                    yield Finding(
                        rule="txn-discipline",
                        path=path,
                        line=node.lineno,
                        message=f"{what} outside a journal transaction "
                        f"in {name or '<module>'}()",
                        hint="wrap the mutation in `with self._txn():` "
                        "(or mark the helper caller-holds-the-lock: "
                        "*_locked suffix / TXN_CACHE_HELPERS)",
                    )
            if not isinstance(node, ast.Call) or not _inside_txn(node):
                continue
            name = call_name(node)
            # (b) slow ops under journal.lock
            if name in _TXN_SLOW_CALLS or "compress" in name.lower():
                yield Finding(
                    rule="txn-discipline",
                    path=path,
                    line=node.lineno,
                    message=f"slow call {name}() inside a journal "
                    f"transaction body",
                    hint="do the slow work outside the txn — "
                    "journal.lock serializes the whole fleet's "
                    "journal moves",
                )
            # (c) nested acquisition: a call to any txn-opening method
            # inside a txn body (the `self._txn()` call that opens THIS
            # body never matches — "_txn" itself opens no inner txn)
            if name in txn_methods:
                yield Finding(
                    rule="txn-discipline",
                    path=path,
                    line=node.lineno,
                    message=f"nested journal transaction: {name}() "
                    f"opens a txn inside a txn body",
                    hint="flock self-deadlocks on re-acquisition "
                    "from a second fd — restructure so one "
                    "transaction owns the whole move",
                )


# ------------------------------------------------------ rule: fence dominance

# the durable job-path commits: every one must carry the caller's lease
# identity (daemon_id + fencing token — the journal transaction fences
# on them) or run under the shared fenced-renewal guard
_PUBLISH_CALLS = {
    "mark_done", "mark_failed", "mark_expired", "requeue",
    "register_shards",
}
# the registered fence helpers: a call to any of these in the same
# function dominates the publish (worker.fenced_renew is THE shared
# guard; the queue-internal _check_fence is the transaction-side check)
_FENCE_CALLS = {"fenced_renew", "_fenced_renew", "verify_lease",
                "_check_fence"}


@register(
    "fence-dominance",
    "serve/ durable publishes (mark_*/requeue/register_shards) must be "
    "fenced: lease identity passed, or a fenced-renew guard in scope",
)
def check_fence_dominance(corpus: Corpus) -> Iterator[Finding]:
    """The zombie-writer gate: a daemon that lost its lease must not be
    able to publish, requeue or journal ANYTHING for the job (the
    reclaiming daemon owns it now). The queue's mutating methods fence
    inside their transaction — but only when the caller passes its
    lease identity, so an identity-less call site is an unfenced escape
    hatch that ships silently and loses a race years later. Every call
    to a publish-family method outside serve/queue.py must therefore
    (a) mention the lease identity (a ``token``/``daemon_id`` name in
    its arguments), or (b) sit in a function that runs a registered
    fence guard (``fenced_renew``/``verify_lease``) itself."""
    for path in corpus.package_paths():
        if "serve" not in path.split("/")[:-1] or path.endswith(
            "serve/queue.py"
        ):
            continue
        tree = corpus.trees[path]
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) not in _PUBLISH_CALLS:
                continue
            args: list[ast.AST] = list(node.args) + [
                kw.value for kw in node.keywords
            ]
            kw_names = [kw.arg for kw in node.keywords if kw.arg]
            fenced = any(
                "token" in n or "daemon" in n
                for n in kw_names
            ) or any(
                ("token" in sub.id.lower() or "daemon" in sub.id.lower())
                if isinstance(sub, ast.Name)
                else ("token" in sub.attr.lower()
                      or "daemon" in sub.attr.lower())
                if isinstance(sub, ast.Attribute)
                else False
                for a in args
                for sub in ast.walk(a)
            )
            if not fenced:
                fn = enclosing_function(node)
                scope = fn if fn is not None else tree
                fenced = any(
                    isinstance(n, ast.Call)
                    and call_name(n) in _FENCE_CALLS
                    for n in ast.walk(scope)
                )
            if not fenced:
                yield Finding(
                    rule="fence-dominance",
                    path=path,
                    line=node.lineno,
                    message=f"unfenced durable publish "
                    f"{call_name(node)}(...)",
                    hint="pass the slice's lease identity (daemon_id + "
                    "token — the journal txn fences on them) or guard "
                    "the function with fenced_renew",
                )


# -------------------------------------------------- rule: exception contract

# the exceptions whose HANDLING is part of the protocol, not local
# style. "base": the exact declared base class — JobFenced/InjectedKill
# are BaseException precisely so no `except Exception` ladder can
# absorb a modelled kill or a fence abort; changing the base voids the
# kill-equals-SIGKILL and zombie-fencing contracts everywhere at once.
# "reraise": deterministic invariant violations — a retry re-derives
# the identical failure, so any handler naming them must re-raise
# immediately, and no broad handler may sit between a raising call and
# its re-raise guard.
CONTRACT_EXCEPTIONS = {
    "JobFenced": {"base": "BaseException", "reraise": False},
    "InjectedKill": {"base": "BaseException", "reraise": False},
    "D2hCompactionOverflow": {"base": "RuntimeError", "reraise": True},
}


def _handler_type_names(type_node: ast.AST | None) -> set:
    names: set = set()
    if type_node is None:
        return names
    nodes = (
        list(type_node.elts) if isinstance(type_node, ast.Tuple)
        else [type_node]
    )
    for n in nodes:
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
    return names


def _raised_name(exc: ast.AST | None) -> str | None:
    if exc is None:
        return None
    if isinstance(exc, ast.Call):
        return call_name(exc)
    if isinstance(exc, ast.Name):
        return exc.id
    if isinstance(exc, ast.Attribute):
        return exc.attr
    return None


@register(
    "exception-contract",
    "runtime//serve/ handlers honour the contract exceptions: "
    "BaseException kills stay unabsorbed, deterministic overflows "
    "re-raise immediately",
)
def check_exception_contract(corpus: Corpus) -> Iterator[Finding]:
    """Walks every handler in ``runtime/`` + ``serve/`` against
    :data:`CONTRACT_EXCEPTIONS`:

    (a) each contract exception's class keeps its declared base — a
        JobFenced quietly rebased onto Exception would be absorbed by
        every job-scoped ``except Exception`` and break zombie fencing
        with no test noticing until a takeover race lands;
    (b) no bare ``except:`` — it absorbs the BaseException contracts
        (InjectedKill's kill-equals-SIGKILL model, JobFenced aborts);
    (c) an ``except BaseException`` handler must re-raise or capture
        its exception (store-and-reraise, the service's fatal-path
        idiom) — silently swallowing one un-models a kill;
    (d) a handler naming a re-raise-immediately exception must have
        ``raise`` as its FIRST statement: log-then-retry on a
        deterministic overflow burns the whole retry/isolation ladder
        re-deriving one invariant violation;
    (e) a ``try`` whose body calls a function that (transitively, one
        wrapper hop) raises a re-raise-immediately exception must not
        absorb it in a broad Exception/BaseException handler without a
        dedicated re-raise handler first — the retry-ladder shape that
        motivated the contract."""
    scoped = [
        p for p in corpus.package_paths()
        if {"runtime", "serve"} & set(p.split("/")[:-1])
    ]
    reraise_names = {
        name for name, spec in CONTRACT_EXCEPTIONS.items() if spec["reraise"]
    }

    # (a) declared bases
    for path in scoped:
        for node in ast.walk(corpus.trees[path]):
            if not isinstance(node, ast.ClassDef):
                continue
            spec = CONTRACT_EXCEPTIONS.get(node.name)
            if spec is None:
                continue
            bases = {
                b.id if isinstance(b, ast.Name)
                else b.attr if isinstance(b, ast.Attribute) else "?"
                for b in node.bases
            }
            if spec["base"] not in bases:
                yield Finding(
                    rule="exception-contract",
                    path=path,
                    line=node.lineno,
                    message=f"{node.name} must derive {spec['base']} "
                    f"(declared contract), found {sorted(bases)}",
                    hint="the exception's BASE is the contract: "
                    "BaseException contracts must sail through every "
                    "`except Exception` ladder",
                )

    # direct raisers of re-raise-immediately exceptions, plus one
    # wrapper hop (the unpack()-style local adapters the retry ladders
    # actually call); deeper call chains end at a job boundary where
    # failing the job IS the contract, so propagation stops here
    direct: set = set()
    for path in scoped:
        for fn in ast.walk(corpus.trees[path]):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if any(
                isinstance(n, ast.Raise)
                and _raised_name(n.exc) in reraise_names
                for n in ast.walk(fn)
            ):
                direct.add(fn.name)
    raisers = set(direct)
    for path in scoped:
        for fn in ast.walk(corpus.trees[path]):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in direct:
                continue
            if any(
                isinstance(n, ast.Call) and call_name(n) in direct
                for n in ast.walk(fn)
            ):
                raisers.add(fn.name)

    for path in scoped:
        tree = corpus.trees[path]
        for node in ast.walk(tree):
            # (b)/(c)/(d) per handler
            if isinstance(node, ast.ExceptHandler):
                if node.type is None:
                    yield Finding(
                        rule="exception-contract",
                        path=path,
                        line=node.lineno,
                        message="bare `except:` absorbs the BaseException "
                        "contracts (InjectedKill, JobFenced)",
                        hint="catch the exception classes you mean; a "
                        "modelled kill must leave real-SIGKILL state",
                    )
                    continue
                names = _handler_type_names(node.type)
                if "BaseException" in names:
                    reraises = any(
                        isinstance(n, ast.Raise)
                        for stmt in node.body
                        for n in ast.walk(stmt)
                    )
                    captures = node.name is not None and any(
                        isinstance(n, ast.Name) and n.id == node.name
                        for stmt in node.body
                        for n in ast.walk(stmt)
                    )
                    if not (reraises or captures):
                        yield Finding(
                            rule="exception-contract",
                            path=path,
                            line=node.lineno,
                            message="except BaseException handler neither "
                            "re-raises nor captures the exception",
                            hint="re-raise (cleanup handlers) or store it "
                            "for the fatal path (the service's "
                            "_fatal idiom) — never swallow a kill",
                        )
                hit = names & reraise_names
                if hit:
                    first = node.body[0] if node.body else None
                    ok = isinstance(first, ast.Raise) and (
                        first.exc is None
                        or (
                            isinstance(first.exc, ast.Name)
                            and first.exc.id == node.name
                        )
                    )
                    if not ok:
                        yield Finding(
                            rule="exception-contract",
                            path=path,
                            line=node.lineno,
                            message=f"handler for {sorted(hit)} must "
                            f"re-raise immediately (first statement)",
                            hint="deterministic invariant violations "
                            "re-derive identically — retrying or "
                            "logging-then-continuing burns the ladder "
                            "for nothing",
                        )
                continue
            # (e) retry-ladder absorption
            if not isinstance(node, ast.Try):
                continue
            body_calls = {
                call_name(n)
                for stmt in node.body
                for n in ast.walk(stmt)
                if isinstance(n, ast.Call)
            }
            risky = body_calls & raisers
            if not risky:
                continue
            for h in node.handlers:
                names = _handler_type_names(h.type)
                if names & reraise_names:
                    break  # dedicated guard precedes the broad ladder
                broad = h.type is None or {
                    "Exception", "BaseException"
                } & names
                if broad and not any(
                    isinstance(n, ast.Raise)
                    for stmt in h.body
                    for n in ast.walk(stmt)
                ):
                    yield Finding(
                        rule="exception-contract",
                        path=path,
                        line=h.lineno,
                        message=f"broad handler may absorb "
                        f"{sorted(reraise_names)} raised by "
                        f"{sorted(risky)}()",
                        hint="add `except D2hCompactionOverflow: raise` "
                        "(the deterministic-failure guard) before the "
                        "broad retry handler",
                    )
                    break


# ---------------------------------------------- rule: host locality

# The primitives the LOCAL lease backend stands on — pid-liveness
# probes and raw machine-monotonic readings compared against journal
# stamps — are exactly the operations that silently lie on a
# shared-filesystem spool: a pid is only meaningful on the host that
# spawned it, and two hosts' time.monotonic() epochs are unrelated
# numbers. The store seam (serve/store.py) exists so those operations
# have ONE home; this rule keeps them from leaking back into the
# serving layer, where they would work perfectly in every single-host
# test and corrupt the first multi-host deployment.
_XHOST_SITES = ("serve.hb", "serve.store")


@register(
    "host-locality",
    "pid-liveness probes and raw monotonic-vs-journal-stamp arithmetic "
    "are confined to the lease-store backend; the cross-host I/O sites "
    "are registered",
)
def check_host_locality(corpus: Corpus) -> Iterator[Finding]:
    """Four checks, each a way single-host assumptions re-enter serve/:

    (a) PID LIVENESS: ``serve/`` code outside ``serve/store.py`` must
        not call ``os.kill`` or ``_pid_alive`` — liveness belongs to
        the store (``store.pid_alive``/``store.observe``), which is the
        only place that knows whether a pid means anything on this
        spool (``os.getpid()`` as an identity read stays legal);
    (b) PID COMPARISON: comparing a journal record's ``"pid"`` field
        is a liveness/ownership decision in disguise — on a sharedfs
        spool two hosts can share a pid number, so the comparison
        must go through the store's reclaim verdict;
    (c) CLOCK-DOMAIN MIXING: an expression combining a direct
        ``time.monotonic()`` reading with a ``*_m`` journal-key read
        compares the local machine clock against the spool's stamp
        domain — correct locally, garbage cross-host. Stamp
        arithmetic must use ``store.now()`` (rule 8(b) accepts it as
        the monotonic derivation);
    (d) SITE REGISTRY: when the store backend exists, its two durable
        I/O steps (``serve.hb`` heartbeat write, ``serve.store``
        liveness scan) must be in runtime/faults.py KNOWN_SITES —
        registration is what routes them into the chaos blanket that
        proves the takeover ladders survive injected faults."""
    scoped = [
        p for p in corpus.trees
        if "serve" in p.split("/")[:-1] and p.split("/")[-1] != "store.py"
    ]

    def _key_reads(node: ast.AST) -> Iterator[str]:
        # literal dict-key reads: x["k"] subscripts and x.get("k")
        for sub in ast.walk(node):
            if isinstance(sub, ast.Subscript):
                s = str_const(sub.slice)
                if s is not None:
                    yield s
            elif (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "get"
                and sub.args
            ):
                s = str_const(sub.args[0])
                if s is not None:
                    yield s

    def _reads_monotonic(node: ast.AST) -> bool:
        return any(
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "monotonic"
            for sub in ast.walk(node)
        )

    for path in scoped:
        flagged: set[tuple[str, int]] = set()
        for node in ast.walk(corpus.trees[path]):
            # (a) pid-liveness probes
            if isinstance(node, ast.Call):
                callee = expr_path(node.func)
                if callee == "os.kill" or call_name(node) == "_pid_alive":
                    yield Finding(
                        rule="host-locality",
                        path=path,
                        line=node.lineno,
                        message=f"pid-liveness probe "
                        f"({callee or call_name(node)}) outside the "
                        f"lease-store backend",
                        hint="route liveness through the store seam "
                        "(store.pid_alive / store.observe / "
                        "store.reclaim_reason) — a pid only means "
                        "anything on the host that spawned it",
                    )
                continue
            if not isinstance(node, (ast.Compare, ast.BinOp)):
                continue
            keys = set(_key_reads(node))
            # (b) ownership decisions off a journal "pid" field
            if (
                isinstance(node, ast.Compare)
                and "pid" in keys
                and ("pid", node.lineno) not in flagged
            ):
                flagged.add(("pid", node.lineno))
                yield Finding(
                    rule="host-locality",
                    path=path,
                    line=node.lineno,
                    message="comparison against a journal 'pid' field "
                    "outside the lease-store backend",
                    hint="pid ownership checks are liveness decisions — "
                    "they belong to store.reclaim_reason, where the "
                    "backend knows whether pids are comparable on "
                    "this spool",
                )
            # (c) machine clock vs stamp-domain arithmetic
            if (
                _reads_monotonic(node)
                and any(k.endswith("_m") for k in keys)
                and ("mono", node.lineno) not in flagged
            ):
                flagged.add(("mono", node.lineno))
                yield Finding(
                    rule="host-locality",
                    path=path,
                    line=node.lineno,
                    message="time.monotonic() compared/combined with a "
                    "*_m journal stamp",
                    hint="journal stamps live in the spool store's clock "
                    "domain — use store.now() for the other operand "
                    "(on a sharedfs spool the machine clock is an "
                    "unrelated epoch)",
                )
    # (d) cross-host I/O sites registered (only once the backend exists:
    # the pre-fleet fixture corpora in tests/test_torch_lint.py have no
    # serve/store.py and owe no sites)
    if corpus.find("serve/store.py") is None:
        return
    faults_anchor = corpus.find("runtime/faults.py")
    if faults_anchor is None:
        return
    sites, sites_line = str_tuple_assign(
        corpus.trees[faults_anchor], "KNOWN_SITES"
    )
    for site in _XHOST_SITES:
        if site not in sites:
            yield Finding(
                rule="host-locality",
                path=faults_anchor,
                line=sites_line or 1,
                message=f"cross-host fleet site {site!r} is not "
                f"registered in KNOWN_SITES",
                hint="register it — the chaos blanket "
                "(tests/test_torch_chaos.py) exercises every registered "
                "site, which is what proves the pid-free takeover "
                "ladders survive injected faults",
            )


# ----------------------------------------- rule: thread-confinement

# device/dispatch entry points: work only roles holding the "device"
# effect grant may perform (a device call from an ungranted thread
# races the mesh dispatch and voids the single-dispatcher ordering
# argument the byte-identity proofs rest on)
_DEVICE_CALLS = {
    "device_put", "block_until_ready", "sharded_pipeline",
    "presharded_pipeline", "start_fetch", "dispatch_chunk",
    "materialize", "materialise", "fetch_outputs",
    # the port's own dispatch seams and hand-written kernel wrappers
    "fused_pipeline", "pack_fetch_outputs", "_mesh_put",
    "segment_gemm", "directional_cluster",
}
# a callee under this prefix touches the card (synchronize, streams,
# events, the allocator): the port's counterpart of ``jax.*``
_DEVICE_PREFIX = "torch.cuda."

# durable-state moves requiring the "durable" grant: per-chunk
# checkpoint marks and durable writes — exactly-once resume is proven
# over declared-role commit order, and an ungranted thread's mark
# would commit a chunk its owner has not finished
_DURABLE_MOVE_CALLS = {
    "mark", "save", "write_durable", "replace_durable", "rewrite_from",
}

# flock'd journal transactions require the "journal" grant (the serve
# fleet's txn seam; rule 10 checks what happens INSIDE the txn body,
# this rule checks WHO may open one)
_JOURNAL_CALLS = {"_txn", "txn"}


def _thread_roles(corpus: Corpus):
    """(knobs_path, THREAD_ROLES dict) read FROM THE CORPUS — never
    imported, so fixture corpora declare their own miniature
    registries. (None, None) when runtime/knobs.py is absent;
    (path, None) when present but the literal is unreadable."""
    path = corpus.find("runtime/knobs.py")
    if path is None:
        return None, None
    roles = literal_assign(corpus.trees[path], "THREAD_ROLES")
    if not isinstance(roles, dict) or not roles:
        return path, None
    return path, roles


@register(
    "thread-confinement",
    "every declared thread role's transitive call scope stays inside "
    "its allowed effects, shared structures and locks",
)
def check_thread_confinement(corpus: Corpus) -> Iterator[Finding]:
    """The declared thread-confinement model: ``THREAD_ROLES`` in
    runtime/knobs.py maps each thread-entry function (xfer/drain pool
    bodies, the ``dut-ingest`` producer, heartbeat, the serve
    watchdog/workers — the ingest producer's contract is its own
    row) to its allowed effects, and this rule walks each entry's
    transitive same-file call scope against the row:

    (a) a device/dispatch call without the "device" grant, a durable
        state move without "durable", a journal txn without "journal";
    (b) touching a structure another role declared (the per-module
        union of ``shared`` names is the watched set) without
        declaring it, or touching a declared one outside its declared
        ``with <lock>:`` body (lock "" = self-synchronizing);
    (c) for roles with a declared ``handoff`` queue: putting to any
        other queue bypasses the one audited seam.

    Rename protection: a registry row whose entry function is gone
    while its thread-name marker is still in the module has renamed
    the anchor out from under the rule — a finding, not a skip. A
    corpus with no THREAD_ROLES at all owes nothing (pre-registry
    fixtures), unless a file still references the registry name."""
    knobs_path, roles = _thread_roles(corpus)
    if roles is None:
        if knobs_path is not None and (
            "THREAD_ROLES" in corpus.sources[knobs_path]
        ):
            yield Finding(
                rule="thread-confinement",
                path=knobs_path,
                line=1,
                message="THREAD_ROLES is present but not a readable "
                "literal dict",
                hint="keep the registry a PURE literal — the rule reads "
                "it from the parsed corpus, never by import",
            )
            return
        # pre-registry corpora owe nothing; but a tree that still
        # NAMES the registry while the literal is gone has deleted the
        # model out from under its machinery
        for path in sorted(corpus.trees):
            if path == knobs_path:
                continue
            if "THREAD_ROLES" in corpus.sources[path]:
                yield Finding(
                    rule="thread-confinement",
                    path=path,
                    line=1,
                    message="THREAD_ROLES is referenced but "
                    "runtime/knobs.py declares no readable literal",
                    hint="restore the THREAD_ROLES literal in "
                    "runtime/knobs.py — the thread model must stay "
                    "declared",
                )
        return

    # per-module watched set: the union of every role's shared names —
    # what ANY role owns, every other role in that module must declare
    # before touching
    watched_by_module: dict[str, set[str]] = {}
    for role, row in roles.items():
        if not isinstance(row, dict):
            continue
        for pair in row.get("shared", ()):
            watched_by_module.setdefault(
                str(row.get("module", "")), set()
            ).add(str(pair[0]))

    for role in sorted(roles):
        row = roles[role]
        if not (
            isinstance(row, dict)
            and isinstance(row.get("module"), str)
            and row.get("module")
            and "entry" in row
        ):
            yield Finding(
                rule="thread-confinement",
                path=knobs_path,
                line=1,
                message=f"THREAD_ROLES[{role!r}] is malformed "
                f"(needs module/entry/may/shared)",
                hint="see runtime/knobs.py's field contract",
            )
            continue
        mod_path = corpus.find(row["module"])
        if mod_path is None:
            continue  # fixture corpora may carry a module subset
        entry = str(row["entry"])
        if not entry:
            continue  # the main loop: an ownership row, not walked
        tree = corpus.trees[mod_path]
        defs = function_defs(tree)
        marker = str(row.get("marker", ""))
        if entry not in defs:
            if marker and marker in corpus.sources[mod_path]:
                yield Finding(
                    rule="thread-confinement",
                    path=mod_path,
                    line=1,
                    message=f"thread marker {marker!r} present but the "
                    f"declared {role!r} entry {entry}() is gone",
                    hint="keep the thread body in a function named as "
                    "declared in THREAD_ROLES — it anchors the "
                    "confinement walk",
                )
            continue
        may = {str(m) for m in row.get("may", ())}
        allowed = {
            str(p[0]): (str(p[1]) if len(p) > 1 else "")
            for p in row.get("shared", ())
        }
        handoff = str(row.get("handoff", ""))
        watched = watched_by_module.get(row["module"], set())
        for fn in reachable_functions(defs, entry):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    name = call_name(node)
                    callee = expr_path(node.func) or name
                    if (
                        name in _DEVICE_CALLS
                        or callee.startswith(_DEVICE_PREFIX)
                    ) and "device" not in may:
                        yield Finding(
                            rule="thread-confinement",
                            path=mod_path,
                            line=node.lineno,
                            message=f"device/dispatch call {callee}() in "
                            f"the {role!r} thread scope ({fn.name}) "
                            f"without the 'device' grant",
                            hint="device work belongs to roles declaring "
                            "'device' in THREAD_ROLES (single-"
                            "dispatcher ordering)",
                        )
                    elif name in _DURABLE_MOVE_CALLS and "durable" not in may:
                        yield Finding(
                            rule="thread-confinement",
                            path=mod_path,
                            line=node.lineno,
                            message=f"durable state move {callee}() in "
                            f"the {role!r} thread scope ({fn.name}) "
                            f"without the 'durable' grant",
                            hint="checkpoint marks / durable writes "
                            "commit only from roles declaring 'durable' "
                            "— anything else breaks exactly-once resume",
                        )
                    elif name in _JOURNAL_CALLS and "journal" not in may:
                        yield Finding(
                            rule="thread-confinement",
                            path=mod_path,
                            line=node.lineno,
                            message=f"journal txn {callee}() in the "
                            f"{role!r} thread scope ({fn.name}) without "
                            f"the 'journal' grant",
                            hint="only roles declaring 'journal' may "
                            "open the flock'd journal transaction",
                        )
                    elif (
                        handoff
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("put", "put_nowait")
                    ):
                        recv = expr_path(node.func.value) or ""
                        if not recv.endswith(handoff):
                            yield Finding(
                                rule="thread-confinement",
                                path=mod_path,
                                line=node.lineno,
                                message=f"{role!r} thread puts to "
                                f"{recv or '?'!r} — not its declared "
                                f"handoff queue ({handoff})",
                                hint="the declared handoff queue is the "
                                "role's only legal output channel",
                            )
                elif isinstance(node, ast.Name) and node.id in watched:
                    if node.id not in allowed:
                        yield Finding(
                            rule="thread-confinement",
                            path=mod_path,
                            line=node.lineno,
                            message=f"shared structure {node.id!r} "
                            f"touched in the {role!r} thread scope "
                            f"({fn.name}) but not declared in its "
                            f"THREAD_ROLES row",
                            hint="declare the (structure, lock) pair in "
                            "the role's shared list — or keep the "
                            "structure out of that thread's lane",
                        )
                    else:
                        lock = allowed[node.id]
                        if lock and not inside_named_lock(node, lock):
                            yield Finding(
                                rule="thread-confinement",
                                path=mod_path,
                                line=node.lineno,
                                message=f"shared structure {node.id!r} "
                                f"touched in the {role!r} thread scope "
                                f"({fn.name}) outside its declared "
                                f"lock ({lock})",
                                hint=f"wrap the access in "
                                f"`with {lock}:` — the registry says "
                                f"that lock guards this structure",
                            )


# ------------------------------------------------- rule: knob-taint

# the canonical surface vocabulary (mirrored from runtime/knobs.py
# SURFACES; the corpus declaration wins when present)
_KNOWN_SURFACES = (
    "fingerprint", "spec_signature", "provenance", "job_config",
    "streaming_only",
)


def _knob_table(corpus: Corpus):
    """(knobs_path, KNOB_TABLE dict, assign lineno) read FROM THE
    CORPUS — same contract as :func:`_thread_roles`."""
    path = corpus.find("runtime/knobs.py")
    if path is None:
        return None, None, 0
    tree = corpus.trees[path]
    table = literal_assign(tree, "KNOB_TABLE")
    line = 1
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "KNOB_TABLE"
                for t in node.targets
            )
        ):
            line = node.lineno
            break
    if not isinstance(table, dict) or not table:
        return path, None, line
    return path, table, line


def _fn_scan(fn: ast.AST):
    """(name_lines, literal_lines, kwarg_lines) for one function body:
    every Name id, string literal, and keyword-argument name, each
    mapped to its first line — the evidence a knob 'reaches' a
    determinism-surface constructor."""
    names: dict[str, int] = {}
    lits: dict[str, int] = {}
    kwargs: dict[str, int] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            names.setdefault(node.id, node.lineno)
        s = str_const(node)
        if s is not None:
            lits.setdefault(s, node.lineno)
        if isinstance(node, ast.Call):
            for kw in node.keywords or ():
                if kw.arg:
                    kwargs.setdefault(kw.arg, node.lineno)
    return names, lits, kwargs


def _imports_knobs(tree: ast.Module) -> bool:
    """Does this module import the knob registry (``from ...runtime
    import knobs`` / ``from ...runtime.knobs import ...``)? The
    evidence that a surface constructor is table-driven."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.endswith("runtime.knobs") or mod.endswith(".knobs"):
                return True
            if mod.endswith("runtime") and any(
                a.name == "knobs" for a in node.names
            ):
                return True
        elif isinstance(node, ast.Import):
            if any(a.name.endswith(".knobs") for a in node.names):
                return True
    return False


@register(
    "knob-taint",
    "every execution knob is declared in runtime/knobs.py and reaches "
    "exactly its declared determinism surfaces",
)
def check_knob_taint(corpus: Corpus) -> Iterator[Finding]:
    """The knob registry model-check: ``KNOB_TABLE`` declares every
    execution knob's class (semantic | scheduling) and its membership
    in each determinism surface; this rule walks the surface
    constructors against it:

    (a) table sanity — every row's class and surfaces are from the
        declared vocabulary;
    (b) the checkpoint fingerprint (runtime/stream.py
        ``_fingerprint``): a knob reaching it must declare the
        ``fingerprint`` surface (for a scheduling knob that is the
        taint this rule exists to catch — resumes would refuse
        byte-identical work); a declared knob must actually reach it
        (by parameter name, or via ``dataclasses.asdict`` for
        ``via: params`` knobs);
    (c) the compile identity (serve/job.py ``spec_signature``): config
        keys used == keys declared, both directions;
    (d) the provenance line (serve/job.py ``serve_provenance``): any
        knob special-cased by literal while its row excludes the
        ``provenance`` surface is a hand-rolled exclusion — surface
        membership lives in the registry, not in the constructor;
    (e) the job config (serve/job.py ``CONFIG_DEFAULTS``): a literal
        dict must match the declared ``job_config`` set exactly; a
        derived one must come from the registry (knobs import);
    (f) the CLI's resolution closed world: every ``opt("...")``
        literal in cli/main.py is a declared knob, and the
        streaming-only refusals are table-driven;
    (g) coverage pin (TRANSITIONS-style): every declared scheduling
        job knob is exercised by name in the linted test anchors —
        the byte-identity matrix is the proof scheduling knobs are
        byte-neutral, so an unexercised one is an unproved claim."""
    knobs_path, table, table_line = _knob_table(corpus)
    if table is None:
        if knobs_path is not None and (
            "KNOB_TABLE" in corpus.sources[knobs_path]
        ):
            yield Finding(
                rule="knob-taint",
                path=knobs_path,
                line=table_line,
                message="KNOB_TABLE is present but not a readable "
                "literal dict",
                hint="keep the registry a PURE literal — the rule reads "
                "it from the parsed corpus, never by import",
            )
            return
        for path in sorted(corpus.trees):
            if path == knobs_path:
                continue
            if "KNOB_TABLE" in corpus.sources[path]:
                yield Finding(
                    rule="knob-taint",
                    path=path,
                    line=1,
                    message="KNOB_TABLE is referenced but "
                    "runtime/knobs.py declares no readable literal",
                    hint="restore the KNOB_TABLE literal in "
                    "runtime/knobs.py — the knob surfaces must stay "
                    "declared",
                )
        return

    surfaces_vocab = set(_KNOWN_SURFACES)
    declared_vocab, _ = str_tuple_assign(
        corpus.trees[knobs_path], "SURFACES"
    )
    if declared_vocab:
        surfaces_vocab = set(declared_vocab)

    # (a) table sanity
    rows: dict[str, dict] = {}
    for name in table:
        row = table[name]
        if not isinstance(row, dict) or row.get("class") not in (
            "semantic", "scheduling"
        ):
            yield Finding(
                rule="knob-taint",
                path=knobs_path,
                line=table_line,
                message=f"knob {name!r} has no valid class "
                f"(semantic | scheduling)",
                hint="every knob declares its class — it decides which "
                "surfaces the knob may legally reach",
            )
            continue
        bad = set(row.get("surfaces", ())) - surfaces_vocab
        if bad:
            yield Finding(
                rule="knob-taint",
                path=knobs_path,
                line=table_line,
                message=f"knob {name!r} declares unknown surface(s) "
                f"{sorted(bad)}",
                hint=f"the surface vocabulary is {sorted(surfaces_vocab)}",
            )
            continue
        rows[name] = row

    def surf(name: str) -> set:
        return set(rows[name].get("surfaces", ()))

    # (b) the checkpoint fingerprint
    stream_path = corpus.find("runtime/stream.py")
    fp_fn = None
    if stream_path is not None:
        fp_fn = function_defs(corpus.trees[stream_path]).get("_fingerprint")
    if fp_fn is not None:
        names, lits, kwargs = _fn_scan(fp_fn)
        asdict_line = 0
        for node in ast.walk(fp_fn):
            if isinstance(node, ast.Call) and call_name(node) == "asdict":
                asdict_line = node.lineno
                break
        for name in rows:
            key = rows[name].get("stream_kwarg") or name
            declared = "fingerprint" in surf(name)
            at = names.get(key) or lits.get(key) or kwargs.get(key)
            if declared and rows[name].get("via") == "params":
                if not asdict_line:
                    yield Finding(
                        rule="knob-taint",
                        path=stream_path,
                        line=fp_fn.lineno,
                        message=f"knob {name!r} declares the fingerprint "
                        f"surface via params but _fingerprint has no "
                        f"dataclasses.asdict() evidence",
                        hint="via:'params' knobs reach the fingerprint "
                        "through asdict(GroupingParams/ConsensusParams) "
                        "— keep that call, or redeclare the route",
                    )
            elif declared and at is None:
                yield Finding(
                    rule="knob-taint",
                    path=stream_path,
                    line=fp_fn.lineno,
                    message=f"knob {name!r} declares the fingerprint "
                    f"surface but never reaches _fingerprint",
                    hint="thread it through _fingerprint (or drop the "
                    "surface from its KNOB_TABLE row) — a declared-but-"
                    "absent semantic knob lets resume splice shards "
                    "computed under different semantics",
                )
            elif not declared and at is not None:
                if rows[name]["class"] == "scheduling":
                    yield Finding(
                        rule="knob-taint",
                        path=stream_path,
                        line=at,
                        message=f"scheduling knob {name!r} taints the "
                        f"checkpoint fingerprint",
                        hint="scheduling knobs are byte-neutral by "
                        "contract — fingerprinting one makes resume "
                        "refuse byte-identical work; drop it from "
                        "_fingerprint",
                    )
                else:
                    yield Finding(
                        rule="knob-taint",
                        path=stream_path,
                        line=at,
                        message=f"knob {name!r} reaches _fingerprint but "
                        f"does not declare the fingerprint surface",
                        hint="declare the surface in its KNOB_TABLE row "
                        "— the registry states shipped behaviour",
                    )

    # (c)+(d)+(e): the serve-side surfaces
    job_path = corpus.find("serve/job.py")
    if job_path is not None:
        job_tree = corpus.trees[job_path]
        job_defs = function_defs(job_tree)
        sig_fn = job_defs.get("spec_signature")
        if sig_fn is not None:
            _, lits, kwargs = _fn_scan(sig_fn)
            for name in rows:
                declared = "spec_signature" in surf(name)
                at = lits.get(name) or kwargs.get(name)
                if declared and at is None:
                    yield Finding(
                        rule="knob-taint",
                        path=job_path,
                        line=sig_fn.lineno,
                        message=f"knob {name!r} declares the "
                        f"spec_signature surface but spec_signature "
                        f"never reads it",
                        hint="geometry-bearing knobs must join the "
                        "compile identity — two jobs differing in one "
                        "must not share XLA programs",
                    )
                elif at is not None and not declared:
                    yield Finding(
                        rule="knob-taint",
                        path=job_path,
                        line=at,
                        message=f"knob {name!r} joins spec_signature "
                        f"without declaring the surface",
                        hint="declare spec_signature in its KNOB_TABLE "
                        "row — undeclared signature members split the "
                        "compile cache silently",
                    )
        prov_fn = job_defs.get("serve_provenance")
        if prov_fn is not None:
            _, lits, kwargs = _fn_scan(prov_fn)
            for name in rows:
                at = lits.get(name) or kwargs.get(name)
                if at is not None and "provenance" not in surf(name):
                    yield Finding(
                        rule="knob-taint",
                        path=job_path,
                        line=at,
                        message=f"serve_provenance special-cases knob "
                        f"{name!r}, whose row excludes the provenance "
                        f"surface",
                        hint="surface membership is declared in "
                        "runtime/knobs.py — serve_provenance iterates "
                        "the registry, it does not hand-roll knob "
                        "exclusions",
                    )
        cd = literal_assign(job_tree, "CONFIG_DEFAULTS")
        declared_jc = {n for n in rows if "job_config" in surf(n)}
        if isinstance(cd, dict):
            extra = set(cd) - declared_jc
            missing = declared_jc - set(cd)
            for name in sorted(extra):
                yield Finding(
                    rule="knob-taint",
                    path=job_path,
                    line=1,
                    message=f"CONFIG_DEFAULTS carries {name!r}, which "
                    f"does not declare the job_config surface",
                    hint="declare job_config in its KNOB_TABLE row (or "
                    "drop the key)",
                )
            for name in sorted(missing):
                yield Finding(
                    rule="knob-taint",
                    path=job_path,
                    line=1,
                    message=f"knob {name!r} declares job_config but "
                    f"CONFIG_DEFAULTS lacks the key",
                    hint="derive CONFIG_DEFAULTS from the registry "
                    "(knobs.job_config_defaults()) so the two cannot "
                    "drift",
                )
        elif "CONFIG_DEFAULTS" in corpus.sources[job_path] and not (
            _imports_knobs(job_tree)
        ):
            yield Finding(
                rule="knob-taint",
                path=job_path,
                line=1,
                message="CONFIG_DEFAULTS is neither a literal dict nor "
                "derived from the knob registry",
                hint="derive it with knobs.job_config_defaults() — the "
                "registry is the single declaration",
            )

    # (f) the CLI's closed world
    cli_path = corpus.find("cli/main.py")
    if cli_path is not None:
        cli_tree = corpus.trees[cli_path]
        for node in ast.walk(cli_tree):
            if not (isinstance(node, ast.Call) and call_name(node) == "opt"):
                continue
            if not node.args:
                continue
            lit = str_const(node.args[0])
            if lit is not None and lit not in table:
                yield Finding(
                    rule="knob-taint",
                    path=cli_path,
                    line=node.lineno,
                    message=f"opt({lit!r}) resolves an undeclared knob",
                    hint="add a KNOB_TABLE row in runtime/knobs.py — "
                    "adding a knob IS editing the registry; the linter "
                    "enforces the rest",
                )
        streaming_only = [
            n for n in rows if "streaming_only" in surf(n)
        ]
        if streaming_only and not _imports_knobs(cli_tree):
            yield Finding(
                rule="knob-taint",
                path=cli_path,
                line=1,
                message="streaming-only knobs are declared but "
                "cli/main.py does not resolve refusals through the "
                "registry",
                hint="route the whole-file refusals through "
                "knobs.streaming_only_keys() — hand-copied refusal "
                "blocks are how --trace got silently dropped once",
            )

    # (g) coverage pin: scheduling job knobs must appear in the linted
    # test anchors (the byte-identity matrix is the proof they are
    # byte-neutral)
    test_paths = [p for p in corpus.trees if p.startswith("tests/")]
    if test_paths:
        exercised: set[str] = set()
        for p in test_paths:
            for fn_node in [corpus.trees[p]]:
                names, lits, kwargs = _fn_scan(fn_node)
                exercised |= set(names) | set(lits) | set(kwargs)
        for name in sorted(
            n for n in rows
            if rows[n]["class"] == "scheduling" and "job_config" in surf(n)
        ):
            flag = str(rows[name].get("flag", ""))
            if name in exercised or (flag and flag in exercised):
                continue
            yield Finding(
                rule="knob-taint",
                path=knobs_path,
                line=table_line,
                message=f"scheduling knob {name!r} has no byte-identity "
                f"exercise in the linted test anchors",
                hint="add it to the byte-identity matrix (tests/"
                "test_torch_knobs.py SCHEDULING_MATRIX) — an unexercised "
                "scheduling knob's byte-neutrality is an unproved claim",
            )


# ------------------------------------------- rule: kernel-cost-registry

def _dict_str_keys(tree: ast.Module, name: str) -> tuple[set[str], int]:
    """Keys of a module-level ``NAME = {"a": <anything>, ...}`` dict
    literal — the cost registry's shape (values are function refs, so
    engine.str_dict_assign's tuple-valued contract does not fit).
    Returns (set(), 0) when missing or not all-literal-keyed."""
    for node in tree.body:
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == name
            and isinstance(node.value, ast.Dict)
        ):
            continue
        keys = [str_const(k) for k in node.value.keys if k is not None]
        if keys and all(k is not None for k in keys):
            return {k for k in keys if k is not None}, node.lineno
    return set(), 0


def _method_literals(tree: ast.Module) -> Iterator[tuple[str, int]]:
    """Every string literal a kernels/ module treats as an ssc-method
    name: comparisons against a ``method`` variable (``method ==
    "matmul"``, ``method in ("blockseg", "runsum")``) and the default
    of a ``method=`` parameter. These are the literals that select a
    kernel path — exactly the set the FLOP-cost registry must cover."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            if not (
                isinstance(node.left, ast.Name)
                and node.left.id == "method"
            ):
                continue
            for comp in node.comparators:
                lit = str_const(comp)
                if lit is not None:
                    yield lit, node.lineno
                elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                    for e in comp.elts:
                        lit = str_const(e)
                        if lit is not None:
                            yield lit, node.lineno
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            params = a.posonlyargs + a.args
            defaults = a.defaults
            # defaults align to the TAIL of the parameter list
            for param, default in zip(params[len(params) - len(defaults):],
                                      defaults):
                if param.arg == "method":
                    lit = str_const(default)
                    if lit is not None:
                        yield lit, node.lineno
            for param, default in zip(a.kwonlyargs, a.kw_defaults):
                if param.arg == "method" and default is not None:
                    lit = str_const(default)
                    if lit is not None:
                        yield lit, node.lineno


@register(
    "kernel-cost-registry",
    "every kernel method literal has a FLOP-cost entry and every dev "
    "record field is registered",
)
def check_kernel_cost_registry(corpus: Corpus) -> Iterator[Finding]:
    """The device ledger's honesty depends on two registries staying
    closed over their call sites: a kernel method with no entry in
    ``ops.pipeline.SSC_METHOD_COSTS`` makes ``analytic_flops`` raise on
    a healthy run (the executor emits FLOPs for every dispatch), and a
    ``dev(...)`` field outside ``telemetry.trace.KNOWN_DEV_FIELDS``
    fails the capture validator only at runtime, with a trace flag set
    — the same too-late drift class the phase-registry rule pins for
    spans. Both directions: an unregistered literal fires at its call
    site; a cost entry no kernel ever selects is a dead registry row."""
    pipe_path = corpus.find("ops/pipeline.py")
    trace_path = corpus.find("telemetry/trace.py")
    costs: set[str] = set()
    costs_line = 1
    if pipe_path is not None:
        costs, costs_line = _dict_str_keys(
            corpus.trees[pipe_path], "SSC_METHOD_COSTS"
        )
    dev_fields: list[str] = []
    if trace_path is not None:
        dev_fields, _ = str_tuple_assign(
            corpus.trees[trace_path], "KNOWN_DEV_FIELDS"
        )

    seen_methods: set[str] = set()
    for path in corpus.package_paths():
        if "kernels/" in path and costs:
            for lit, line in _method_literals(corpus.trees[path]):
                seen_methods.add(lit)
                if lit not in costs:
                    yield Finding(
                        rule="kernel-cost-registry",
                        path=path,
                        line=line,
                        message=f"kernel method {lit!r} has no registered "
                        f"FLOP cost",
                        hint="register a cost function under that key in "
                        "ops.pipeline.SSC_METHOD_COSTS — analytic_flops "
                        "raises on unregistered methods and every "
                        "dispatch is FLOP-ledgered",
                    )
        if dev_fields and path != trace_path:
            for node in ast.walk(corpus.trees[path]):
                if not isinstance(node, ast.Call):
                    continue
                if call_name(node) != "dev":
                    continue
                for kw in node.keywords or ():
                    # chunk/lane are envelope args of the recorder
                    # method, not ledger fields
                    if kw.arg in (None, "chunk", "lane"):
                        continue
                    if kw.arg not in dev_fields:
                        yield Finding(
                            rule="kernel-cost-registry",
                            path=path,
                            line=node.lineno,
                            message=f"dev record field {kw.arg!r} is not "
                            f"registered",
                            hint="register it in telemetry.trace."
                            "KNOWN_DEV_FIELDS (and the dev schema golden "
                            "+ ARCHITECTURE.md) — the validator rejects "
                            "unregistered dev fields",
                        )

    # dead-registry direction: a cost entry nothing in kernels/ can
    # select will never be exercised and hides geometry drift
    if costs and seen_methods and pipe_path is not None:
        for key in sorted(costs - seen_methods):
            yield Finding(
                rule="kernel-cost-registry",
                path=pipe_path,
                line=costs_line,
                message=f"FLOP cost registered for {key!r} but no kernel "
                f"selects that method",
                hint="prune the SSC_METHOD_COSTS entry or wire the "
                "method into kernels/",
            )
