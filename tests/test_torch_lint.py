"""The port's dutlint (``duplexumiconsensusreads_torch/analysis/``)
against the JAX package's, and the port's whole-tree gate.

- Every rule's firing and passing fixture of the JAX suite
  (``tests/test_lint.py``) runs through BOTH engines: the JAX suite's
  snippet corpora go to the JAX engine as they are and to the port's
  engine with the anchor paths rewritten (``tests/test_chaos.py`` ->
  ``tests/test_torch_chaos.py`` and so on). The two must give the same
  findings as (rule, path, line, message), paths mapped back; the JAX
  test's own assertions then run on the port's result. The JAX suite
  is loaded as a private module copy and its rule classes are
  subclassed here, so each of its cases is a case of this file.
- The device-call fixtures of the port's own: thread-confinement reads
  ``torch.cuda.*`` and the port's dispatch and kernel entry names where
  the JAX engine reads ``jax.*`` — the one place the engines differ.
- The CLI contract (the JAX cases, run against the port's
  ``tools/dutlint.py``), the AST cache, the port's ``ci_check.sh``, its
  README rule table, and the whole-tree gate over the port with all
  four anchors in the corpus: a missing anchor would make its rules
  skip their coverage legs silently, and deleting one site's case from
  a copy of the chaos anchor makes fault-registry fire.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys
import textwrap

import pytest

from duplexumiconsensusreads_tpu.analysis import Corpus as JaxCorpus
from duplexumiconsensusreads_tpu.analysis import run_lint as jax_run_lint
from duplexumiconsensusreads_torch.analysis import Corpus, run_lint
from duplexumiconsensusreads_torch.analysis.allowlist import ALLOWLIST
from duplexumiconsensusreads_torch.analysis.cli import PACKAGE, TEST_ANCHORS, default_targets
from duplexumiconsensusreads_torch.analysis.engine import RULES, AllowEntry, LintResult

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, PACKAGE)
ANCHORS = {
    "tests/test_chaos.py": "tests/test_torch_chaos.py",
    "tests/test_telemetry.py": "tests/test_torch_telemetry.py",
    "tests/test_serve.py": "tests/test_torch_serve.py",
    "tests/test_knobs.py": "tests/test_torch_knobs.py",
}


def _load_jax_suite():
    """A private copy of the JAX lint suite (never the module pytest
    collects), so patching its globals touches nothing else."""
    spec = importlib.util.spec_from_file_location(
        "_jax_lint_suite", os.path.join(REPO, "tests", "test_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _load_jax_suite()


def _rewrite(path, table):
    for a, b in table.items():
        if path == a or path.endswith("/" + a):
            return path[: len(path) - len(a)] + b
    return path


def to_port(path):
    return _rewrite(path, ANCHORS)


def to_jax(path):
    return _rewrite(path, {b: a for a, b in ANCHORS.items()})


def _rows(findings, back=lambda p: p):
    return sorted((f.rule, back(f.path), f.line, f.message) for f in findings)


def lint_both(files: dict, rules=None, allow=()):
    """Both engines over the same snippet corpus (the port's with its
    anchor paths): the findings must be equal; returns the port's
    result with the paths mapped back to the JAX names."""
    jc, pc = JaxCorpus(root="<snippets>"), Corpus(root="<snippets>")
    for path, src in files.items():
        jc.add(path, textwrap.dedent(src))
        pc.add(to_port(path), textwrap.dedent(src))
    allow = list(allow)
    jres = jax_run_lint(jc, allow, only_rules=rules)
    port_allow = {id(a): (AllowEntry(a.rule, to_port(a.path), a.reason)
                          if to_port(a.path) != a.path else a) for a in allow}
    orig = {id(port_allow[id(a)]): a for a in allow}
    pres = run_lint(pc, list(port_allow.values()), only_rules=rules)
    assert _rows(pres.findings, to_jax) == _rows(jres.findings)
    assert _rows((f for f, _ in pres.suppressed), to_jax) == _rows(f for f, _ in jres.suppressed)
    back = [dataclasses.replace(f, path=to_jax(f.path)) for f in pres.findings]
    return LintResult(
        back,
        [(dataclasses.replace(f, path=to_jax(f.path)), orig[id(a)]) for f, a in pres.suppressed],
        [orig[id(a)] for a in pres.unused_allowlist],
    )


@pytest.fixture(autouse=True)
def _port_engine_under_the_jax_cases(monkeypatch):
    """The JAX suite's cases call ``lint``, ``RULES``, ``AllowEntry`` and
    ``REPO`` from their module: point them at the port (``REPO`` at the
    port package, whose ``tools/dutlint.py`` is the port's CLI)."""
    monkeypatch.setattr(J, "lint", lint_both)
    monkeypatch.setattr(J, "RULES", RULES)
    monkeypatch.setattr(J, "AllowEntry", AllowEntry)
    monkeypatch.setattr(J, "REPO", PORT)
    yield


# ---- the JAX suite's per-rule firing and passing fixtures, both engines

class TestEngine(J.TestEngine):
    pass


class TestClockDiscipline(J.TestClockDiscipline):
    pass


class TestDurabilityProtocol(J.TestDurabilityProtocol):
    pass


class TestFaultRegistry(J.TestFaultRegistry):
    pass


class TestPhaseRegistry(J.TestPhaseRegistry):
    pass


class TestLockDiscipline(J.TestLockDiscipline):
    pass


class TestLeaseDiscipline(J.TestLeaseDiscipline):
    pass


class TestDeadlineDiscipline(J.TestDeadlineDiscipline):
    pass


class TestHostLocality(J.TestHostLocality):
    pass


class TestHookGuard(J.TestHookGuard):
    pass


class TestStateMachine(J.TestStateMachine):
    pass


class TestTxnDiscipline(J.TestTxnDiscipline):
    pass


class TestFenceDominance(J.TestFenceDominance):
    pass


class TestExceptionContract(J.TestExceptionContract):
    pass


class TestThreadConfinement(J.TestThreadConfinement):
    """The JAX fixtures through both engines, plus the port's own
    device-call fixtures: the port engine reads ``torch.cuda.*`` callees
    and the port's dispatch and kernel wrappers as device calls, which
    the JAX engine does not (it reads ``jax.*``)."""

    def _port_only(self, call):
        corpus = Corpus(root="<snippets>")
        corpus.add("pkg/runtime/knobs.py", textwrap.dedent(J.TestThreadConfinement.KNOBS_ROLES))
        corpus.add("pkg/runtime/stream.py", textwrap.dedent(
            J.TestThreadConfinement.STREAM_OK.replace("return [batch]", f"return {call}")))
        return run_lint(corpus, only_rules=["thread-confinement"])

    @pytest.mark.parametrize("call", [
        "torch.cuda.synchronize()", "torch.cuda.current_stream()",
        "segment_gemm(batch, batch, 4)", "pack_fetch_outputs(batch, 4)",
        "directional_cluster(batch, batch, batch, 12, 1, 2)", "fused_pipeline(batch, None)",
    ])
    def test_torch_device_call_without_the_grant_fires_on_the_port_only(self, call):
        res = self._port_only(call)
        (f,) = res.findings
        assert f.rule == "thread-confinement" and f.path == "pkg/runtime/stream.py"
        assert "without the 'device' grant" in f.message and "'ingest'" in f.message
        # the JAX engine does not read these as device calls
        jc = JaxCorpus(root="<snippets>")
        for p, src in (("pkg/runtime/knobs.py", J.TestThreadConfinement.KNOBS_ROLES),
                       ("pkg/runtime/stream.py", J.TestThreadConfinement.STREAM_OK.replace(
                           "return [batch]", f"return {call}"))):
            jc.add(p, textwrap.dedent(src))
        assert jax_run_lint(jc, only_rules=["thread-confinement"]).ok

    def test_torch_host_calls_pass(self):
        # torch on the host (no card) is not a device effect
        assert self._port_only("torch.as_tensor(batch)").ok
        assert self._port_only("torch.cuda_like(batch)").ok


class TestKnobTaint(J.TestKnobTaint):
    pass


class TestKernelCostRegistry(J.TestKernelCostRegistry):
    pass


# ---- the CLI contract, against the port's tools/dutlint.py

class TestCli(J.TestCli):
    def _since_repo(self, tmp_path):
        """A throwaway git repo whose port default set holds one file."""
        pkg = tmp_path / PACKAGE / "runtime"
        pkg.mkdir(parents=True)
        hot = pkg / "hot.py"
        hot.write_text("def f():\n    return 0\n")
        env = {**os.environ, "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
               "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"}
        for cmd in (["git", "init", "-q"], ["git", "add", "-A"], ["git", "commit", "-qm", "seed"]):
            subprocess.run(cmd, cwd=tmp_path, env=env, check=True, capture_output=True,
                           timeout=60)
        return hot

    def test_default_set_skips_build_outputs(self, tmp_path):
        build = tmp_path / PACKAGE / "_build"
        build.mkdir(parents=True)
        (build / "gen.py").write_text("import time\nT = time.time()\n")
        (tmp_path / PACKAGE / "tools").mkdir()
        (tmp_path / PACKAGE / "tools" / "t.py").write_text("x = 1\n")
        assert default_targets(str(tmp_path)) == [f"{PACKAGE}/tools/t.py"]


# ---- the AST cache

class TestAstCache:
    def test_reloading_the_corpus_reparses_nothing(self):
        from duplexumiconsensusreads_torch.analysis.engine import CACHE_STATS, load_corpus

        rels = default_targets(REPO)
        c1 = load_corpus(REPO, rels)
        misses0, hits0 = CACHE_STATS["misses"], CACHE_STATS["hits"]
        c2 = load_corpus(REPO, rels)
        assert CACHE_STATS["misses"] == misses0
        assert CACHE_STATS["hits"] >= hits0 + len(c2.trees)
        for p in list(c1.trees)[:5]:
            assert c2.trees[p] is c1.trees[p]

    def test_lint_suite_runtime_budget(self):
        import time

        from duplexumiconsensusreads_torch.analysis.engine import load_corpus

        rels = default_targets(REPO)
        load_corpus(REPO, rels)
        t0 = time.monotonic()
        for _ in range(3):
            run_lint(load_corpus(REPO, rels), ALLOWLIST)
        dt = time.monotonic() - t0
        assert dt < 30.0, f"3 warm lint passes took {dt:.1f}s"


# ---- the port's commit gate

def _port_rule_table():
    readme = open(os.path.join(REPO, "README.md")).read()
    block = readme.split("<!-- dutlint-torch-rule-table -->")[1].split(
        "<!-- /dutlint-torch-rule-table -->")[0]
    return {ln.split("`")[1] for ln in block.splitlines() if ln.startswith("| `")}


class TestCiCheck:
    def test_ci_check_passes_on_the_shipped_tree(self):
        p = subprocess.run(["sh", os.path.join(PORT, "tools", "ci_check.sh")],
                           capture_output=True, text=True, timeout=300,
                           env={**os.environ, "PYTHON": sys.executable})
        assert p.returncode == 0, p.stdout + p.stderr
        assert "[ci_check] OK" in p.stderr

    def test_readme_rule_table_matches_registry(self):
        assert _port_rule_table() == set(RULES)

    def test_fixture_capture_is_complete_and_pinned(self, tmp_path):
        fixture = os.path.join(REPO, "tests", "data", "run.fixture.trace.jsonl")
        lines = open(fixture).read().splitlines()
        assert '"type":"summary"' in lines[-1]
        torn = tmp_path / "torn.trace.jsonl"
        torn.write_text("\n".join(lines[:-1]) + "\n")
        p = subprocess.run([sys.executable, "-m", "duplexumiconsensusreads_torch.tools.check_trace",
                            str(torn), "--require-summary"], capture_output=True, text=True,
                           timeout=120, cwd=REPO)
        assert p.returncode == 1 and "summary" in p.stderr


# ---- the whole-tree gate over the port

def _tree():
    from duplexumiconsensusreads_torch.analysis.engine import load_corpus

    return load_corpus(REPO, default_targets(REPO))


class TestShippedTree:
    def test_tree_lints_clean_modulo_allowlist(self):
        res = run_lint(_tree(), ALLOWLIST)
        assert res.ok, "\n".join(f.format() for f in res.findings)
        assert res.unused_allowlist == [], [(a.rule, a.path) for a in res.unused_allowlist]
        assert sorted((f.rule, f.path) for f, _ in res.suppressed) == [
            ("durability-protocol", f"{PACKAGE}/io/bam.py"),
            ("durability-protocol", f"{PACKAGE}/runtime/executor.py"),
        ]

    def test_allowlist_is_the_two_reasoned_durability_entries(self):
        assert [(a.rule, a.path) for a in ALLOWLIST] == [
            ("durability-protocol", f"{PACKAGE}/io/bam.py"),
            ("durability-protocol", f"{PACKAGE}/runtime/executor.py"),
        ]
        assert all(a.reason.strip() for a in ALLOWLIST)

    def test_every_anchor_is_in_the_corpus(self):
        """Without an anchor a rule silently skips its coverage leg:
        each of the four must be linted."""
        corpus = _tree()
        assert set(TEST_ANCHORS) == set(ANCHORS.values())
        for anchor in TEST_ANCHORS:
            assert corpus.find(anchor) == anchor, anchor

    def test_linted_set_covers_the_contract_files(self):
        targets = set(default_targets(REPO))
        for must in (
            "tools/dutlint.py", "tools/check_trace.py", "tools/trace_report.py",
            "tools/serve_report.py", "tools/wirestat.py", "tools/bench_history.py",
            "tools/fleet_report.py", "tools/devstat.py", "tools/profile_components.py",
            "tools/profile_phases.py", "tools/tune_ssc.py", "runtime/knobs.py",
            "runtime/stream.py", "serve/queue.py", "serve/service.py", "serve/states.py",
            "kernels/segment_gemm.py", "kernels/cluster_fixpoint.py", "entry.py",
        ):
            assert f"{PACKAGE}/{must}" in targets, must
        assert not any("/_build/" in t or "__pycache__" in t for t in targets)
        assert not any(t.startswith("duplexumiconsensusreads_tpu/") for t in targets)

    def test_port_tools_are_not_package_code(self):
        corpus = _tree()
        pkg = set(corpus.package_paths())
        assert f"{PACKAGE}/tools/dutlint.py" not in pkg
        assert f"{PACKAGE}/runtime/stream.py" in pkg

    @pytest.mark.parametrize("site", ["bgzf.inflate", "serve.watchdog", "live.poll"])
    def test_deleting_a_sites_case_from_the_chaos_anchor_fires(self, site):
        """A copy of the chaos anchor with one site taken out of its
        parametrized tuple: fault-registry fires on exactly that site."""
        corpus = _tree()
        anchor = "tests/test_torch_chaos.py"
        src = corpus.sources[anchor]
        assert src.count(f'"{site}"') == 1
        mutated = Corpus(REPO)
        for path, text in corpus.sources.items():
            mutated.add(path, text.replace(f'"{site}", ', "").replace(f', "{site}"', "")
                        if path == anchor else text)
        res = run_lint(mutated, ALLOWLIST, only_rules=["fault-registry"])
        assert [(f.rule, f.path) for f in res.findings] == [("fault-registry", anchor)]
        assert repr(site) in res.findings[0].message

    @pytest.mark.parametrize("anchor, rule", [
        ("tests/test_torch_serve.py", "lease-discipline"),
        ("tests/test_torch_serve.py", "deadline-discipline"),
        ("tests/test_torch_knobs.py", "knob-taint"),
    ])
    def test_dropping_a_suites_literals_fires(self, anchor, rule):
        """The serve and knob anchors hold their rules' coverage: an
        anchor stripped to its imports fires the rule."""
        corpus = _tree()
        mutated = Corpus(REPO)
        for path, text in corpus.sources.items():
            mutated.add(path, "import os\n" if path == anchor else text)
        if rule == "knob-taint":
            # the other anchors name knobs too: strip them all
            mutated = Corpus(REPO)
            for path, text in corpus.sources.items():
                mutated.add(path, "import os\n" if path.startswith("tests/") else text)
        res = run_lint(mutated, ALLOWLIST, only_rules=[rule])
        assert res.findings and {f.rule for f in res.findings} == {rule}
