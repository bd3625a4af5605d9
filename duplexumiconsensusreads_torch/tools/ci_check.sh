#!/bin/sh
# The port's commit gate: its contracts, runnable as one command.
#
#   sh duplexumiconsensusreads_torch/tools/ci_check.sh
#
# The same five legs as the JAX package's tools/ci_check.sh, against
# the port; each exits 1 on a violation:
#
#   1. the port's dutlint --strict over its whole default set (the port
#      package with its tools/, and the four test anchors): zero
#      non-allowlisted findings and zero stale allowlist entries. The
#      JSON report is archived to bench_logs/dutlint_torch.json, and the
#      rule count must equal the port rule table in README.md (between
#      the dutlint-torch-rule-table markers).
#   2. the port's check_trace --require-summary over the committed
#      fixture capture (tests/data/run.fixture.trace.jsonl).
#   3. the port's fleet_report over the committed two-daemon fixture
#      captures (tests/data/fleet.fixture.{a,b}.trace.jsonl).
#   4. the port's devstat over the committed fixture capture.
#   5. the port's check_trace --require-summary over the committed
#      follow-mode fixture (tests/data/live.fixture.trace.jsonl).
#
# tests/test_torch_lint.py runs this script as a tier-1 test.
set -eu
root="$(cd "$(dirname "$0")/../.." && pwd)"
# honour the caller's interpreter (the tier-1 test passes its own)
py="${PYTHON:-python}"
tool() { (cd "$root" && "$py" -m "duplexumiconsensusreads_torch.tools.$@"); }

echo "[ci_check] port dutlint --strict (all rules, stale-allowlist fatal)" >&2
mkdir -p "$root/bench_logs"
if ! tool dutlint --strict --json > "$root/bench_logs/dutlint_torch.json"; then
    cat "$root/bench_logs/dutlint_torch.json" >&2
    echo "[ci_check] port dutlint --strict failed (report archived to" \
         "bench_logs/dutlint_torch.json)" >&2
    exit 1
fi

echo "[ci_check] port dutlint rule count vs README table" >&2
n_rules="$(tool dutlint --list-rules | grep -c .)"
n_doc="$(sed -n '/<!-- dutlint-torch-rule-table -->/,/<!-- \/dutlint-torch-rule-table -->/p' \
    "$root/README.md" | grep -c '^| `' || true)"
if [ "$n_rules" != "$n_doc" ]; then
    echo "[ci_check] rule-count drift: the port's dutlint registers" \
         "$n_rules rules but README.md's port table documents $n_doc" \
         "— update the table between the dutlint-torch-rule-table markers" >&2
    exit 1
fi

echo "[ci_check] port check_trace --require-summary (fixture capture)" >&2
tool check_trace "$root/tests/data/run.fixture.trace.jsonl" --require-summary

echo "[ci_check] port fleet_report (2-daemon fixture captures, sum-check)" >&2
tool fleet_report "$root/tests/data/fleet.fixture.a.trace.jsonl" \
    "$root/tests/data/fleet.fixture.b.trace.jsonl" >/dev/null

echo "[ci_check] port devstat (fixture capture, dev sum-check)" >&2
tool devstat "$root/tests/data/run.fixture.trace.jsonl" >/dev/null

echo "[ci_check] port check_trace --require-summary (live follow fixture)" >&2
tool check_trace "$root/tests/data/live.fixture.trace.jsonl" --require-summary

echo "[ci_check] OK" >&2
