"""What the benchmark is made of: no JAX, a reference independent of
the program, a BENCHMARK.json within the contract's limits, and cells,
mixes and metrics that are new files only."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from portbench.conftest import TINY_SIM, copy_benchmark
from portbench.lib import cell

PKG, ROOT = cell.PKG, cell.CHECKOUT
PORT = "duplexumiconsensusreads_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _py_files(sub=""):
    base = os.path.join(PKG, sub)
    for d, dirs, files in os.walk(base):
        dirs[:] = [x for x in dirs if x not in (".cache", "__pycache__")]
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def _imported(path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_no_jax_by_whole_top_level_name():
    for path in _py_files():
        assert not _imported(path) & set(cell.FORBIDDEN), path
    # what the port and every module of the benchmark load, in a fresh process
    code = ("import sys, os; sys.path.insert(0, %r);"
            "from portbench.lib import cell;"
            "import portbench.run, portbench.control, portbench.roofline;"
            "[cell.load_module(os.path.join(d, f), 'm_' + f.replace('.', '_'))"
            " for d in [os.path.join(cell.PKG, s) for s in ('drivers', 'metrics')]"
            " for f in sorted(os.listdir(d)) if f.endswith('.py')];"
            "import duplexumiconsensusreads_torch.runtime.stream,"
            " duplexumiconsensusreads_torch.runtime.executor,"
            " duplexumiconsensusreads_torch.parallel.sharded;"
            "print(cell.forbidden_loaded())") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    # the check compares whole names: the port's name begins with the JAX package's
    assert not {PORT} & set(cell.FORBIDDEN)


@pytest.mark.parametrize("sub", ["reference", "gen"])
def test_yardstick_imports_nothing_of_the_program(sub):
    for path in _py_files(sub):
        assert PORT not in _imported(path), path
    for path in (os.path.join(PKG, "roofline.py"), os.path.join(PKG, "lib", "compare.py")):
        assert PORT not in _imported(path), path


def test_benchmark_json_within_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1] == "portbench/run.py"
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert set(c["reduced"]) == set(conf["reduced"]) and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(PKG, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(PKG, "limits", w["name"] + ".json"))
        used.add(w["config"])
    assert used == {c["name"] for c in b["configs"]}
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert os.path.exists(os.path.join(PKG, "metrics", m["name"] + ".py"))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:  # setup_s, another end-to-end metric, a per-layer one
        assert sum(w in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def _files(root):
    out = {}
    for d, dirs, fs in os.walk(root):
        dirs[:] = [x for x in dirs if x not in (".cache", "__pycache__")]
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


NEW_METRIC = '''"""Calls the window made (a throwaway metric of the layout test)."""


def read(ctx):
    return ctx.attempted
'''


def test_new_config_mix_and_metric_are_new_files(tmp_path):
    root = str(tmp_path)
    pkg = copy_benchmark(root)
    before = _files(pkg)
    with open(os.path.join(ROOT, "portbench", "configs", "amplicon_ss.json")) as f:
        conf = json.load(f)
    conf["sim"].update(TINY_SIM["amplicon_ss"])
    conf.update(name="tinycfg", capacity=512)
    new = {
        "configs/tinycfg.json": json.dumps(conf),
        "traffic/tinymix.json": json.dumps({"driver": "resident", "chunk_reads": 0,
                                            "warm_passes": 1, "check_buckets": 4}),
        "metrics/tiny_calls.py": NEW_METRIC,
        "limits/tinycfg.tinymix.json": json.dumps({"unit_mismatch": 0, "depth_mismatch": 0,
                                                   "base_mismatch_share": 1e-4,
                                                   "qual_mismatch_share": 1e-3}),
    }
    for rel, text in new.items():
        with open(os.path.join(pkg, rel), "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "tinycfg", "source": conf["source"],
                         "file": "portbench/configs/tinycfg.json", "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tinycfg.tinymix", "config": "tinycfg", "traffic": "tinymix",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "tiny_calls", "unit": "calls", "better": "higher",
                           "source": "program_counter", "layer": "test", "moves": "setup_s",
                           "workloads": ["tinycfg.tinymix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    after = _files(pkg)
    assert {k: after[k] for k in before} == before  # no file of the benchmark edited
    os.symlink(os.path.join(ROOT, PORT), os.path.join(root, PORT))  # the checkout's program
    code = ("import sys, json; sys.path[:0] = [%r];"
            "from portbench.lib import cell;"
            "b = json.load(open(%r));"
            "print(json.dumps(cell.run_cell(b, 'tinycfg.tinymix', 2**31 + 5, 0.2, True,"
            " device='cpu')[0]))") % (root, os.path.join(root, "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["tiny_calls"]["value"] >= 1
    assert list(res)[-1] == "checks"


def test_benchmark_alone_exits_non_zero(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: no program,
    no result."""
    copy_benchmark(str(tmp_path))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "amplicon_ss.resident", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(tmp_path), timeout=300)
    assert out.returncode != 0 and "correct" not in out.stdout
    assert PORT in out.stderr


def test_run_without_a_card_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "amplicon_ss.resident", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "amplicon_ss.resident", "--seed", str(2**31 + 9), "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


def test_resident_layer_readers():
    """The resident cells' readers that need no kernel counts: the rate,
    the step's device time a million reads, the idle share and the fill."""
    from types import SimpleNamespace

    from portbench.lib.trace import Trace

    tr = Trace()
    tr.busy_s, tr.window_s, tr.intervals = 1.0, 4.0, [(0, 1)]
    ctx = SimpleNamespace(window_reads=2_000_000, window_s=4.0, tracer=tr,
                          counters={"rows_real": 3, "rows_padded": 4})
    want = {"resident_reads_per_s": 500_000.0, "step_ms_per_mread": 500.0,
            "device_idle_share.resident": 0.75, "bucket_fill": 0.75}
    empty = SimpleNamespace(window_reads=0, window_s=0.0, tracer=None, counters={})
    for name, value in want.items():
        mod = cell.load_module(os.path.join(PKG, "metrics", name + ".py"), "t_" + name)
        assert mod.read(ctx) == pytest.approx(value), name
        assert mod.read(empty) is None, name
