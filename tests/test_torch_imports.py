"""The torch port stands alone: no module of duplexumiconsensusreads_torch,
nor chip_smoke.py, imports jax or the JAX package — shown statically (an
AST scan of every import) and at run time (a fresh interpreter imports
every module of the port and finds neither in sys.modules). Also the
interop seam that lets the tests feed both packages the same state.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "duplexumiconsensusreads_torch")
FORBIDDEN = ("jax", "jaxlib", "duplexumiconsensusreads_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        if rel.endswith("__main__"):
            continue
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_source(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_native_library_loads_from_the_port_build_dir(tmp_path):
    """The native loader the port's reader, streaming iterator and
    deflate run is the port's own build (its _build/), never the JAX
    package's native/libdutbam.so, and using it imports no jax."""
    code = (
        "import sys\n"
        "from duplexumiconsensusreads_torch.io import load_input, simulated_bam\n"
        "from duplexumiconsensusreads_torch.io.bgzf import compress_fast_tagged\n"
        "from duplexumiconsensusreads_torch.runtime.stream import iter_batch_chunks\n"
        "from duplexumiconsensusreads_torch.simulate import SimConfig\n"
        f"p = {str(tmp_path / 'x.bam')!r}\n"
        "simulated_bam(SimConfig(n_molecules=20, seed=2), path=p, sort=True)\n"
        "assert load_input(p, duplex=True)[2]['native'] is True\n"
        "assert all(i['native'] for _, _, i in iter_batch_chunks(p, 50, True))\n"
        "assert compress_fast_tagged(b'x' * 1000)[1] == 'native'\n"
        "libs = {l.split()[-1] for l in open('/proc/self/maps') if 'libdutbam' in l}\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('\\n'.join(sorted(libs)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "DUT_NO_NATIVE")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    libs = r.stdout.split()
    assert len(libs) == 1, libs
    assert libs[0].startswith(os.path.join(PORT, "_build", "libdutbam-"))


def test_chip_smoke_refuses_without_a_card_or_without_the_port(tmp_path):
    import shutil

    # with no CUDA device: non-zero exit, no result line (on a card the
    # script would run its whole smoke instead)
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and '"ok"' not in r.stdout
    # alone in a directory: the same
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_stacked_from_numpy_keeps_values_and_dtypes():
    from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, stacked_from_numpy

    rng = np.random.default_rng(0)
    st = {
        "pos": rng.integers(0, 60000, (2, 8)).astype(np.uint16),
        "umi": rng.integers(0, 255, (2, 8, 3)).astype(np.uint8),
        "strand_ab": rng.integers(0, 8, (2, 8)).astype(np.uint8),
        "frag_end": np.zeros((2, 0), np.uint8),
        "valid": np.zeros((2, 0), np.uint8),
        "bases": rng.integers(0, 255, (2, 8, 5)).astype(np.uint8),
        "quals": np.zeros((2, 8, 0), np.uint8),
        "read_index": np.arange(16).reshape(2, 8),
    }
    t = stacked_from_numpy(st, "cpu")
    assert tuple(t) == ARRAY_KEYS
    assert t["pos"].dtype == torch.int16  # the u16 lane's bit pattern
    np.testing.assert_array_equal(t["pos"].numpy().view(np.uint16), st["pos"])
    for k in ARRAY_KEYS[1:]:
        np.testing.assert_array_equal(t[k].numpy(), st[k])


def test_spec_from_fields_maps_jax_specs():
    from duplexumiconsensusreads_tpu.ops.pipeline import PipelineSpec as JaxSpec
    from duplexumiconsensusreads_tpu.types import ConsensusParams, GroupingParams
    from duplexumiconsensusreads_torch.interop import spec_from_fields

    js = JaxSpec(GroupingParams(strategy="adjacency", paired=True),
                 ConsensusParams(mode="duplex", error_model="cycle"),
                 u_max=64, f_max=128, m_max=64, ssc_method="pallas", presorted=True)
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    ps = spec_from_fields(**fields)
    assert ps.ssc_method == "segment_gemm"
    assert (ps.u_max, ps.f_max, ps.m_max, ps.presorted) == (64, 128, 64, True)
    assert ps.grouping.strategy == "adjacency" and ps.consensus.error_model == "cycle"
    for bad in ({"ssc_method": "blockseg"}, {"fit_impl": "counts"}, {"packed_qbits": 5}):
        with pytest.raises(ValueError):
            spec_from_fields(**{**fields, **bad})
