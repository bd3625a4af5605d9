"""The torch port's copy of the host I/O against the JAX package's.

The port keeps its own portable BGZF/BAM codec (it may import nothing
of the JAX package). Its whole-stream BGZF decompress walks the blocks
one by one instead of calling ``gzip.decompress``, which re-slices the
remaining input once per member; both must give the same bytes, and
the BAM reader and writer must round-trip the same records as the JAX
package's.
"""

from __future__ import annotations

import gzip
import zlib

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.io import bgzf as jax_bgzf
from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_torch.io import bgzf, read_bam, write_bam

RECORD_FIELDS = ("names", "flags", "ref_id", "pos", "mapq", "next_ref_id", "next_pos",
                 "tlen", "lengths", "seq", "qual")


@pytest.mark.parametrize("n_bytes", [0, 1000, 300_000])
def test_bgzf_decompress_matches_gzip_and_jax(n_bytes):
    rng = np.random.default_rng(n_bytes)
    # low-entropy payload, several blocks at the largest size
    data = rng.integers(0, 4, n_bytes).astype(np.uint8).tobytes()
    stream = bgzf.compress(data)
    assert bgzf.decompress(stream) == data == gzip.decompress(stream)
    assert jax_bgzf.decompress(stream) == data
    assert stream == jax_bgzf.compress(data)


def test_bgzf_decompress_rejects_a_corrupt_block():
    stream = bytearray(bgzf.compress(b"ACGT" * 5000))
    stream[-40] ^= 0xFF  # inside the last data block's deflate body or CRC
    with pytest.raises((ValueError, zlib.error)):
        bgzf.decompress(bytes(stream))


def test_read_and_write_bam_match_jax(tmp_path):
    path = str(tmp_path / "in.bam")
    simulated_bam(SimConfig(n_molecules=150, read_len=36, duplex=True, paired_reads=True,
                            seed=4), path=path, sort=True)
    jh, jr = jax_read_bam(path)
    th, tr = read_bam(path)
    assert th.text == jh.text and len(tr) == len(jr) > 0
    for f in RECORD_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tr, f)), np.asarray(getattr(jr, f)), f)
    assert list(tr.cigars) == list(jr.cigars) and list(tr.aux_raw) == list(jr.aux_raw)

    out = str(tmp_path / "out.bam")
    write_bam(out, th, tr)
    rh, rr = jax_read_bam(out)
    assert rh.text == jh.text
    for f in RECORD_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rr, f)), np.asarray(getattr(jr, f)), f)
