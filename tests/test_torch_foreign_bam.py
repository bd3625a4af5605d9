"""Foreign BAMs through the port's codecs against the JAX package's (the
contracts of tests/test_foreign_bam.py).

The bytes come from that suite's independent mini-writer (struct.pack
from the SAM spec, no code shared with either package's io/bam.py):
every CIGAR op, every aux type, several references, a record over
64 KiB across BGZF blocks, a CG-tag long CIGAR, missing quals. Each
input goes through both packages' Python codec, and through both
native loaders where a test reads natively: the parses must be
identical, field by field, or both must refuse, with the same kind of
error (and the same words where the JAX suite pins them).
"""

from __future__ import annotations

import random
import struct

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.io import bam as jax_bam
from duplexumiconsensusreads_tpu.io import bgzf as jax_bgzf
from duplexumiconsensusreads_torch.io import bam, bgzf
from test_foreign_bam import _OPS, EVERY_AUX, _aux, _bam, _rec

# an error either package may raise on malformed bytes
REFUSALS = (ValueError, IndexError, KeyError, struct.error)


def outcome(fn, *args):
    """("ok", result) or ("refused", the exception's type name and
    message)."""
    try:
        return "ok", fn(*args)
    except REFUSALS as e:
        return "refused", (type(e).__name__, str(e))


def assert_same_parse(raw: bytes) -> tuple:
    """Both packages' parse_bam on ``raw``: identical header and records,
    or the same refusal. Returns the port's outcome."""
    ours, theirs = outcome(bam.parse_bam, raw), outcome(jax_bam.parse_bam, raw)
    assert ours[0] == theirs[0], (ours, theirs)
    if ours[0] == "refused":
        assert ours[1] == theirs[1]
        return ours
    (h, r), (jh, jr) = ours[1], theirs[1]
    assert (h.text, h.ref_names, h.ref_lengths) == (jh.text, jh.ref_names, jh.ref_lengths)
    assert len(r) == len(jr)
    for f in ("names", "flags", "ref_id", "pos", "mapq", "next_ref_id", "next_pos", "tlen",
              "lengths", "seq", "qual"):
        np.testing.assert_array_equal(np.asarray(getattr(r, f)), np.asarray(getattr(jr, f)),
                                      err_msg=f)
    assert [list(c) for c in r.cigars] == [list(c) for c in jr.cigars]
    assert list(r.umi) == list(jr.umi) and list(r.aux_raw) == list(jr.aux_raw)
    return ours


def _parsed(raw):
    kind, out = assert_same_parse(raw)
    assert kind == "ok", out
    return out


def _refused(raw):
    kind, out = assert_same_parse(raw)
    assert kind == "refused"
    return out


def test_every_cigar_op_parses_alike():
    cigars = [
        [(4, "S"), (10, "M"), (2, "I"), (5, "M"), (3, "D"), (8, "M")],
        [(10, "="), (1, "X"), (9, "=")],
        [(5, "M"), (100, "N"), (15, "M")],
        [(2, "H"), (20, "M"), (1, "P"), (2, "H")],
    ]
    seqs = ["A" * 29, "C" * 20, "G" * 20, "T" * 20]
    recs = [_rec(name=f"r{i}", cigar=c, seq=s, qual=[30] * len(s), pos=100 + i)
            for i, (c, s) in enumerate(zip(cigars, seqs))]
    _, r = _parsed(_bam(recs))
    assert [list(c) for c in r.cigars] == cigars
    bad = bytearray(_bam([_rec(cigar=[(4, "M")], seq="ACGT", qual=[30] * 4)]))
    idx = bytes(bad).rindex(struct.pack("<I", (4 << 4) | _OPS["M"]))
    bad[idx] = (4 << 4) | 0xE
    _refused(bytes(bad))


def test_every_aux_type_preserved_and_rx_found_alike():
    _, r = _parsed(_bam([_rec(seq="ACGTACGT", qual=[25] * 8, aux=EVERY_AUX)]))
    assert r.aux_raw[0] == EVERY_AUX and r.umi[0] == "ACGTAA"
    bad_aux = _aux("BX", "B", b"q" + struct.pack("<I", 1) + b"\x00")
    _refused(_bam([_rec(seq="AC", qual=[20, 20], aux=bad_aux)]))


def test_multiple_reference_sequences_alike():
    refs = (("chr1", 1000), ("chr2", 2000), ("chrM", 16569))
    recs = [_rec(name=f"r{i}", rid=i, pos=10 * (i + 1), seq="ACGT", qual=[30] * 4,
                 cigar=[(4, "M")]) for i in range(3)]
    h, r = _parsed(_bam(recs, refs=refs))
    assert h.ref_names == ["chr1", "chr2", "chrM"] and h.ref_lengths == [1000, 2000, 16569]
    np.testing.assert_array_equal(r.ref_id, [0, 1, 2])


@pytest.mark.parametrize("seq, qual, want_seq, want_qual", [
    ("=ACMGRSVTWYHKDBN", [30] * 16, [4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4], [30] * 16),
    ("ACGT", None, [0, 1, 2, 3], [0, 0, 0, 0]),
], ids=["ambiguity_codes_to_n", "missing_quals_to_zero"])
def test_bases_and_missing_quals_decode_alike(seq, qual, want_seq, want_qual):
    _, r = _parsed(_bam([_rec(seq=seq, qual=qual, cigar=[(len(seq), "M")])]))
    np.testing.assert_array_equal(r.seq[0], want_seq)
    np.testing.assert_array_equal(r.qual[0], want_qual)


def test_record_over_64kib_spans_bgzf_blocks_alike():
    """A 70 kb read across BGZF blocks: each package's compressed bytes
    equal the other's, inflate through either, and parse alike."""
    n = 70_000
    rec = _rec(seq="ACGT" * (n // 4), qual=[30] * n, cigar=[(n, "M")],
               aux=_aux("RX", "Z", b"AACC\x00"))
    raw = _bam([rec, _rec(name="r2", pos=200, seq="ACGT", qual=[30] * 4, cigar=[(4, "M")])])
    comp = bgzf.compress(raw)
    assert comp == jax_bgzf.compress(raw)
    assert bgzf.decompress(comp) == jax_bgzf.decompress(comp) == raw
    _, r = _parsed(comp)
    assert int(r.lengths[0]) == n and r.umi[0] == "AACC" and r.names[1] == "r2"


def test_cg_tag_long_cigar_placeholder_alike():
    n = 20
    real_ops = struct.pack("<I", 2) + struct.pack("<II", (n << 4) | _OPS["M"], 0)
    aux = _aux("CG", "B", b"I" + real_ops) + _aux("RX", "Z", b"AC\x00")
    _, r = _parsed(_bam([_rec(seq="A" * n, qual=[30] * n, cigar=[(n, "S"), (1000, "N")],
                               aux=aux)]))
    assert list(r.cigars[0]) == [(n, "S"), (1000, "N")] and r.aux_raw[0] == aux


def _foreign_mix(rng):
    recs = []
    for i in range(40):
        l = int(rng.integers(20, 80))
        seq = "".join("ACGT"[j] for j in rng.integers(0, 4, l))
        cig = [(4, "S"), (l - 8, "M"), (4, "S")] if i % 3 else [(l, "M")]
        umi = "".join("ACGT"[j] for j in rng.integers(0, 4, 6))
        aux = (EVERY_AUX[: -len(_aux("RX", "Z", b"ACGTAA\x00"))] if i % 2 else b"") + _aux(
            "RX", "Z", umi.encode() + b"\x00")
        recs.append(_rec(name=f"q{i}", rid=i % 2, pos=100 + 10 * (i // 4),
                         flag=0x10 if i % 5 == 0 else 0, seq=seq,
                         qual=list(rng.integers(2, 41, l)), cigar=cig, aux=aux))
    return _bam(recs, refs=(("chr1", 100000), ("chr2", 100000)))


@pytest.mark.parametrize("duplex", [True, False])
def test_native_and_python_codecs_alike_on_a_foreign_bam(tmp_path, duplex):
    """Every fixture mixed in one file: the port's native loader, the
    JAX one, and both Python codecs give the same ReadBatch and
    counters."""
    from duplexumiconsensusreads_tpu.io.convert import records_to_readbatch as jax_convert
    from duplexumiconsensusreads_tpu.io.native_reader import read_bam_native as jax_native
    from duplexumiconsensusreads_torch.io.convert import records_to_readbatch
    from duplexumiconsensusreads_torch.io.native_reader import read_bam_native

    raw = _foreign_mix(np.random.default_rng(5))
    path = str(tmp_path / "foreign.bam")
    with open(path, "wb") as f:
        f.write(bgzf.compress(raw))
    h_py, r_py = _parsed(raw)
    b_py, i_py = records_to_readbatch(r_py, duplex=duplex)
    jb_py, ji_py = jax_convert(jax_bam.parse_bam(raw)[1], duplex=duplex)
    h_nat, b_nat, i_nat = read_bam_native(path, duplex=duplex)
    jh_nat, jb_nat, ji_nat = jax_native(path, duplex=duplex)
    assert h_nat.ref_names == jh_nat.ref_names == h_py.ref_names
    assert i_nat == ji_nat and i_py == ji_py
    for field in ("bases", "quals", "umi", "pos_key", "strand_ab", "frag_end", "valid"):
        want = np.asarray(getattr(b_py, field))
        for other in (jb_py, b_nat, jb_nat):
            np.testing.assert_array_equal(np.asarray(getattr(other, field)), want,
                                          err_msg=field)


def test_zero_read_name_length_refused_alike():
    body = struct.pack("<iiBBHHHiiii", 0, 100, 0, 60, 0, 0, 0, 4, -1, -1, 0)
    body += struct.pack("<B", (4 << 4) | 1) * 2 + bytes([30] * 4)
    kind, msg = _refused(_bam([struct.pack("<i", len(body)) + body]))
    assert kind == "ValueError" and "corrupt BAM record" in msg


def test_truncation_at_every_boundary_refused_alike():
    rec = _rec(seq="ACGTACGT", qual=[30] * 8, cigar=[(4, "S"), (4, "M")], aux=EVERY_AUX)
    raw = _bam([rec, rec, rec])
    assert len(_parsed(raw)[1]) == 3
    body_start = len(raw) - 3 * len(rec)
    for off in range(1, 3 * len(rec)):
        if off % len(rec):
            _refused(raw[:body_start + off])


def test_unterminated_z_field_refused_alike():
    aux = b"XTZ" + b"no-terminator-here"
    ours = outcome(lambda a: list(bam.iter_aux_fields(a)), aux)
    theirs = outcome(lambda a: list(jax_bam.iter_aux_fields(a)), aux)
    assert ours == theirs and ours[0] == "refused"
    assert "unterminated Z/H" in ours[1][1] and "XT" in ours[1][1]


def test_native_scan_refuses_truncation_alike():
    from duplexumiconsensusreads_tpu.io.native_reader import scan_region as jax_scan
    from duplexumiconsensusreads_tpu.native import get_lib as jax_lib
    from duplexumiconsensusreads_torch.io.native_reader import scan_region
    from duplexumiconsensusreads_torch.native import get_lib

    lib, jlib = get_lib(), jax_lib()
    assert jlib is not None
    rec = _rec(seq="ACGTACGT", qual=[30] * 8, aux=EVERY_AUX)
    raw = _bam([rec, rec])
    body_start = len(raw) - 2 * len(rec)
    full = np.frombuffer(raw, np.uint8)
    ok, jok = scan_region(lib, full), jax_scan(jlib, full)
    for a, b in zip(ok, jok):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for off in range(1, 2 * len(rec), 7):
        if off % len(rec) == 0:
            continue
        cut = np.frombuffer(raw[: body_start + off], np.uint8)
        ours, theirs = outcome(scan_region, lib, cut), outcome(jax_scan, jlib, cut)
        assert ours[0] == theirs[0] == "refused" and ours[1][0] == theirs[1][0]


def test_aux_walker_and_strip_alike_on_random_blobs():
    """Random valid aux blobs and cuts of them (tests/test_foreign_bam.py's
    generator): iter_aux_fields and strip_aux_tag give the JAX
    package's fields and bytes, and refuse the same cuts."""
    rng = random.Random(7)
    tags = ["AA", "BB", "RX", "MI", "cd", "XZ"]

    def rand_field():
        tag = rng.choice(tags).encode()
        kind = rng.randrange(6)
        if kind == 0:
            return tag + b"A" + bytes([rng.randrange(33, 120)])
        if kind == 1:
            t = rng.choice([b"c", b"C", b"s", b"S", b"i", b"I", b"f"])
            size = {b"c": 1, b"C": 1, b"s": 2, b"S": 2}.get(t, 4)
            return tag + t + bytes(rng.randrange(256) for _ in range(size))
        if kind == 2:
            return tag + b"Z" + bytes(rng.randrange(33, 126)
                                      for _ in range(rng.randrange(0, 9))) + b"\x00"
        if kind == 3:
            return tag + b"H" + b"AB" * rng.randrange(0, 4) + b"\x00"
        sub = rng.choice([b"c", b"C", b"s", b"S", b"i", b"I", b"f"])
        esz = {b"c": 1, b"C": 1, b"s": 2, b"S": 2}.get(sub, 4)
        cnt = rng.randrange(0, 5)
        return (tag + b"B" + sub + struct.pack("<I", cnt)
                + bytes(rng.randrange(256) for _ in range(cnt * esz)))

    walk = lambda mod: lambda a: list(mod.iter_aux_fields(a))  # noqa: E731
    for _trial in range(200):
        fields = [rand_field() for _ in range(rng.randrange(0, 7))]
        aux = b"".join(fields)
        walked = walk(bam)(aux)
        assert walked == walk(jax_bam)(aux)
        assert [aux[s:e] for s, _, _, _, e in walked] == fields
        victim = rng.choice(tags)
        assert bam.strip_aux_tag(aux, victim) == jax_bam.strip_aux_tag(aux, victim)
        if aux:
            cut = aux[:rng.randrange(1, len(aux))]
            assert outcome(walk(bam), cut) == outcome(walk(jax_bam), cut)
