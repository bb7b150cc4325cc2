"""End-to-end round-trip tests — THE acceptance oracle.

Mirrors the reference's functional test (byte-exact `diff` of the
decompressed file, /root/reference/scripts/simple_test.sh:59-69 and
INSTALL:21-23) plus the Zhang-2017 breaker corpus the 1.1.0 changelog calls
out (/root/reference/README.md:90-91): reads < k, N-rich reads, empty
records, multiline FASTA, gz input, missing final newline.
"""

import gzip
import os

import numpy as np
import pytest

from leon_tpu import pipeline
from leon_tpu.config import LeonConfig

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_toy_fasta(path, seed=0x70E):
    """Seeded stand-in for the reference's toy.fasta: 200 simulated reads
    x 100 bp at 1% substitution error, forward and reverse-complement,
    from one random contig (the conftest.random_reads model)."""
    from conftest import random_reads

    rng = np.random.default_rng(seed)
    contig = rng.integers(0, 4, 1000, dtype=np.uint8)
    reads = random_reads(rng, 200, lmin=100, lmax=100, contig_len=1000,
                         seed_contig=contig)
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">read_%d er=0.01\n%s\n" % (i, BASES[r].tobytes()))


def small_cfg(**kw):
    kw.setdefault("batch_reads", 64)
    kw.setdefault("reads_per_block", 100)
    return LeonConfig(**kw)


def sim_seq(rng, contig, lmin=60, lmax=100, err=0.01):
    ln = int(rng.integers(lmin, lmax + 1))
    st = int(rng.integers(0, max(1, len(contig) - ln)))
    r = contig[st : st + ln].copy()
    mut = rng.random(ln) < err
    r[mut] = (r[mut] + rng.integers(1, 4, int(mut.sum()))) & 3
    if rng.random() < 0.5:
        r = (3 - r)[::-1]
    return BASES[r].tobytes()


def write_fasta(path, seqs, headers=None, wrap=None, final_newline=True):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            h = headers[i] if headers else b"read%d desc_%d" % (i, i * 3)
            f.write(b">" + h + b"\n")
            if wrap:
                for j in range(0, len(s), wrap):
                    f.write(s[j : j + wrap] + b"\n")
                if len(s) == 0:
                    pass
            else:
                f.write(s + b"\n")
    if not final_newline:
        with open(path, "rb+") as f:
            f.seek(-1, 2)
            f.truncate(f.tell())


def write_fastq(path, seqs, rng, headers=None, plus_text=False):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            h = headers[i] if headers else b"SRR99.%d %d length=%d" % (i, i, len(s))
            q = rng.integers(33, 74, len(s)).astype(np.uint8).tobytes()
            f.write(b"@" + h + b"\n" + s + b"\n")
            f.write((b"+" + h if plus_text else b"+") + b"\n")
            f.write(q + b"\n")


def roundtrip(tmp_path, src, cfg=None, full_match=True):
    cfg = cfg or small_cfg()
    st = pipeline.compress(str(src), cfg=cfg)
    dd = pipeline.decompress(st["output"], cfg=cfg)
    orig = open(src, "rb").read()
    dec = open(dd["output"], "rb").read()
    if full_match:
        assert dec == orig, f"round-trip mismatch: {len(orig)} vs {len(dec)} bytes"
    return st, dd


@pytest.fixture
def contig(rng):
    return rng.integers(0, 4, 600, dtype=np.uint8)


def test_reference_toy_fasta_bytes(tmp_path):
    """Config #1 of BASELINE.json on a toy.fasta-shaped input, with
    headers kept so the oracle is byte-exact."""
    src = tmp_path / "toy.fasta"
    write_toy_fasta(src)
    st, _ = roundtrip(tmp_path, src)
    assert st["n_reads"] == 200
    assert st["n_anchored"] >= 190
    assert st["ratio"] > 2.0


def test_reference_toy_seq_only(tmp_path):
    from leon_tpu.io import bank

    src = tmp_path / "toy.fasta"
    write_toy_fasta(src)
    cfg = small_cfg(seq_only=True)
    st = pipeline.compress(str(src), cfg=cfg)
    dd = pipeline.decompress(st["output"], cfg=cfg)
    a = [s for b in bank.read_blocks(str(src), 1000) for s in b.seqs]
    b = [s for b in bank.read_blocks(dd["output"], 1000) for s in b.seqs]
    assert a == b
    assert st["ratio"] > 8.0  # DNA-only on high-coverage sim reads


def test_fastq_lossless(tmp_path, rng, contig):
    seqs = [sim_seq(rng, contig) for _ in range(150)]
    src = tmp_path / "x.fastq"
    write_fastq(src, seqs, rng)
    roundtrip(tmp_path, src, small_cfg(lossless=True))


def test_fastq_lossy_quals(tmp_path, rng, contig):
    """Lossy mode: DNA + headers byte-exact, qualities per LOSSY-Q1 spec."""
    seqs = [sim_seq(rng, contig) for _ in range(120)]
    src = tmp_path / "x.fastq"
    write_fastq(src, seqs, rng)
    cfg = small_cfg()
    st = pipeline.compress(str(src), cfg=cfg)
    dd = pipeline.decompress(st["output"], cfg=cfg)
    from leon_tpu.io import bank

    a = list(bank.read_blocks(str(src), 1000))[0]
    b = list(bank.read_blocks(dd["output"], 1000))[0]
    assert a.seqs == b.seqs and a.headers == b.headers
    # lossy transform only ever rewrites bytes >= '@' to 'I'
    for qa, qb in zip(a.quals, b.quals):
        for x, y in zip(qa, qb):
            assert y == x or (y == 0x49 and x >= 0x40)
    # and a second round-trip of the lossy output is a fixed point
    st2 = pipeline.compress(dd["output"], str(tmp_path / "x2.leon"), cfg=cfg)
    dd2 = pipeline.decompress(str(tmp_path / "x2.leon"), str(tmp_path / "x2.fastq"), cfg=cfg)
    assert open(dd2["output"], "rb").read() == open(dd["output"], "rb").read()


def test_gz_input(tmp_path, rng, contig):
    seqs = [sim_seq(rng, contig) for _ in range(80)]
    plain = tmp_path / "x.fastq"
    write_fastq(plain, seqs, rng)
    src = tmp_path / "y.fastq.gz"
    with gzip.open(src, "wb") as f:
        f.write(open(plain, "rb").read())
    cfg = small_cfg(lossless=True)
    st = pipeline.compress(str(src), cfg=cfg)
    assert st["output"].endswith("y.fastq.leon")
    dd = pipeline.decompress(st["output"], cfg=cfg)
    assert open(dd["output"], "rb").read() == open(plain, "rb").read()


def test_multiline_fasta(tmp_path, rng, contig):
    seqs = [sim_seq(rng, contig, lmin=150, lmax=300) for _ in range(60)]
    src = tmp_path / "wrapped.fasta"
    write_fasta(src, seqs, wrap=70)
    roundtrip(tmp_path, src)


def test_no_final_newline(tmp_path, rng, contig):
    seqs = [sim_seq(rng, contig) for _ in range(50)]
    src = tmp_path / "nofinal.fasta"
    write_fasta(src, seqs, final_newline=False)
    roundtrip(tmp_path, src)


def test_edge_corpus(tmp_path, rng, contig):
    """Zhang-2017 breaker class: reads < k, == k, N-rich, empty, lowercase."""
    seqs = [sim_seq(rng, contig) for _ in range(60)]
    seqs += [
        b"ACGT",                  # < k
        b"A" * 31,                # == k
        b"N" * 50,                # all exceptions
        b"",                      # empty record
        b"ACGTNNNNACGTACGTACGTNacgtRYKM" * 3,  # mixed junk
        BASES[rng.integers(0, 4, 31)].tobytes(),
    ]
    src = tmp_path / "edge.fasta"
    write_fasta(src, seqs)
    st, _ = roundtrip(tmp_path, src)
    assert st["n_reads"] == 66


def test_fastq_plus_text_and_edge(tmp_path, rng, contig):
    seqs = [sim_seq(rng, contig) for _ in range(40)] + [b"NNNN", b"", b"ACG"]
    src = tmp_path / "plus.fastq"
    write_fastq(src, seqs, rng, plus_text=True)
    roundtrip(tmp_path, src, small_cfg(lossless=True))


def test_noheader_mode(tmp_path, rng, contig):
    seqs = [sim_seq(rng, contig) for _ in range(60)]
    src = tmp_path / "nh.fastq"
    write_fastq(src, seqs, rng)
    cfg = small_cfg(noheader=True, lossless=True)
    st = pipeline.compress(str(src), cfg=cfg)
    dd = pipeline.decompress(st["output"], cfg=cfg)
    from leon_tpu.io import bank

    b = list(bank.read_blocks(dd["output"], 1000))[0]
    assert b.seqs == seqs
    assert b.headers[0] == b"read_0" and b.headers[59] == b"read_59"


def test_noqual_mode(tmp_path, rng, contig):
    seqs = [sim_seq(rng, contig) for _ in range(60)]
    src = tmp_path / "nq.fastq"
    write_fastq(src, seqs, rng)
    cfg = small_cfg(noqual=True)
    st = pipeline.compress(str(src), cfg=cfg)
    dd = pipeline.decompress(st["output"], cfg=cfg)
    from leon_tpu.io import bank

    b = list(bank.read_blocks(dd["output"], 1000))[0]
    assert b.seqs == seqs
    assert all(q == b"I" * len(s) for q, s in zip(b.quals, b.seqs))


def test_multiblock_and_k63(tmp_path, rng):
    contig = rng.integers(0, 4, 2000, dtype=np.uint8)
    seqs = [sim_seq(rng, contig, lmin=80, lmax=120) for _ in range(350)]
    src = tmp_path / "mb.fasta"
    write_fasta(src, seqs)
    st, _ = roundtrip(tmp_path, src, small_cfg(reads_per_block=100, kmer_size=63, abundance=2))
    assert len(st["stream_bytes"]) > 0


def test_explicit_abundance_and_k15(tmp_path, rng, contig):
    seqs = [sim_seq(rng, contig) for _ in range(80)]
    src = tmp_path / "k15.fasta"
    write_fasta(src, seqs)
    st, _ = roundtrip(tmp_path, src, small_cfg(kmer_size=15, abundance=3))
    assert st["abundance"] == 3


def test_long_sequences_segmented(tmp_path, rng):
    """Genome-scale FASTA: contigs longer than max_device_len are segmented
    (FORMAT.md §2) and walk-encoded instead of stored raw."""
    contig = rng.integers(0, 4, 30_000, dtype=np.uint8)
    # contigs + reads covering them (so segments anchor into the graph)
    seqs = [BASES[contig].tobytes(), BASES[contig[1000:15000]].tobytes()]
    seqs += [sim_seq(rng, contig, lmin=200, lmax=400, err=0.005) for _ in range(300)]
    src = tmp_path / "genome.fasta"
    write_fasta(src, seqs, wrap=80)
    cfg = small_cfg(max_device_len=512, abundance=2)
    st, _ = roundtrip(tmp_path, src, cfg)
    # the contigs must ride the graph, not the 2-bit raw fallback (the raw
    # floor for 44 kb of contig alone would be ~11 kb)
    assert st["stream_bytes"].get("rawseq", 0) < 2000
    # low-coverage input (~4.5x), so the stored Bloom filter dominates; the
    # event streams themselves must stay small
    assert st["ratio"] > 2.4


def test_segment_boundary_cases(tmp_path, rng):
    contig = rng.integers(0, 4, 3000, dtype=np.uint8)
    S = 256
    seqs = [
        BASES[contig[:S]].tobytes(),          # exactly seglen
        BASES[contig[: S + 1]].tobytes(),     # seglen + 1 (tail of 1 < k)
        BASES[contig[: 2 * S]].tobytes(),     # two full segments
        BASES[contig[: S + 40]].tobytes(),    # tail > k
        b"",
        b"ACG",
    ]
    seqs += [sim_seq(rng, contig, lmin=100, lmax=200) for _ in range(100)]
    src = tmp_path / "segedge.fasta"
    write_fasta(src, seqs)
    roundtrip(tmp_path, src, small_cfg(max_device_len=S, abundance=2))


def test_k95_multiword(tmp_path, rng):
    """k > 64 (reference needs a KSIZE_LIST recompile; here it is just a
    runtime parameter over W=6 u32 words)."""
    contig = rng.integers(0, 4, 1500, dtype=np.uint8)
    seqs = [sim_seq(rng, contig, lmin=120, lmax=128, err=0.002) for _ in range(120)]
    src = tmp_path / "k95.fasta"
    write_fasta(src, seqs)
    st, _ = roundtrip(tmp_path, src, small_cfg(kmer_size=95, abundance=2))
    assert st["n_anchored"] > 60


def test_checkpoint_resume(tmp_path, rng, contig):
    """Count-phase checkpoint (SURVEY.md §5.4): a matching re-run skips
    counting and produces the identical archive."""
    seqs = [sim_seq(rng, contig) for _ in range(100)]
    src = tmp_path / "ck.fasta"
    write_fasta(src, seqs)
    ck = str(tmp_path / "count.ckpt")
    cfg = small_cfg(checkpoint=ck)
    st1 = pipeline.compress(str(src), str(tmp_path / "a.leon"), cfg=cfg)
    assert os.path.exists(ck)
    st2 = pipeline.compress(str(src), str(tmp_path / "b.leon"), cfg=cfg)
    assert open(tmp_path / "a.leon", "rb").read() == open(tmp_path / "b.leon", "rb").read()
    dd = pipeline.decompress(str(tmp_path / "b.leon"), cfg=cfg)
    assert open(dd["output"], "rb").read() == open(src, "rb").read()


def test_checkpoint_not_shared_across_qual_modes(tmp_path, rng, contig):
    """The auto Bloom sizing differs per quality mode (lossy wants a dense
    filter, bloom.auto_params); a checkpoint written by a lossless run must
    be REJECTED by a lossy run on the same input, not reused (the key
    includes the mode). Both runs still round-trip."""
    import numpy as np

    BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
    src = tmp_path / "q.fastq"
    with open(src, "wb") as f:
        for i in range(120):
            s = sim_seq(rng, contig)
            q = rng.integers(35, 74, len(s)).astype(np.uint8).tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, q))
    ck = str(tmp_path / "q.ckpt")
    # stored-filter regime (no unitig section): in the UNITIGS regime both
    # modes hit the same filter-free bpk floor and the observable below
    # (lossy filter strictly denser) would vanish
    cfg_ll = small_cfg(checkpoint=ck, lossless=True, unitig_sections=False)
    st_ll = pipeline.compress(str(src), str(tmp_path / "ll.leon"), cfg=cfg_ll)
    cfg_lossy = small_cfg(checkpoint=ck, unitig_sections=False)
    st_lo = pipeline.compress(str(src), str(tmp_path / "lo.leon"), cfg=cfg_lossy)
    # lossy auto-sizing is denser: had the lossless checkpoint been reused,
    # the lossy archive's bloom would equal the lossless one
    assert st_lo["bloom_bytes"] > st_ll["bloom_bytes"]
    dd = pipeline.decompress(str(tmp_path / "ll.leon"), cfg=cfg_ll)
    assert open(dd["output"], "rb").read() == open(src, "rb").read()
    dd2 = pipeline.decompress(str(tmp_path / "lo.leon"), cfg=cfg_lossy)
    out = open(dd2["output"], "rb").read().split(b"\n")
    orig = open(src, "rb").read().split(b"\n")
    assert out[::4] == orig[::4] and out[1::4] == orig[1::4]  # hdr + DNA


def test_host_count_fallback(tmp_path, rng, contig, monkeypatch):
    """There is no host-count fallback: a device failure while finalizing
    the count raises out of compress, and a later run on a healthy device
    writes the normal archive."""
    from leon_tpu.ops import count as _count

    seqs = [sim_seq(rng, contig) for _ in range(90)]
    src = tmp_path / "hc.fasta"
    write_fasta(src, seqs)
    a = str(tmp_path / "dev.leon")
    b = str(tmp_path / "host.leon")
    pipeline.compress(str(src), a, cfg=small_cfg())
    assert not hasattr(pipeline, "_count_pass_host")

    def boom(self, *a, **kw):
        raise RuntimeError("synthetic device-count failure")

    with monkeypatch.context() as m:
        m.setattr(_count.DeviceCounter, "finalize", boom)
        with pytest.raises(RuntimeError, match="synthetic device-count failure"):
            pipeline.compress(str(src), b, cfg=small_cfg())
    pipeline.compress(str(src), b, cfg=small_cfg())
    assert open(a, "rb").read() == open(b, "rb").read()
    d = pipeline.decompress(b, cfg=small_cfg())
    assert open(d["output"], "rb").read() == open(src, "rb").read()


def test_compact_overflow_dense_fallback(tmp_path, rng, contig):
    """Chunks whose event streams overflow the compact D2H capacities are
    re-encoded with the dense layout; the archive must be byte-identical
    to one produced with roomy capacities (VERDICT r1 weak #7)."""
    # high error rate -> many error events per read
    seqs = [sim_seq(rng, contig, err=0.08) for _ in range(80)]
    src = tmp_path / "ovf.fastq"
    write_fastq(src, seqs, rng)
    a = str(tmp_path / "roomy.leon")
    b = str(tmp_path / "tiny.leon")
    pipeline.compress(str(src), a, cfg=small_cfg(lossless=True))
    pipeline.compress(
        str(src), b,
        cfg=small_cfg(lossless=True, event_cap_per_read=1, bif_cap_per_read=1),
    )
    assert open(a, "rb").read() == open(b, "rb").read()
    d = pipeline.decompress(b, cfg=small_cfg())
    assert open(d["output"], "rb").read() == open(src, "rb").read()


def test_streaming_mode_identical(tmp_path, rng, contig):
    """Streaming (re-parse per pass) must produce the identical archive to
    the in-memory path."""
    seqs = [sim_seq(rng, contig) for _ in range(120)]
    src = tmp_path / "stream.fastq"
    write_fastq(src, seqs, rng)
    a = str(tmp_path / "mem.leon")
    b = str(tmp_path / "str.leon")
    pipeline.compress(str(src), a, cfg=small_cfg(lossless=True))
    pipeline.compress(str(src), b, cfg=small_cfg(lossless=True, stream_threshold_bytes=1))
    assert open(a, "rb").read() == open(b, "rb").read()
    d = pipeline.decompress(b, cfg=small_cfg())
    assert open(d["output"], "rb").read() == open(src, "rb").read()


def test_multiline_fastq(tmp_path, rng, contig):
    """Wrapped (multi-line) FASTQ records — the GATB bank accepts them [R];
    streams 14/17 preserve the line structure byte-exactly."""
    seqs = [sim_seq(rng, contig) for _ in range(60)]
    src = tmp_path / "wrapped.fastq"
    with open(src, "wb") as f:
        for i, s in enumerate(seqs):
            q = rng.integers(33, 74, len(s)).astype(np.uint8).tobytes()
            f.write(b"@W.%d x%d\n" % (i, i))
            wrap = 40 if i % 3 == 0 else (25 if i % 3 == 1 else len(s))
            for j in range(0, max(1, len(s)), wrap):
                f.write(s[j : j + wrap] + b"\n")
            f.write(b"+\n")
            # qualities wrap differently from the sequence on every 5th read
            qwrap = 30 if i % 5 == 0 else wrap
            for j in range(0, max(1, len(q)), qwrap):
                f.write(q[j : j + qwrap] + b"\n")
    roundtrip(tmp_path, src, cfg=small_cfg(lossless=True))


def test_multiline_fastq_same_wrap_and_lossy(tmp_path, rng, contig):
    seqs = [sim_seq(rng, contig) for _ in range(40)]
    src = tmp_path / "wrapped2.fastq"
    with open(src, "wb") as f:
        for i, s in enumerate(seqs):
            q = np.full(len(s), 70, np.uint8).tobytes()
            f.write(b"@W.%d\n" % i)
            for j in range(0, max(1, len(s)), 33):
                f.write(s[j : j + 33] + b"\n")
            f.write(b"+\n")
            for j in range(0, max(1, len(q)), 33):
                f.write(q[j : j + 33] + b"\n")
    # lossy: DNA+headers byte-exact; quality transform maps >= 0x40 at
    # confirmed positions to 'I' — with all-0x46 input the output stays
    # valid FASTQ with identical line structure
    st = pipeline.compress(str(src), cfg=small_cfg())
    dd = pipeline.decompress(st["output"], cfg=small_cfg())
    from leon_tpu.io import bank

    a = list(bank.read_blocks(str(src), 1000))
    b = list(bank.read_blocks(dd["output"], 1000))
    assert [blk.seqs for blk in a] == [blk.seqs for blk in b]
    assert [blk.headers for blk in a] == [blk.headers for blk in b]
    assert [blk.line_lens for blk in a] == [blk.line_lens for blk in b]


def test_realistic_generator_roundtrip(tmp_path):
    """Realistic synthetic FASTQ (scripts/gen_realistic.py: repeat-bearing
    genome, instrument-format headers, empirical-shape qualities) must
    round-trip byte-exactly lossless and header/DNA-exactly lossy — the
    no-network stand-in for the reference's real SRA oracle
    (scripts/simple_test.sh SRR387476)."""
    import importlib.util
    import sys as _sys

    spec = importlib.util.spec_from_file_location(
        "gen_realistic",
        os.path.join(os.path.dirname(__file__), "..", "scripts", "gen_realistic.py"),
    )
    gr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gr)
    for legacy in (False, True):
        src = str(tmp_path / f"real{int(legacy)}.fastq")
        gr.gen(src, 400, 100, 20_000, 17 + legacy, legacy)
        out = str(tmp_path / f"real{int(legacy)}.leon")
        pipeline.compress(src, out, cfg=small_cfg(lossless=True))
        d = pipeline.decompress(out, str(tmp_path / f"real{int(legacy)}.out"),
                                cfg=small_cfg(lossless=True))
        assert open(src, "rb").read() == open(d["output"], "rb").read()


def test_realistic_generator_hard_shapes(tmp_path):
    """Round-5 oracle hardening (VERDICT r4 #7a): mixed-separator SRA-style
    headers, run-end quality degradation, no-call Ns at min-quality
    positions, long-tail lengths — all byte-exact lossless."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gen_realistic",
        os.path.join(os.path.dirname(__file__), "..", "scripts", "gen_realistic.py"),
    )
    gr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gr)
    cases = [
        dict(header_style="sra", n_rate=0.0, len_model="fixed"),
        dict(header_style="mixed", n_rate=0.3, len_model="fixed"),
        dict(header_style="rta3", n_rate=0.1, len_model="longtail"),
    ]
    for ci, kw in enumerate(cases):
        src = str(tmp_path / f"hard{ci}.fastq")
        gr.gen(src, 300, 100, 20_000, 41 + ci, legacy=bool(ci % 2), **kw)
        out = str(tmp_path / f"hard{ci}.leon")
        pipeline.compress(src, out, cfg=small_cfg(lossless=True))
        d = pipeline.decompress(out, str(tmp_path / f"hard{ci}.out"),
                                cfg=small_cfg(lossless=True))
        assert open(src, "rb").read() == open(d["output"], "rb").read(), kw
