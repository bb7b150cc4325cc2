"""UNITIGS section tests (FORMAT.md §4a, format v4).

The solid k-mer set is stored as unitigs and the decoder rebuilds the
encoder's bit-identical Bloom filter — the replacement for the
reference's serialized filter ([R] Leon.cpp executeCompression writes
the bitset whole; SURVEY.md §3.2 step 3/§3.3 step 1).
"""

import numpy as np
import pytest

from leon_tpu.ops import bloom, count, unitig
from leon_tpu.ops import kmer as K


def make_solid(rng, k, n_contigs=3, L=300, cov=3):
    """Distinct canonical k-mer run (uniq sorted ascending, counts) from
    a few random contigs at uniform coverage."""
    contigs = [rng.integers(0, 4, L, dtype=np.uint8) for _ in range(n_contigs)]
    codes = np.stack([c for c in contigs for _ in range(cov)])
    lengths = np.full(codes.shape[0], L, np.int32)
    canon, _, valid = K.kmer_scan(codes, lengths, k)
    uniq, counts = count.count_batch(np.asarray(canon), np.asarray(valid))
    return uniq, counts.astype(np.int32)


def unitig_kmer_set(payload, k):
    """All canonical k-mers spelled by the payload's unitigs, sorted."""
    lens, codes = unitig.parse_payload(payload, k)
    out = []
    pos = 0
    for ln in lens:
        seg = codes[pos : pos + ln]
        pos += ln
        win = np.stack([seg[i : i + k] for i in range(ln - k + 1)])
        fwd = K.pack_codes_batch_np(win, k)
        rcw = K.pack_codes_batch_np((3 - win)[:, ::-1], k)
        take = unitig._np_lex_less(rcw, fwd)
        out.append(np.where(take[:, None], rcw, fwd))
    return np.concatenate(out)


def sort_words(w):
    W = w.shape[1]
    return w[np.lexsort([w[:, j] for j in range(W)])]


@pytest.mark.parametrize("k", [15, 31, 33])
def test_np_payload_spells_exact_solid_set(rng, k):
    uniq, counts = make_solid(rng, k)
    cutoff = 2
    payload = unitig.build_np_payload(uniq, counts, cutoff, k, uniq.shape[0])
    assert payload is not None
    solid = uniq[counts >= cutoff]
    got = unitig_kmer_set(payload, k)
    # every solid k-mer exactly once, none extra
    assert got.shape[0] == solid.shape[0]
    np.testing.assert_array_equal(sort_words(got), sort_words(solid))


@pytest.mark.parametrize("k", [15, 31])
def test_rebuild_bitset_identical(rng, k):
    uniq, counts = make_solid(rng, k)
    cutoff = 2
    payload = unitig.build_np_payload(uniq, counts, cutoff, k, uniq.shape[0])
    solid = uniq[counts >= cutoff]
    n_words = bloom.choose_n_words(len(solid), 12.0)
    H, seed = 4, 7
    want = bloom.build_np(solid, n_words, H, seed, k)
    got = unitig.rebuild_bitset_np(payload, k, n_words, H, seed)
    np.testing.assert_array_equal(got, want)


def test_cycle_is_emitted_once(rng):
    """A circular contig's k-mer set forms a pure cycle in the chain
    graph; it must be broken at one node and spelled exactly once."""
    k = 15
    contig = rng.integers(0, 4, 200, dtype=np.uint8)
    circ = np.concatenate([contig, contig[: k - 1]])
    codes = np.stack([circ] * 3)
    lengths = np.full(3, circ.size, np.int32)
    canon, _, valid = K.kmer_scan(codes, lengths, k)
    uniq, counts = count.count_batch(np.asarray(canon), np.asarray(valid))
    cutoff = 2
    payload = unitig.build_np_payload(uniq, counts.astype(np.int32), cutoff, k,
                                      uniq.shape[0])
    assert payload is not None
    solid = uniq[counts >= cutoff]
    got = unitig_kmer_set(payload, k)
    assert got.shape[0] == solid.shape[0]
    np.testing.assert_array_equal(sort_words(got), sort_words(solid))


def _pad_run(uniq, counts):
    """Pad to a bucketed capacity the way DeviceCounter does (pads sort
    last: all-ones words, count 0)."""
    nu = uniq.shape[0]
    Mcap = unitig._bucket(nu)
    W = uniq.shape[1]
    wpad = np.full((Mcap, W), 0xFFFFFFFF, np.uint32)
    wpad[:nu] = uniq
    cpad = np.zeros(Mcap, np.int32)
    cpad[:nu] = counts
    return wpad, cpad


@pytest.mark.parametrize("k", [15, 31, 33])
@pytest.mark.parametrize("with_n_solid", [False, True])
def test_device_payload_matches_np(rng, k, with_n_solid):
    import jax.numpy as jnp

    uniq, counts = make_solid(rng, k, n_contigs=2, L=250)
    cutoff = 2
    nu = uniq.shape[0]
    want = unitig.build_np_payload(uniq, counts, cutoff, k, nu)
    wpad, cpad = _pad_run(uniq, counts)
    n_solid = int((counts >= cutoff).sum()) if with_n_solid else None
    infl = unitig.dispatch_build(jnp.asarray(wpad), jnp.asarray(cpad),
                                 cutoff, k, nu, n_solid=n_solid)
    got = unitig.drain_build(infl)
    assert got == want


def _sparse_solid_run(rng, k):
    """Distinct run whose solid fraction puts _bucket(n_solid) well below
    Mcap, so dispatch_build's compaction path actually triggers."""
    covered = rng.integers(0, 4, 700, dtype=np.uint8)
    rows = [covered, covered]  # cov 2 -> solid
    for _ in range(24):  # singletons -> sub-cutoff
        rows.append(rng.integers(0, 4, 1400, dtype=np.uint8))
    L = max(r.size for r in rows)
    codes = np.stack([np.pad(r, (0, L - r.size)) for r in rows])
    lengths = np.array([r.size for r in rows], np.int32)
    canon, _, valid = K.kmer_scan(codes, lengths, k)
    uniq, counts = count.count_batch(np.asarray(canon), np.asarray(valid))
    return uniq, counts.astype(np.int32)


def test_device_compaction_matches_np(rng):
    """The n_solid compaction path (device scatter to a smaller bucket)
    must be byte-identical to the uncompacted and np builds — the frozen
    section-choice / shard-invariance contract (FORMAT.md §4a)."""
    import jax.numpy as jnp

    k = 15
    uniq, counts = _sparse_solid_run(rng, k)
    cutoff = 2
    nu = uniq.shape[0]
    n_solid = int((counts >= cutoff).sum())
    assert unitig._bucket(n_solid) < unitig._bucket(nu), "fixture too dense"
    want = unitig.build_np_payload(uniq, counts, cutoff, k, nu)
    assert want is not None
    wpad, cpad = _pad_run(uniq, counts)
    infl = unitig.dispatch_build(jnp.asarray(wpad), jnp.asarray(cpad),
                                 cutoff, k, nu, n_solid=n_solid)
    assert int(infl.words.shape[0]) == unitig._bucket(n_solid)  # compacted
    assert unitig.drain_build(infl) == want


def test_device_compaction_undercount_falls_back(rng):
    """An n_solid undercount must NEVER produce a corrupt payload: the
    device guard zeroes the counts on overflow so drain_build returns
    None (BLOOM fallback) instead of a payload missing solid k-mers."""
    import jax.numpy as jnp

    k = 15
    contig = rng.integers(0, 4, 6000, dtype=np.uint8)
    codes = np.stack([contig, contig])
    lengths = np.full(2, contig.size, np.int32)
    canon, _, valid = K.kmer_scan(codes, lengths, k)
    uniq, counts = count.count_batch(np.asarray(canon), np.asarray(valid))
    counts = counts.astype(np.int32)
    cutoff = 2
    nu = uniq.shape[0]
    true_solid = int((counts >= cutoff).sum())
    assert true_solid > 4096  # must overflow the floor bucket
    wpad, cpad = _pad_run(uniq, counts)
    infl = unitig.dispatch_build(jnp.asarray(wpad), jnp.asarray(cpad),
                                 cutoff, k, nu, n_solid=10)
    assert int(infl.words.shape[0]) == 4096  # compaction did trigger
    assert unitig.drain_build(infl) is None


@pytest.mark.parametrize("extra", [0, 1])
def test_device_cycle_matches_np(rng, extra):
    """Circular contigs (pure cycles, odd and power-of-2-prone lengths)
    through the DEVICE build match the np payload bit-exactly."""
    import jax.numpy as jnp

    k = 15
    n = 200 + extra  # vary cycle length parity/shape
    contig = rng.integers(0, 4, n, dtype=np.uint8)
    circ = np.concatenate([contig, contig[: k - 1]])
    codes = np.stack([circ] * 3)
    lengths = np.full(3, circ.size, np.int32)
    canon, _, valid = K.kmer_scan(codes, lengths, k)
    uniq, counts = count.count_batch(np.asarray(canon), np.asarray(valid))
    counts = counts.astype(np.int32)
    cutoff = 2
    nu = uniq.shape[0]
    want = unitig.build_np_payload(uniq, counts, cutoff, k, nu)
    assert want is not None
    wpad, cpad = _pad_run(uniq, counts)
    infl = unitig.dispatch_build(jnp.asarray(wpad), jnp.asarray(cpad),
                                 cutoff, k, nu)
    got = unitig.drain_build(infl)
    assert got == want
    solid = uniq[counts >= cutoff]
    spelled = unitig_kmer_set(got, k)
    assert spelled.shape[0] == solid.shape[0]
    np.testing.assert_array_equal(sort_words(spelled), sort_words(solid))


def test_empty_and_tiny_inputs():
    k = 15
    assert unitig.build_np_payload(np.zeros((0, 1), np.uint32),
                                   np.zeros(0, np.int32), 2, k, 0) is None
    # a single solid k-mer: one chain of length k (the k-mer is chosen
    # not to be adjacent to its own revcomp, which would legitimately
    # produce a 2-node self-twin chain spelling it twice)
    codes = np.array([0, 0, 2, 1, 3, 0, 1, 1, 2, 0, 3, 3, 1, 0, 2], np.uint8)
    w = K.pack_codes_batch_np(codes[None], k)
    rc = K.pack_codes_batch_np((3 - codes)[None, ::-1], k)
    canon = np.where(unitig._np_lex_less(rc, w)[:, None], rc, w)
    payload = unitig.build_np_payload(canon, np.array([3], np.int32), 2, k, 1)
    assert payload is not None
    lens, flat = unitig.parse_payload(payload, k)
    assert lens.tolist() == [k]
    got = unitig_kmer_set(payload, k)
    np.testing.assert_array_equal(got, canon)


def test_container_section_choice(rng, tmp_path):
    """Default cfg writes UNITIGS when smaller; unitig_sections=False
    writes BLOOM; both round-trip byte-exact and decode identically."""
    from leon_tpu import pipeline
    from leon_tpu.config import LeonConfig
    from leon_tpu.io import container

    lines = []
    contig = "".join("ACGT"[b] for b in rng.integers(0, 4, 600))
    for i in range(120):
        s = int(rng.integers(0, 500))
        lines.append(f">r{i}\n{contig[s:s+100]}\n")
    src = tmp_path / "in.fasta"
    src.write_bytes("".join(lines).encode())

    out_u = str(tmp_path / "u.leon")
    pipeline.compress(str(src), out_u, LeonConfig())
    r = container.Reader(out_u)
    assert r.unitigs_payload is not None and not r.bloom_payload
    r.close()

    out_b = str(tmp_path / "b.leon")
    pipeline.compress(str(src), out_b, LeonConfig(unitig_sections=False))
    r = container.Reader(out_b)
    assert r.unitigs_payload is None and r.bloom_payload
    r.close()

    dec_u = str(tmp_path / "u.fasta")
    dec_b = str(tmp_path / "b.fasta")
    pipeline.decompress(out_u, dec_u)
    pipeline.decompress(out_b, dec_b)
    want = src.read_bytes()
    assert open(dec_u, "rb").read() == want
    assert open(dec_b, "rb").read() == want


class TestDictV2:
    """Solid-indexed DICT payload (FORMAT.md §5, container v5)."""

    def _dict_and_solid(self, rng, k=15, n_anchor=400, with_miss=True):
        from leon_tpu.codecs import blocks as blockcodec

        uniq, counts = make_solid(rng, k, n_contigs=4, L=400)
        cutoff = 2
        solid = uniq[counts >= cutoff]
        W = solid.shape[1]
        d = blockcodec.AnchorDict(W)
        pick = rng.integers(0, solid.shape[0], n_anchor)
        for i in pick:
            d.index(solid[i])
        if with_miss:
            # a key outside the solid set (Bloom-FP anchor analog)
            fake = solid[0].copy()
            fake[0] ^= np.uint32(0x5A5A5A5A)
            d.index(fake)
        # sorted ascending big-int (MSW-significant) order
        key = np.ascontiguousarray(solid.astype("<u4")[:, ::-1]).view(
            [("", "<u4")] * W).reshape(-1)
        return d, solid[np.argsort(key, kind="stable")]

    def test_payload_roundtrip_and_smaller(self, rng):
        from leon_tpu.codecs import blocks as blockcodec

        d, solid_sorted = self._dict_and_solid(rng)
        W = d.W
        raw = d.payload(None)
        idxed = d.payload(solid_sorted)
        assert idxed[0] == 1 and raw[0] == 0
        assert len(idxed) < len(raw)
        got = blockcodec.AnchorDict.from_payload_v5(
            idxed, W, solid_provider=lambda: solid_sorted)
        assert got._words == d._words
        got_raw = blockcodec.AnchorDict.from_payload_v5(
            raw, W, solid_provider=lambda: solid_sorted)
        assert got_raw._words == d._words

    def test_solid_size_mismatch_rejected(self, rng):
        from leon_tpu.codecs import blocks as blockcodec

        d, solid_sorted = self._dict_and_solid(rng)
        idxed = d.payload(solid_sorted)
        with pytest.raises(ValueError, match="mismatch"):
            blockcodec.AnchorDict.from_payload_v5(
                idxed, d.W, solid_provider=lambda: solid_sorted[:-1])

    @pytest.mark.parametrize("k", [15, 31, 33, 63])
    def test_native_chains_payload_matches_numpy(self, rng, k):
        """The native O(n) chain builder must produce the byte-identical
        payload to the numpy reference (_np_chains) — the §4a payload is
        the frozen decode contract."""
        from leon_tpu import native

        if native.get_lib() is None:
            pytest.skip("native lib unavailable")
        uniq, counts = make_solid(rng, k)
        import unittest.mock as _mock

        p_native = unitig.build_np_payload(uniq, counts, 2, k, uniq.shape[0])
        with _mock.patch.object(unitig, "_native_chains", lambda *a: None):
            p_np = unitig.build_np_payload(uniq, counts, 2, k, uniq.shape[0])
        assert p_native == p_np

    @pytest.mark.parametrize("extra", [0, 1, 2])
    def test_native_chains_cycle_matches_numpy(self, rng, extra):
        """Cycle cut + palindromic twins through the NATIVE chain builder
        must match the numpy reference byte-for-byte (the cycle-breaking
        rule — cut the edge into the cycle's min-id node — is the
        subtlest shared semantic)."""
        from leon_tpu import native

        if native.get_lib() is None:
            pytest.skip("native lib unavailable")
        k = 15
        n = 200 + extra
        contig = rng.integers(0, 4, n, dtype=np.uint8)
        circ = np.concatenate([contig, contig[: k - 1]])
        # a reverse-complement palindromic stretch provokes self-twin
        # chains alongside the pure cycle
        pal = rng.integers(0, 4, 40, dtype=np.uint8)
        pal_seq = np.concatenate([pal, (3 - pal)[::-1]])
        codes = [circ] * 3 + [pal_seq] * 3
        L = max(len(c) for c in codes)
        mat = np.zeros((len(codes), L), np.uint8)
        lengths = np.zeros(len(codes), np.int32)
        for i, c in enumerate(codes):
            mat[i, : len(c)] = c
            lengths[i] = len(c)
        canon, _, valid = K.kmer_scan(mat, lengths, k)
        uniq, counts = count.count_batch(np.asarray(canon), np.asarray(valid))
        counts = counts.astype(np.int32)
        import unittest.mock as _mock

        p_native = unitig.build_np_payload(uniq, counts, 2, k, uniq.shape[0])
        with _mock.patch.object(unitig, "_native_chains", lambda *a: None):
            p_np = unitig.build_np_payload(uniq, counts, 2, k, uniq.shape[0])
        assert p_native == p_np

    @pytest.mark.parametrize("k", [15, 31, 33, 63])
    def test_spell_canon_native_matches_numpy(self, rng, k):
        """The native rolling spell and the numpy chunked spell must be
        bit-identical — the DICT enumeration and bitset rebuild both hang
        off this function (decoder determinism)."""
        from leon_tpu import native

        if native.get_lib() is None:
            pytest.skip("native lib unavailable")
        uniq, counts = make_solid(rng, k)
        payload = unitig.build_np_payload(uniq, counts, 2, k, uniq.shape[0])
        lens, codes = unitig.parse_payload(payload, k)
        native_rows = unitig.spell_canon(payload, k)
        # numpy reference: the chunked-window path (force-skip the lib)
        import unittest.mock as _mock

        with _mock.patch.object(native, "get_lib", lambda: None):
            np_rows = unitig.spell_canon(payload, k)
        np.testing.assert_array_equal(native_rows, np_rows)

    def test_solid_kmers_sorted_matches_solid_set(self, rng):
        k = 15
        uniq, counts = make_solid(rng, k)
        cutoff = 2
        payload = unitig.build_np_payload(uniq, counts, cutoff, k,
                                          uniq.shape[0])
        got = unitig.solid_kmers_sorted(payload, k)
        want = sort_words(uniq[counts >= cutoff])
        np.testing.assert_array_equal(got, want)
        # already ascending (stable argsort is the identity) and distinct
        key = np.ascontiguousarray(got.astype("<u4")[:, ::-1]).view(
            [("", "<u4")] * got.shape[1]).reshape(-1)
        assert (np.argsort(key, kind="stable") == np.arange(key.size)).all()
        assert np.unique(key).size == key.size

    def test_old_container_versions_refused(self, rng, tmp_path):
        """Containers v3-v5 used the two-chain hash family (pre-v6): their
        walk events cannot be decoded by the v4-family coder, so the
        Reader must refuse them with a clear re-compress hint instead of
        mis-decoding (FORMAT.md changelog)."""
        from leon_tpu import pipeline
        from leon_tpu.config import LeonConfig
        from leon_tpu.io import container

        lines = []
        contig = "".join("ACGT"[b] for b in rng.integers(0, 4, 600))
        for i in range(50):
            s = int(rng.integers(0, 500))
            lines.append(f">v{i}\n{contig[s:s+100]}\n")
        src = tmp_path / "in.fasta"
        src.write_bytes("".join(lines).encode())
        out = str(tmp_path / "x.leon")
        pipeline.compress(str(src), out, LeonConfig(unitig_sections=False))
        data = bytes(open(out, "rb").read())
        assert data[8] == container.VERSION
        for old in (3, 4, 5):
            p = str(tmp_path / f"v{old}.leon")
            open(p, "wb").write(data[:8] + bytes([old]) + data[9:])
            with pytest.raises(ValueError, match="older leon-tpu"):
                container.Reader(p)


def test_host_builder_path_byte_identical(rng, tmp_path):
    """Solid sets above unitig_device_max_kmers build on HOST (threaded);
    the archive must be byte-identical to the device-builder archive
    (forced by setting the cap below/above the set's size)."""
    from leon_tpu import pipeline
    from leon_tpu.config import LeonConfig
    from leon_tpu.io import container

    lines = []
    contig = "".join("ACGT"[b] for b in rng.integers(0, 4, 800))
    for i in range(150):
        s = int(rng.integers(0, 700))
        lines.append(f">h{i}\n{contig[s:s+100]}\n")
    src = tmp_path / "in.fasta"
    src.write_bytes("".join(lines).encode())
    common = dict(batch_reads=64, reads_per_block=128)
    a = str(tmp_path / "host.leon")
    b = str(tmp_path / "dev.leon")
    pipeline.compress(str(src), a, LeonConfig(unitig_device_max_kmers=16, **common))
    pipeline.compress(str(src), b, LeonConfig(**common))
    assert open(a, "rb").read() == open(b, "rb").read()
    r = container.Reader(a)
    assert r.unitigs_payload is not None  # the host path DID write UNITIGS
    r.close()
    d = pipeline.decompress(a, cfg=LeonConfig(**common))
    assert open(d["output"], "rb").read() == src.read_bytes()


def test_self_twin_chain_dict_enumeration(rng, tmp_path):
    """A unitig adjacent to its own reverse complement spells its k-mers
    TWICE in the payload (legitimately); the DICT enumeration must dedup
    so encoder (distinct run) and decoder (spelled payload) agree.
    Regression: hypothesis found poly-A reads raising 'solid-set size
    mismatch' on decompress."""
    from leon_tpu import pipeline
    from leon_tpu.config import LeonConfig

    src = tmp_path / "polya.fasta"
    reads = [b"A" * 40, b"A" * 40, b"A" * 40,
             b"AAAAAAAAAATTTTTTTTTTAAAAAAAAAA"] * 3
    src.write_bytes(b"".join(b">p%d\n%s\n" % (i, r) for i, r in enumerate(reads)))
    cfg = LeonConfig(kmer_size=15, batch_reads=64, reads_per_block=64)
    st = pipeline.compress(str(src), str(tmp_path / "p.leon"), cfg)
    d = pipeline.decompress(str(tmp_path / "p.leon"), cfg=cfg)
    assert open(d["output"], "rb").read() == src.read_bytes()
