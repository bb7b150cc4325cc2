"""Unitig (spectrum-preserving string set) coding of the solid k-mer set.

The reference stores its de Bruijn graph membership structure by writing
the Bloom bitset into the archive ([R] Leon.cpp executeCompression: the
filter is serialized whole; SURVEY.md §3.2 step 3). At 12-30 bits per
solid k-mer that section is the single largest component of a DNA-mode
archive. This module replaces it: the solid set is stored as its maximal
non-branching paths (unitigs) at ~2 bits per k-mer + (k-1) bases per
path, and the DECODER rebuilds the bit-identical Bloom filter (same
n_words / n_hashes / seed from META) by re-inserting every unitig k-mer.
Walk semantics are untouched — both sides probe the same bits.

Device construction: the directed graph over canonical solid k-mers
(2 oriented nodes per k-mer) is built with batched binary searches over
the sorted distinct array, unitig chains are ranked with O(log n) rounds
of pointer doubling (list ranking — the parallel analog of the
sequential C pointer walk a CPU tool would use), and the base stream is
emitted with vectorized scatters. One device launch, one small D2H.

A numpy mirror (`build_np_payload`) is the reference and the host builder;
it MUST produce byte-identical payloads (tested) — both operate on the
same sorted distinct array, so every id, tie-break and emission order
coincides by construction.

Cycles: components of the restricted graph are pure chains or pure
cycles (any edge into a cycle node raises its in-degree past 1, which
already severs the cycle edge there). Cycles are broken at their
minimum-id node; chain/cycle twins (reverse complements) are deduplicated
by the rule "keep the component whose minimum directed id is <= the
minimum over its twin ids", which keeps self-reverse-complement
components exactly once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from leon_tpu.utils import varint

__all__ = [
    "chains_cap", "build_np_payload", "dispatch_build", "drain_build",
    "payload_from", "parse_payload", "rebuild_bitset_np",
    "solid_kmers_sorted",
]


def _bucket(n: int, floor: int = 1 << 12) -> int:
    """1/8-octave size buckets (mirrors ops.count._bucket_size)."""
    gran = max(floor, 1 << max(0, (n - 1).bit_length() - 3))
    return -(-n // gran) * gran


def chains_cap(nu: int) -> int:
    """Static chain-count capacity for a distinct-set size nu. FROZEN: the
    np and device paths must agree on the overflow rule so the section
    choice (UNITIGS vs BLOOM) is identical on both."""
    return max(4096, _bucket(max(1, nu)) >> 6)


RETRY_FACTOR = 8  # one capacity retry at cap*RETRY_FACTOR, then BLOOM


# ---------------------------------------------------------------------------
# numpy reference implementation
# ---------------------------------------------------------------------------


def _np_lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a < b over (..., W) u32 LSW-first vectors as big integers."""
    W = a.shape[-1]
    less = np.zeros(a.shape[:-1], bool)
    eq = np.ones(a.shape[:-1], bool)
    for j in range(W - 1, -1, -1):
        less |= eq & (a[..., j] < b[..., j])
        eq &= a[..., j] == b[..., j]
    return less


def _np_shl2(words: np.ndarray, base: int, k: int) -> np.ndarray:
    """((kmer << 2) | base) & mask — np mirror of kmer.shl2."""
    from leon_tpu.ops.kmer import top_mask

    W = words.shape[-1]
    out = np.empty_like(words)
    out[..., 0] = (words[..., 0] << np.uint32(2)) | np.uint32(base)
    for j in range(1, W):
        out[..., j] = (words[..., j] << np.uint32(2)) | (words[..., j - 1] >> np.uint32(30))
    out[..., W - 1] &= np.uint32(top_mask(k))
    return out


def _np_shr2_ins(words: np.ndarray, base: int, k: int) -> np.ndarray:
    """(kmer >> 2) | (base << 2(k-1)) — np mirror of kmer.shr2_ins."""
    W = words.shape[-1]
    out = np.empty_like(words)
    for j in range(W - 1):
        out[..., j] = (words[..., j] >> np.uint32(2)) | (words[..., j + 1] << np.uint32(30))
    out[..., W - 1] = words[..., W - 1] >> np.uint32(2)
    t = 2 * (k - 1)
    out[..., t // 32] |= np.uint32(base) << np.uint32(t % 32)
    return out


def _np_searchsorted_words(hay: np.ndarray, needles: np.ndarray) -> np.ndarray:
    """hay (M, W) sorted ascending as big ints -> (N,) index or -1."""
    W = hay.shape[1]
    dt = np.dtype([(f"w{j}", ">u4") for j in range(W - 1, -1, -1)])

    def rec(x):
        r = np.empty(x.shape[0], dtype=dt)
        for j in range(W):
            r[f"w{j}"] = x[:, j]
        return r

    if hay.shape[0] == 0:
        return np.full(needles.shape[0], -1, np.int64)
    h, n = rec(np.ascontiguousarray(hay)), rec(np.ascontiguousarray(needles))
    idx = np.searchsorted(h, n)
    idxc = np.clip(idx, 0, hay.shape[0] - 1)
    return np.where(h[idxc] == n, idxc, -1)


def _np_chains(words: np.ndarray, counts: np.ndarray, cutoff: int, k: int):
    """Core graph construction + list ranking. Returns per-directed-node
    arrays (nxt-final, head, rank, kept, keep_head) plus fwd forms."""
    from leon_tpu.ops.kmer import revcomp_words_batch_np

    M = words.shape[0]
    solid = counts.astype(np.int64) >= cutoff
    rc = revcomp_words_batch_np(words, k) if M else words.copy()
    # F[did] = spelled form of directed node did = 2*i + o
    F = np.stack([words, rc], axis=1).reshape(2 * M, -1)
    solid2 = np.repeat(solid, 2)

    succ = np.full(2 * M, -1, np.int64)
    outc = np.zeros(2 * M, np.int32)
    for o in (0, 1):
        ids = np.arange(M) * 2 + o
        x = F[ids]
        xr = F[ids ^ 1]
        for b in range(4):
            y = _np_shl2(x, b, k)
            yr = _np_shr2_ins(xr, 3 - b, k)
            take_rc = _np_lex_less(yr, y)
            cy = np.where(take_rc[:, None], yr, y)
            j = _np_searchsorted_words(words, cy)
            hit = j >= 0
            hit &= np.where(hit, counts[np.maximum(j, 0)].astype(np.int64) >= cutoff, False)
            did = j * 2 + take_rc
            outc[ids] += hit
            first = hit & (outc[ids] == 1)
            succ[ids] = np.where(first, did, succ[ids])
    inc = outc.reshape(M, 2)[:, ::-1].reshape(-1)  # in(did) = out(twin)
    s = np.maximum(succ, 0)
    internal = solid2 & (outc == 1) & (succ >= 0) & (inc[s] == 1) & solid2[s]
    nxt = np.where(internal, succ, -1)

    ids2 = np.arange(2 * M)
    prev = np.full(2 * M, -1, np.int64)
    prev[nxt[nxt >= 0]] = ids2[nxt >= 0]

    D = max(1, int(2 * M - 1).bit_length()) + 1
    # cycle detection: does the forward orbit reach a terminal?
    P = np.where(nxt >= 0, nxt, ids2)
    reached = nxt < 0
    for _ in range(D):
        reached |= reached[P]
        P = P[P]
    cyc = ~reached
    if cyc.any():
        m = np.where(cyc, ids2, 2 * M)
        P = np.where(nxt >= 0, nxt, ids2)
        for _ in range(D):
            m = np.minimum(m, m[P])
            P = P[P]
        hv = ids2[cyc & (m == ids2)]
        pv = prev[hv]
        nxt[pv] = -1
        prev[hv] = -1

    # head + rank by pointer doubling on prev
    P = np.where(prev >= 0, prev, ids2)
    R = (prev >= 0).astype(np.int64)
    for _ in range(D):
        R = R + R[P]
        P = P[P]
    head, rank = P, R

    # component min id / min twin id (suffix mins evaluated at the head)
    P = np.where(nxt >= 0, nxt, ids2)
    m = np.where(solid2, ids2, 2 * M)
    tm = np.where(solid2, ids2 ^ 1, 2 * M)
    for _ in range(D):
        m = np.minimum(m, m[P])
        tm = np.minimum(tm, tm[P])
        P = P[P]
    keep_head = solid2 & (prev < 0) & (m <= tm)
    kept = solid2 & keep_head[head]
    return F, nxt, head, rank, kept, keep_head


def _native_chains(words: np.ndarray, counts: np.ndarray, cutoff: int,
                   k: int, nthreads: int = 0):
    """_np_chains via the native O(n) builder (leon_unitig_chains):
    serial chain walking + prefix-bucketed successor search instead of
    structured-dtype searchsorted + pointer-doubling gathers (~18 s per
    1M rows in numpy — the chr-scale 36M-row build must finish under the
    encode stage it overlaps). Bit-identical to _np_chains (tested).
    Returns None when the native lib is unavailable."""
    from leon_tpu import native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "leon_unitig_chains"):
        return None
    M, W = words.shape
    words_c = np.ascontiguousarray(words, dtype=np.uint32)
    counts_c = np.ascontiguousarray(counts, dtype=np.int32)
    rc = np.empty((M, W), np.uint32)
    nxt = np.empty(2 * M, np.int64)
    head = np.empty(2 * M, np.int64)
    rank = np.empty(2 * M, np.int64)
    kept = np.empty(2 * M, np.uint8)
    keep_head = np.empty(2 * M, np.uint8)
    rcode = lib.leon_unitig_chains(
        M, W, words_c.ctypes.data, counts_c.ctypes.data, int(cutoff), k,
        rc.ctypes.data, nxt.ctypes.data, head.ctypes.data, rank.ctypes.data,
        kept.ctypes.data, keep_head.ctypes.data, int(nthreads),
    )
    if rcode != 0:
        return None
    F = np.stack([words_c, rc], axis=1).reshape(2 * M, W)
    return F, nxt, head, rank, kept.astype(bool), keep_head.astype(bool)


def _native_build_payload(words: np.ndarray, counts: np.ndarray, cutoff: int,
                          k: int, nu: int, nthreads: int = 0):
    """One-call native build (leon_unitig_build): parallel chain
    resolution + direct base emission, skipping the head/rank/kept
    scatter arrays and the numpy bases scatter entirely (those phases
    were ~2/3 of the host-thread build at bench scale, and they run
    under the encode loop's GIL). Returns (payload_or_None,) when the
    native path ran — payload None means the frozen chains_cap rule says
    BLOOM — or None when the native lib is unavailable (caller falls
    through to the two-phase path). Bit-identical to build_np_payload's
    numpy assembly (tested)."""
    import ctypes

    from leon_tpu import native
    from leon_tpu.ops.kmer import pack_2bit_np, words_to_codes_batch_np

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "leon_unitig_build"):
        return None
    M, W = words.shape
    words_c = np.ascontiguousarray(words, dtype=np.uint32)
    counts_c = np.ascontiguousarray(counts, dtype=np.int32)
    rc = np.empty((M, W), np.uint32)
    len_nodes = np.empty(M, np.int64)
    head_ids = np.empty(M, np.int64)
    interior = np.empty(M, np.uint8)
    n_chains = lib.leon_unitig_build(
        M, W, words_c.ctypes.data, counts_c.ctypes.data, int(cutoff), k,
        rc.ctypes.data, len_nodes.ctypes.data, head_ids.ctypes.data,
        interior.ctypes.data, int(nthreads),
    )
    if n_chains < 0:
        return None
    if n_chains == 0 or n_chains > chains_cap(nu) * RETRY_FACTOR:
        return (None,)
    heads = head_ids[:n_chains]
    ln = len_nodes[:n_chains]
    bases_per = ln + (k - 1)
    start = np.concatenate([[0], np.cumsum(bases_per)[:-1]])
    total = int(bases_per.sum())
    bases = np.zeros(total, np.uint8)
    # temporaries must stay referenced across the call (.ctypes.data is a
    # bare address — a freed temporary dangles)
    dst_starts = np.ascontiguousarray(start + (k - 1))
    src_starts = np.ascontiguousarray(np.concatenate([[0], np.cumsum(ln)[:-1]]))
    ln_c = np.ascontiguousarray(ln)
    lib.leon_ragged_move(
        bases.ctypes.data, dst_starts.ctypes.data,
        interior.ctypes.data, src_starts.ctypes.data,
        ln_c.ctypes.data, n_chains,
    )
    hi = (heads >> 1).astype(np.int64)
    hrows = np.where((heads & 1).astype(bool)[:, None], rc[hi], words_c[hi])
    codes = words_to_codes_batch_np(hrows, k)
    for j in range(k - 1):
        bases[start + j] = codes[:, j]
    return (payload_from(n_chains, ln, pack_2bit_np(bases), total, k),)


def build_np_payload(words: np.ndarray, counts: np.ndarray, cutoff: int,
                     k: int, nu: int | None = None,
                     nthreads: int = 0) -> bytes | None:
    """Numpy unitig build. words: (M, W) u32 LSW-first distinct canonical
    k-mers sorted ascending (pad rows, if any, must sort last with count
    0). Returns the raw (unframed) payload, or None when the chain count
    exceeds the frozen capacity rule (caller falls back to BLOOM)."""
    from leon_tpu.ops.kmer import pack_2bit_np, words_to_codes_batch_np

    M = words.shape[0]
    if nu is None:
        nu = M
    if M == 0:
        return None
    fast = _native_build_payload(words, counts, cutoff, k, nu, nthreads)
    if fast is not None:
        return fast[0]
    nat = _native_chains(words, counts, cutoff, k, nthreads)
    if nat is not None:
        F, nxt, head, rank, kept, keep_head = nat
    else:
        F, nxt, head, rank, kept, keep_head = _np_chains(words, counts, cutoff, k)
    ids2 = np.arange(2 * M)
    heads = ids2[keep_head]
    n_chains = heads.size
    if n_chains == 0 or n_chains > chains_cap(nu) * RETRY_FACTOR:
        return None
    cid_of = np.full(2 * M, -1, np.int64)
    cid_of[heads] = np.arange(n_chains)
    cid = cid_of[head]

    tails = kept & (nxt < 0)
    len_nodes = np.zeros(n_chains, np.int64)
    len_nodes[cid[tails]] = rank[tails] + 1
    bases_per = len_nodes + (k - 1)
    start = np.concatenate([[0], np.cumsum(bases_per)[:-1]])
    total = int(bases_per.sum())
    bases = np.zeros(total, np.uint8)

    ku = ids2[kept]
    bases[start[cid[ku]] + (k - 1) + rank[ku]] = F[ku, 0] & 3
    codes = words_to_codes_batch_np(F[heads], k)  # (n_chains, k)
    for j in range(k - 1):
        bases[start + j] = codes[:, j]
    return payload_from(n_chains, len_nodes, pack_2bit_np(bases), total, k)


# ---------------------------------------------------------------------------
# device implementation (one launch, one small D2H)
# ---------------------------------------------------------------------------


_TBITS = 16  # prefix-table width: 2^16 buckets


def _topbits(rows, k: int):
    """Top min(_TBITS, 2k) bits of each row's 2k-bit big-int value. Pads
    (0xFFFFFFFF everywhere) map to the max bucket — consistent with their
    sort-last position."""
    import jax.numpy as jnp

    W = rows.shape[1]
    T = min(_TBITS, 2 * k)
    shift = 2 * k - T
    wi, off = shift // 32, shift % 32
    tb = rows[:, wi] >> jnp.uint32(off)
    if off and wi + 1 < W:
        tb = tb | (rows[:, wi + 1] << jnp.uint32(32 - off))
    return (tb & jnp.uint32((1 << T) - 1)).astype(jnp.int32)


def _bucket_starts(hay, k: int):
    """(2^T + 1,) i32 exclusive bucket offsets into the sorted hay."""
    import jax.numpy as jnp

    T = min(_TBITS, 2 * k)
    hist = jnp.zeros((1 << T) + 1, jnp.int32)
    hist = hist.at[_topbits(hay, k) + 1].add(1)
    return jnp.cumsum(hist)


def _searchsorted_words_dev(hay, needles, iters: int, starts=None, k: int = 0):
    """Device binary search: hay (M, W) sorted ascending (big-int order,
    pads 0xFFFFFFFF sort last), needles (N, W) -> (N,) i32 index or -1.

    With `starts` (prefix-bucket table from _bucket_starts) the search
    range narrows to one bucket first, and the remaining rounds run in a
    while_loop that exits when every lane converges — log2(max bucket)
    rounds (~6-8) instead of log2(M) (~22). Identical results by
    construction: an exact match always lies inside its own bucket, and
    the round cap `iters` still bounds degenerate (single-bucket) data."""
    import jax.numpy as jnp
    from jax import lax

    from leon_tpu.ops.kmer import lex_less

    M = hay.shape[0]
    N = needles.shape[0]
    if starts is None:
        lo = jnp.zeros(N, jnp.int32)
        hi = jnp.full(N, M, jnp.int32)
    else:
        p = _topbits(needles, k)
        lo = starts[p]
        hi = starts[p + 1]

    def cond(st):
        r, lo, hi = st
        return jnp.any(lo < hi) & (r < iters)

    def body(st):
        r, lo, hi = st
        act = lo < hi
        mid = (lo + hi) >> 1
        less = lex_less(hay[jnp.minimum(mid, M - 1)], needles)
        lo = jnp.where(act & less, mid + 1, lo)
        hi = jnp.where(act & ~less, mid, hi)
        return (r + 1, lo, hi)

    _, lo, _ = lax.while_loop(cond, body, (jnp.int32(0), lo, hi))
    loc = jnp.minimum(lo, M - 1)
    found = jnp.all(hay[loc] == needles, axis=-1) & (lo < M)
    return jnp.where(found, loc, -1)


def _build_dev_impl(words, counts, cutoff, k: int, cap_chains: int, cap_bases: int,
                    assume_acyclic: bool = True):
    """Device unitig build over the padded sorted distinct run. Returns a
    single u32 buffer: [n_chains, overflow, has_cycles, 0 | len_nodes
    (cap_chains) | packed bases (cap_bases/16)]. Semantics mirror the
    numpy reference exactly (same ids, tie-breaks, emission order).
    assume_acyclic=True runs the fast single-doubling variant that only
    DETECTS cycles (hdr[2]); drain_build re-dispatches with
    assume_acyclic=False on the rare cycle-bearing input."""
    import jax.numpy as jnp

    from leon_tpu.ops.kmer import lex_less, revcomp_words_batch_np, shl2, shr2_ins, top_mask

    M, W = words.shape
    iters = max(1, int(M).bit_length())
    solid = counts.astype(jnp.int32) >= cutoff

    # rc via per-word ops (device): unpack/pack would cost (M, k) u8; use
    # the complement+bit-reverse identity instead: rc = reverse_2bit(~x)
    comp = tuple(~words[:, j] for j in range(W))
    # reverse the 2k-bit string of 2-bit groups: reverse groups within each
    # u32 (mask-shuffle), reverse word order, then shift right by the pad
    def rev2_u32(x):
        x = ((x & jnp.uint32(0x33333333)) << 2) | ((x >> 2) & jnp.uint32(0x33333333))
        x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x >> 4) & jnp.uint32(0x0F0F0F0F))
        x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x >> 8) & jnp.uint32(0x00FF00FF))
        return (x << 16) | (x >> 16)

    revw = [rev2_u32(comp[W - 1 - j]) for j in range(W)]
    pad_bits = 32 * W - 2 * k
    if pad_bits:
        shifted = []
        for j in range(W):
            lo_part = revw[j] >> pad_bits
            hi_part = revw[j + 1] << (32 - pad_bits) if j + 1 < W else jnp.zeros_like(revw[j])
            shifted.append(lo_part | hi_part)
        revw = shifted
    rc = jnp.stack(revw, axis=-1)
    rc = rc.at[..., W - 1].set(rc[..., W - 1] & jnp.uint32(top_mask(k)))

    # the interleaved (2M, W) directed-node matrix F is NEVER materialized
    # (it would be the build's largest buffer and its row gathers its
    # hottest): even directed rows are `words`, odd are `rc`, addressed
    # directly below — HBM working set drops ~40%, enabling the 128M
    # solid-count gate (config.unitig_max_kmers)
    solid2 = jnp.repeat(solid, 2)
    ids2 = jnp.arange(2 * M, dtype=jnp.int32)

    starts = _bucket_starts(words, k)
    succ = jnp.full(2 * M, -1, jnp.int32)
    outc = jnp.zeros(2 * M, jnp.int32)
    # the base axis rides a fori_loop (traced b) instead of unrolling:
    # 8 unrolled search chains made the program large enough that the
    # compile time and program size grow with the row count; 2 rolled
    # chains compile at any size (shl2/shr2_ins/search are shape-stable
    # in b)
    from jax import lax as _lax

    for o in (0, 1):
        ids = jnp.arange(M, dtype=jnp.int32) * 2 + o
        x = words if o == 0 else rc
        xr = rc if o == 0 else words

        def succ_body(b, st, ids=ids, x=x, xr=xr):
            succ, outc = st
            bu = b.astype(jnp.uint32)
            y = shl2(x, bu, k)
            yr = shr2_ins(xr, jnp.uint32(3) - bu, k)
            take_rc = lex_less(yr, y)
            cy = jnp.where(take_rc[:, None], yr, y)
            j = _searchsorted_words_dev(words, cy, iters, starts=starts, k=k)
            hit = j >= 0
            hit &= jnp.where(hit, counts[jnp.maximum(j, 0)].astype(jnp.int32) >= cutoff, False)
            did = j * 2 + take_rc.astype(jnp.int32)
            oc = outc[ids] + hit
            outc = outc.at[ids].set(oc)
            first = hit & (oc == 1)
            succ = succ.at[ids].set(jnp.where(first, did, succ[ids]))
            return (succ, outc)

        succ, outc = _lax.fori_loop(0, 4, lambda b, st: succ_body(b, st),
                                    (succ, outc))
    inc = outc.reshape(M, 2)[:, ::-1].reshape(-1)
    s = jnp.maximum(succ, 0)
    internal = solid2 & (outc == 1) & (succ >= 0) & (inc[s] == 1) & solid2[s]
    nxt = jnp.where(internal, succ, -1)

    prev = jnp.full(2 * M, -1, jnp.int32)
    prev = prev.at[jnp.where(nxt >= 0, nxt, 2 * M)].set(ids2, mode="drop")

    D = max(1, int(2 * M - 1).bit_length()) + 1

    def _double(P0, carry_cols, fold):
        """Pointer doubling with device-side early exit (round cap D).
        Equivalent to D fixed rounds: chains converge in log2(longest
        chain) rounds — typically far under D — and rounds past the
        pointer fixpoint are no-ops. Cycles whose length has an odd
        factor never converge and rely on the D-round cap; a cycle of
        length dividing 2^t converges to the identity at round t, but
        only after the carry already covers the whole cycle, so the
        early exit is safe in every case.

        The pointer and every carry ride as COLUMNS of one (2M, 1+C) i32
        matrix, so each round costs a single row-gather instead of one
        gather per column.
        fold(cols, gcols) gets the current carries and their orbit
        gathers (gcols[i] = cols[i][P]) and returns the new carries."""
        from jax import lax

        C = len(carry_cols)
        Cm0 = jnp.stack([P0, *[c.astype(jnp.int32) for c in carry_cols]], axis=1)

        def cond(st):
            r, changed, _C = st
            return changed & (r < D)

        def body(st):
            r, _, Cm = st
            P = Cm[:, 0]
            G = Cm[P]  # one row-gather: P[P] and every carry[P]
            new = fold([Cm[:, j + 1] for j in range(C)],
                       [G[:, j + 1] for j in range(C)])
            P2 = G[:, 0]
            return (r + 1, jnp.any(P2 != P), jnp.stack([P2, *new], axis=1))

        st = (jnp.int32(0), jnp.asarray(True), Cm0)
        _, _, Cm = lax.while_loop(cond, body, st)
        return Cm[:, 0], tuple(Cm[:, j + 1] for j in range(C))

    cyc_flag = jnp.uint32(0)
    if assume_acyclic:
        # OPTIMISTIC fast path (the common case: real corpora have no
        # circular unitigs): skip the cycle-detection doubling entirely
        # and carry a reached-terminal bit through the rank doubling
        # instead. A node whose prev-orbit never reaches a head is on a
        # cycle; the build is then invalid and hdr[2] tells drain_build
        # to re-dispatch the full variant. Cuts the doubling passes from
        # three to one plus two scatter-mins (~2.5x on the build).
        head, (rank, reached_i) = _double(
            jnp.where(prev >= 0, prev, ids2),
            ((prev >= 0).astype(jnp.int32), (prev < 0).astype(jnp.int32)),
            lambda c, g: (c[0] + g[0], c[1] | g[1]),
        )
        cyc_flag = jnp.any((reached_i == 0) & solid2).astype(jnp.uint32)
    else:
        # FULL variant: terminal reachability (cycle detection) + min id
        # over the forward orbit; cycles break at their min-id node
        P0 = jnp.where(nxt >= 0, nxt, ids2)
        _, (reached_i, m) = _double(
            P0, ((nxt < 0).astype(jnp.int32), ids2),
            lambda c, g: (c[0] | g[0], jnp.minimum(c[1], g[1])),
        )
        reached = reached_i.astype(bool)
        cyc = ~reached
        ch = cyc & (m == ids2)  # cycle heads
        pv = jnp.where(ch, prev, -1)
        nxt = nxt.at[jnp.where(ch, jnp.maximum(pv, 0), 2 * M)].set(-1, mode="drop")
        prev = prev.at[jnp.where(ch, ids2, 2 * M)].set(-1, mode="drop")

        head, (rank,) = _double(
            jnp.where(prev >= 0, prev, ids2),
            ((prev >= 0).astype(jnp.int32),),
            lambda c, g: (c[0] + g[0],),
        )

    # per-chain min id / min twin id are consumed only at HEAD rows, and
    # every chain member knows its head — two scatter-mins over `head`
    # replace the old third doubling pass (identical values at heads:
    # a head's forward orbit IS its chain)
    big = jnp.int32(2 * M)
    idx_h = jnp.where(solid2, head, 2 * M)
    cm = jnp.full(2 * M + 1, big, jnp.int32).at[idx_h].min(
        jnp.where(solid2, ids2, big))[:2 * M]
    tmn = jnp.full(2 * M + 1, big, jnp.int32).at[idx_h].min(
        jnp.where(solid2, ids2 ^ 1, big))[:2 * M]
    keep_head = solid2 & (prev < 0) & (cm <= tmn)
    kept = solid2 & keep_head[head]

    n_chains = jnp.cumsum(keep_head.astype(jnp.int32))
    cid_of = jnp.where(keep_head, n_chains - 1, -1)
    total_chains = n_chains[-1] if M else jnp.int32(0)
    overflow = (total_chains > cap_chains).astype(jnp.uint32)
    cid = cid_of[head]

    tails = kept & (nxt < 0)
    len_nodes = jnp.zeros(cap_chains, jnp.int32)
    len_nodes = len_nodes.at[jnp.where(tails, cid, cap_chains)].set(rank + 1, mode="drop")
    bases_per = len_nodes + jnp.where(len_nodes > 0, k - 1, 0)
    start = jnp.cumsum(bases_per) - bases_per

    bases = jnp.zeros(cap_bases, jnp.uint8)
    pos = jnp.where(kept, start[jnp.maximum(cid, 0)] + (k - 1) + rank, cap_bases)
    # last-base scatter, split by directed-node parity (F is virtual:
    # even rows = words, odd rows = rc)
    bases = bases.at[pos[0::2]].set((words[:, 0] & 3).astype(jnp.uint8), mode="drop")
    bases = bases.at[pos[1::2]].set((rc[:, 0] & 3).astype(jnp.uint8), mode="drop")
    # the (k-1)-base head prefixes: compact the kept heads into
    # cap_chains lanes FIRST, so the k-1 scatter rounds run over the
    # chain count, not 2M directed nodes (was ~20% of the build)
    hids = jnp.full(cap_chains, 2 * M, jnp.int32)
    hids = hids.at[jnp.where(keep_head, cid, cap_chains)].set(ids2, mode="drop")
    live = hids < 2 * M
    hrow = jnp.minimum(hids >> 1, M - 1)
    Fh_w = words[hrow]
    Fh_r = rc[hrow]
    Fh = jnp.where((hids & 1)[:, None].astype(bool), Fh_r, Fh_w)  # (cap_chains, W)
    hstart_c = jnp.where(live, start[jnp.arange(cap_chains)], cap_bases)

    def prefix_body(j, bases):
        # rolled (traced j) for compile-size reasons — see succ loop note
        t = 2 * (k - 1) - 2 * j
        col = jnp.take(Fh, t // 32, axis=1)
        bj = ((col >> (t % 32).astype(jnp.uint32)) & 3).astype(jnp.uint8)
        return bases.at[jnp.where(live, hstart_c + j, cap_bases)].set(bj, mode="drop")

    bases = _lax.fori_loop(0, k - 1, prefix_body, bases)

    # pack 2-bit, 16 codes/u32, code t at bits 2t (pack_codes_np layout)
    grp = bases.reshape(-1, 16).astype(jnp.uint32)
    shifts = jnp.uint32(2) * jnp.arange(16, dtype=jnp.uint32)
    packed = (grp << shifts[None, :]).sum(axis=1, dtype=jnp.uint32)

    hdr = jnp.stack([total_chains.astype(jnp.uint32), overflow,
                     cyc_flag, jnp.uint32(0)])
    return jnp.concatenate([hdr, len_nodes.astype(jnp.uint32), packed])


_BUILD_JIT = None


def _build_dev(*args, **kw):
    global _BUILD_JIT
    if _BUILD_JIT is None:
        import jax

        _BUILD_JIT = jax.jit(
            _build_dev_impl,
            static_argnames=("k", "cap_chains", "cap_bases", "assume_acyclic"),
        )
    return _BUILD_JIT(*args, **kw)


def _compact_impl(words, counts, cutoff, cap: int):
    """Stable device compaction of the distinct run to its solid rows
    (pads: words 0xFFFFFFFF — sort-last — counts 0). Sorted order is
    preserved, so every id comparison in the chain build is
    order-isomorphic to the full-array build: the payload is byte-
    identical, the graph just skips the (often 5-10x more numerous)
    sub-cutoff rows."""
    import jax.numpy as jnp

    solid = counts.astype(jnp.int32) >= cutoff
    csum = jnp.cumsum(solid.astype(jnp.int32))
    pos = jnp.where(solid, csum - 1, cap)
    W = words.shape[1]
    out_w = jnp.full((cap, W), jnp.uint32(0xFFFFFFFF))
    out_w = out_w.at[pos].set(words, mode="drop")
    out_c = jnp.zeros(cap, jnp.int32).at[pos].set(counts.astype(jnp.int32), mode="drop")
    # defensive guard (see dispatch_build): if the true solid count
    # exceeds cap the scatter dropped rows — zero the counts so the
    # build yields 0 chains and the caller falls back to BLOOM instead
    # of writing a corrupt payload
    ok = csum[-1] <= cap
    return out_w, jnp.where(ok, out_c, 0)


_COMPACT_JIT = None


def _compact_dev(*args, **kw):
    global _COMPACT_JIT
    if _COMPACT_JIT is None:
        import jax

        _COMPACT_JIT = jax.jit(_compact_impl, static_argnames=("cap",))
    return _COMPACT_JIT(*args, **kw)


@dataclass
class _Inflight:
    buf: object
    words: object
    counts: object
    cutoff: int
    k: int
    nu: int
    cap_chains: int
    cap_bases: int


def _caps(Mcap: int, nu: int, k: int, cap_chains: int) -> int:
    # kept directed nodes <= 2x the solid count (self-RC components spell
    # both twins), and solid <= Mcap — 2*Mcap covers every case
    cap_bases = 2 * Mcap + (k - 1) * cap_chains
    return -(-cap_bases // 16) * 16


def dispatch_build(words, counts, cutoff: int, k: int, nu: int,
                   n_solid: int | None = None) -> _Inflight:
    """Dispatch the device unitig build (async D2H started). `words` is
    the (Mcap, W) padded sorted distinct run, `counts` its i32 counts
    (pads 0), `nu` the exact distinct count. When the caller knows
    `n_solid`, the run is first compacted to its solid rows — the graph
    build's gather traffic scales with the array size, and the distinct
    set is typically 5-10x larger than the solid set.

    INVARIANT: `n_solid` must be >= the true number of rows with
    count >= cutoff (today's callers pass the exact count: the clamped
    count histogram is exact for cutoff <= 255 and overcounts above,
    which is safe). An undercount would make the compaction scatter's
    mode="drop" silently discard solid k-mers — a payload that no longer
    spells the Bloom's k-mer set, i.e. corruption on decompress.
    _compact_impl guards this on device: on overflow it zeroes the
    counts, the build then emits 0 chains and drain_build returns None,
    so the pipeline falls back to the (always-correct) BLOOM section."""
    if n_solid is not None and n_solid > 0:
        cap_m = _bucket(max(1, int(n_solid)))
        if cap_m < int(words.shape[0]):
            words, counts = _compact_dev(words, counts, np.int32(cutoff), cap_m)
    Mcap = int(words.shape[0])
    cap = chains_cap(nu)
    buf = _build_dev(words, counts, np.int32(cutoff), k, cap, _caps(Mcap, nu, k, cap))
    buf.copy_to_host_async()
    return _Inflight(buf, words, counts, int(cutoff), k, nu, cap,
                     _caps(Mcap, nu, k, cap))


def drain_build(infl: _Inflight) -> bytes | None:
    """Drain the dispatched build; cycle-bearing inputs re-dispatch the
    full (cycle-breaking) variant; one capacity retry at cap*RETRY_FACTOR;
    returns the raw payload or None (caller writes BLOOM)."""
    buf = np.asarray(infl.buf)
    acyclic = True
    if buf[2]:  # cycles detected: the optimistic build is invalid
        acyclic = False
        buf = np.asarray(_build_dev(infl.words, infl.counts,
                                    np.int32(infl.cutoff), infl.k,
                                    infl.cap_chains, infl.cap_bases,
                                    assume_acyclic=False))
    n_chains = int(buf[0])
    if buf[1]:  # overflow: retry once with a larger cap
        cap = infl.cap_chains * RETRY_FACTOR
        Mcap = int(infl.words.shape[0])
        cb = _caps(Mcap, infl.nu, infl.k, cap)
        buf = np.asarray(_build_dev(infl.words, infl.counts,
                                    np.int32(infl.cutoff), infl.k, cap, cb,
                                    assume_acyclic=acyclic))
        n_chains = int(buf[0])
        if buf[2]:
            buf = np.asarray(_build_dev(infl.words, infl.counts,
                                        np.int32(infl.cutoff), infl.k, cap,
                                        cb, assume_acyclic=False))
            n_chains = int(buf[0])
        if buf[1]:
            return None
        infl.cap_chains, infl.cap_bases = cap, cb
    if n_chains == 0:
        return None
    len_nodes = buf[4 : 4 + infl.cap_chains][:n_chains].astype(np.int64)
    total = int(len_nodes.sum()) + (infl.k - 1) * n_chains
    packed = buf[4 + infl.cap_chains :].tobytes()
    return payload_from(n_chains, len_nodes, packed, total, infl.k)


# ---------------------------------------------------------------------------
# payload codec + bitset rebuild
# ---------------------------------------------------------------------------


def payload_from(n_chains: int, len_nodes: np.ndarray, packed: bytes,
                 total_bases: int, k: int) -> bytes:
    """Raw UNITIGS payload: varint n_chains | varint len(lens_blob) |
    lens_blob (varint base-length per chain) | 2-bit packed concatenated
    bases (pack_2bit_np bit order)."""
    out = bytearray()
    varint.encode_one(n_chains, out)
    lens_b = (np.asarray(len_nodes, np.int64) + (k - 1)).astype(np.uint64)
    blob = varint.encode_array(lens_b)
    varint.encode_one(len(blob), out)
    out += blob
    out += packed[: (total_bases + 3) // 4]
    return bytes(out)


def parse_payload(raw: bytes, k: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (base lengths (n_chains,) i64, flat base codes (total,) u8)."""
    from leon_tpu.ops.kmer import unpack_2bit_np

    n_chains, pos = varint.decode_one(raw, 0)
    blob_len, pos = varint.decode_one(raw, pos)
    lens = varint.decode_array(raw[pos : pos + blob_len], n_chains).astype(np.int64)
    pos += blob_len
    total = int(lens.sum())
    codes = unpack_2bit_np(raw[pos:], total)
    return lens, codes


def rebuild_bitset_np(raw: bytes, k: int, n_words: int, n_hashes: int,
                      seed: int, canon: np.ndarray | None = None) -> np.ndarray:
    """Rebuild the encoder's exact Bloom bitset from the unitig payload:
    extract every k-mer of every unitig, canonicalize, scatter-OR with the
    container's frozen hash family. Bit-identical to the encoder's filter
    by construction (same kmer set, same n_words/H/seed). `canon`
    short-circuits the spelling when the caller already ran spell_canon
    (the v5 decoder shares it with the DICT enumeration)."""
    from leon_tpu.ops import bloom
    from leon_tpu.ops.kmer import pack_codes_batch_np

    bitset = np.zeros(n_words, np.uint32)
    if canon is not None:
        step = max(1, (256 << 20) // (4 * max(1, canon.shape[1])))
        for s in range(0, canon.shape[0], step):
            bitset |= bloom.build_np(canon[s : s + step], n_words, n_hashes, seed, k)
        return bitset
    lens, codes = parse_payload(raw, k)
    if codes.size == 0:
        return bitset
    starts = np.cumsum(lens) - lens
    nk = lens - k + 1
    pos = np.repeat(starts, nk) + (
        np.arange(int(nk.sum())) - np.repeat(np.cumsum(nk) - nk, nk)
    )
    # chunked so the (chunk, k) window matrix stays ~256 MB even at the
    # 64M-kmer section cap
    step = max(1, (256 << 20) // (4 * k))
    off = np.arange(k)[None, :]
    for s in range(0, pos.size, step):
        win = codes[pos[s : s + step, None] + off]  # (chunk, k)
        fwd = pack_codes_batch_np(win, k)
        rcw = pack_codes_batch_np((3 - win)[:, ::-1], k)
        take = _np_lex_less(rcw, fwd)
        canon_c = np.where(take[:, None], rcw, fwd)
        bitset |= bloom.build_np(canon_c, n_words, n_hashes, seed, k)
    return bitset


def spell_canon(raw: bytes, k: int) -> np.ndarray:
    """(n_solid, W) u32: every canonical k-mer spelled by the unitig
    payload, in payload traversal order. Native rolling-window spell when
    the lib is available (O(n) vs the numpy chunked form's O(n*k));
    numpy fallback is bit-identical (tested)."""
    from leon_tpu.ops.kmer import pack_codes_batch_np, words_for_k

    lens, codes = parse_payload(raw, k)
    if codes.size == 0:
        return np.zeros((0, max(1, (k + 15) // 16)), np.uint32)

    from leon_tpu import native

    lib = native.get_lib()
    if lib is not None and hasattr(lib, "leon_spell_canon"):
        W = words_for_k(k)
        nk_total = int(np.maximum(lens - k + 1, 0).sum())
        out = np.empty((nk_total, W), dtype=np.uint32)
        codes_c = np.ascontiguousarray(codes, dtype=np.uint8)
        lens_c = np.ascontiguousarray(lens, dtype=np.int64)
        m = lib.leon_spell_canon(codes_c.ctypes.data, lens_c.shape[0],
                                 lens_c.ctypes.data, k, W, out.ctypes.data)
        if m == nk_total:
            return np.ascontiguousarray(out.astype("<u4"))
        # count mismatch (unitigs shorter than k shouldn't exist in a
        # valid payload): fall through to the numpy reference
    starts = np.cumsum(lens) - lens
    nk = lens - k + 1
    pos = np.repeat(starts, nk) + (
        np.arange(int(nk.sum())) - np.repeat(np.cumsum(nk) - nk, nk)
    )
    step = max(1, (256 << 20) // (4 * k))
    off = np.arange(k)[None, :]
    chunks = []
    for s in range(0, pos.size, step):
        win = codes[pos[s : s + step, None] + off]
        fwd = pack_codes_batch_np(win, k)
        rcw = pack_codes_batch_np((3 - win)[:, ::-1], k)
        take = _np_lex_less(rcw, fwd)
        chunks.append(np.where(take[:, None], rcw, fwd))
    return np.ascontiguousarray(np.concatenate(chunks).astype("<u4"))


def sort_rows_bigint(allc: np.ndarray) -> np.ndarray:
    """Sort (n, W) u32 LSW-first rows ascending as big-ints. W<=2 packs
    into u64 keys (np's u64 argsort is ~8x faster than the structured
    comparator); wider rows use the MSW-first structured view."""
    W = allc.shape[1]
    if W == 1:
        return allc[np.argsort(allc[:, 0], kind="stable")]
    if W == 2:
        v = allc[:, 0].astype(np.uint64) | (allc[:, 1].astype(np.uint64) << 32)
        return allc[np.argsort(v, kind="stable")]
    key = np.ascontiguousarray(allc[:, ::-1]).view(
        [("", "<u4")] * W
    ).reshape(-1)
    return allc[np.argsort(key, kind="stable")]


def solid_kmers_sorted(raw: bytes, k: int, canon: np.ndarray | None = None) -> np.ndarray:
    """(n_solid, W) u32 DISTINCT canonical solid k-mers, ascending big-int
    order, spelled from the unitig payload. This is the DICT-v2
    enumeration (FORMAT.md §5): encoder and decoder both derive it from
    the SAME payload bytes with this same function, so anchor indices
    into it are deterministic by construction. DEDUPED: a self-twin
    chain (a unitig adjacent to its own reverse complement) legitimately
    spells its k-mers twice in the payload, but the enumeration must
    match the distinct solid run the encoder indexes against
    (solid_run_host / solid_indices_dev). `canon` short-circuits the
    spelling when the caller already has spell_canon's output (the
    decoder shares it with the bitset rebuild)."""
    if canon is None:
        canon = spell_canon(raw, k)
    s = sort_rows_bigint(canon)
    if s.shape[0] > 1:
        keep = np.concatenate(([True], (s[1:] != s[:-1]).any(axis=1)))
        s = np.ascontiguousarray(s[keep])
    return s


def solid_indices_dev(infl: "_Inflight", keys: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """DICT-v2 enumeration lookup ON DEVICE: for (Q, W) u32 query keys,
    returns (hit bool (Q,), solid-rank i64 (Q,), n_solid). Searches the
    in-flight build's run directly — uploads Q keys (~1 MB) instead of
    pulling the whole solid run to host (~25 MB D2H). Ranks count only rows with count >= cutoff, so they equal
    indices into solid_kmers_sorted(payload) exactly."""
    import jax
    import jax.numpy as jnp

    words, counts = infl.words, infl.counts
    M = int(words.shape[0])
    iters = max(1, M.bit_length())

    @jax.jit
    def _lookup(words, counts, q):
        solid = counts.astype(jnp.int32) >= jnp.int32(infl.cutoff)
        starts = _bucket_starts(words, infl.k)
        j = _searchsorted_words_dev(words, q, iters, starts=starts, k=infl.k)
        jc = jnp.maximum(j, 0)
        hit = (j >= 0) & solid[jc]
        rank = jnp.cumsum(solid.astype(jnp.int32))[jc] - 1
        return hit, jnp.where(hit, rank, 0), jnp.sum(solid, dtype=jnp.int32)

    hit, rank, ns = _lookup(words, counts, jnp.asarray(keys.astype("<u4")))
    return np.asarray(hit), np.asarray(rank).astype(np.int64), int(ns)


def solid_run_host(infl: "_Inflight") -> np.ndarray:
    """Encoder-side DICT-v2 enumeration without re-spelling: the in-flight
    build's (compacted) sorted distinct run filtered to its solid rows IS
    the ascending solid set — identical to solid_kmers_sorted(payload, k)
    because the payload spells exactly that set (the frozen §4a contract,
    and the decoder's from_payload_v5 cross-checks the size)."""
    words = np.asarray(infl.words)
    counts = np.asarray(infl.counts)
    return np.ascontiguousarray(words[counts >= infl.cutoff])
