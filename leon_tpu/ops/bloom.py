"""Bloom filter over canonical solid k-mers — the probabilistic de Bruijn
graph (reference behavior: /root/reference/README.md:13 "inserts solid kmers
in a bloom-filter"; [R] gatb-core tools/collections/impl/Bloom.hpp).

The bitset is a flat uint32 array resident in device memory; membership is
ONE gathered word load + mask test, batched over lanes. Hash family v4
(FORMAT.md §4) is an ntHash-style 32-bit ROLLING family: during the graph
walk each of the 4 successor candidates costs a couple of XOR/rotates
instead of a full multiword re-hash, and strand-invariance comes from the
unordered (min, max) pair of the forward/reverse chain values — no
canonical big-int compare on the hot path. v4 carries a SINGLE rolling
chain per strand (v2/v3 carried two independent families): the two hash
coordinates the blocked addressing needs (word index, bit positions) come
from min(f, r) and max(f, r), which jointly preserve the full 64 bits of
the strand pair — half the per-step hash updates of the fused-walk scan
body. Decoder determinism depends
on the numpy and jnp paths being bit-identical; both are implemented here
from the same table constants.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# FORMAT.md §4 frozen constants
_C1 = 0x5BF03635
_C2 = 0x334F1361
_PHI = 0x9E3779B9
_M32 = 0xFFFFFFFF


def _fmix32_int(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    x ^= x >> 16
    return x


def _rol_int(x: int, r: int) -> int:
    r %= 32
    return ((x << r) | (x >> (32 - r))) & _M32


def tables(seed: int, k: int) -> np.ndarray:
    """Table constants for hash family v4, shape (4, 4) uint32:
    [kind][base] with kind 0=T, 1=Tc, 2=Trot, 3=Tcrot — ONE rolling
    family (see module docstring)."""
    out = np.zeros((4, 4), dtype=np.uint32)
    base = _fmix32_int(seed ^ _C1)
    T = [_fmix32_int((base + b * _PHI) & _M32) for b in range(4)]
    Tc = [T[3 - b] for b in range(4)]
    out[0] = T
    out[1] = Tc
    out[2] = [_rol_int(v, k - 1) for v in T]
    out[3] = [_rol_int(v, k - 1) for v in Tc]
    return out


def rol1(x, xp):
    u = xp.uint32
    return (x << u(1)) | (x >> u(31))


def ror1(x, xp):
    u = xp.uint32
    return (x >> u(1)) | (x << u(31))


def hash_codes(codes, k: int, seed: int, xp):
    """From-scratch (f, r) strand-chain values of the k-mer codes[..., 0:k].

    codes: (..., k) integer base codes. Works for numpy and jnp.
    """
    tab = tables(seed, k)
    shape = codes.shape[:-1]
    u = xp.uint32
    f = xp.zeros(shape, xp.uint32)
    r = xp.zeros(shape, xp.uint32)
    T = xp.asarray(tab[0])
    Tc = xp.asarray(tab[1])
    for i in range(k):
        b = codes[..., i]
        bi = b.astype(xp.int32 if xp is jnp else np.int64)
        rf = (k - 1 - i) % 32
        rr = i % 32
        tv = xp.take(T, bi)
        cv = xp.take(Tc, bi)
        f = f ^ (((tv << u(rf)) | (tv >> u((32 - rf) % 32))) if rf else tv)
        r = r ^ (((cv << u(rr)) | (cv >> u((32 - rr) % 32))) if rr else cv)
    return f, r


def hash_words(words, k: int, seed: int, xp):
    """From-scratch (f, r) of packed k-mer words (..., W) without
    materializing the (..., k) code array: extracts base columns on the fly."""
    tab = tables(seed, k)
    shape = words.shape[:-1]
    u = xp.uint32
    f = xp.zeros(shape, xp.uint32)
    r = xp.zeros(shape, xp.uint32)
    T = xp.asarray(tab[0])
    Tc = xp.asarray(tab[1])
    for i in range(k):
        t = 2 * (k - 1 - i)
        b = (words[..., t // 32] >> u(t % 32)) & u(3)
        bi = b.astype(xp.int32 if xp is jnp else np.int64)
        rf = (k - 1 - i) % 32
        rr = i % 32
        tv = xp.take(T, bi)
        cv = xp.take(Tc, bi)
        f = f ^ (((tv << u(rf)) | (tv >> u((32 - rf) % 32))) if rf else tv)
        r = r ^ (((cv << u(rr)) | (cv >> u((32 - rr) % 32))) if rr else cv)
    return f, r


MAX_WORDS = (1 << 31) - 64  # word index must fit int32 for device gathers


def alloc_words(n_words: int) -> int:
    """Device-allocation size (the STATIC shape) for an exact-size filter:
    next point on a 1/8-octave geometric grid, rounded to a 64-word
    multiple. The exact n_words rides through the jitted kernels as traced
    data (fastrange needs no power of two), so XLA programs depend only on
    the allocation shape — the grid bounds distinct shapes to 8 per octave
    (<=25% HBM overhead, zero archive overhead: the container stores the
    exact n_words prefix) instead of one fresh compile per filter size."""
    n = max(64, int(n_words))
    step = max(64, 1 << ((n - 1).bit_length() - 3))
    a = -(-n // step) * step
    return min(-(-a // 64) * 64, MAX_WORDS)


def _as_u32(n_words, xp):
    """n_words as a u32 scalar: python/numpy ints stay concrete, traced
    values pass through (exact size is DATA, not a static shape)."""
    if isinstance(n_words, (int, np.integer)):
        return xp.uint32(n_words)
    return n_words.astype(xp.uint32)


def mulhi32(a, b, xp):
    """High 32 bits of the u32 x u32 product, in pure u32 arithmetic —
    bit-identical in numpy and jnp (neither needs 64-bit types). This is
    the `fastrange` reduction: mulhi32(h, n) maps a uniform u32 hash to
    [0, n) without division or power-of-two sizes."""
    u = xp.uint32
    M16 = u(0xFFFF)
    al, ah = a & M16, a >> u(16)
    bl, bh = b & M16, b >> u(16)
    ll = al * bl
    hl = ah * bl
    lh = al * bh
    hh = ah * bh
    # (ll>>16) + (hl&M16) + lh <= (2^16-1) + (2^16-1) + (2^16-1)^2 = 2^32-1
    cross = (ll >> u(16)) + (hl & M16) + lh
    return hh + (hl >> u(16)) + (cross >> u(16))


def wordmask_from_hashes(f, r, n_hashes: int, n_words: int, xp):
    """BLOCKED Bloom addressing (hash family v4, FORMAT.md §4): all H bits
    of a key live in ONE u32 bitset word, so membership is a single
    gathered word + mask test. The walk probes 4 candidates x H hashes at
    every step (random device-memory access); blocking cuts the gather
    count H-fold for a modest false-positive penalty (~2-3x at 12
    bits/kmer, still <1.5%).

    Both coordinates derive from the strand-invariant unordered pair
    (lo, hi) = (min(f, r), max(f, r)) of the ONE rolling chain:
    word index: w = mulhi32(lo, n_words) — fastrange on lo's high bits,
    so the filter is sized EXACTLY at bits_per_kmer * n_solid instead of
    the next power of two (stored-Bloom bytes dominate DNA-mode archives;
    power-of-two rounding wasted up to 2x).
    bit positions: bit_i = (hi >> 5i) & 31 for i < 6, then
    ((lo >> 5(i-6)) & 31) for i in [6, 8) — lo's LOW bits, disjoint from
    the high bits fastrange consumes. mask = OR of (1 << bit_i); a key
    sets <= H distinct bits. Bit-identical in numpy and jnp.

    Returns (word_index int32 (...,), mask uint32 (...,)).
    """
    u = xp.uint32
    i32 = xp.int32 if xp is jnp else np.int64
    if isinstance(n_words, (int, np.integer)) and n_words > MAX_WORDS:
        raise ValueError(f"n_words {n_words} > {MAX_WORDS}")
    lo = xp.minimum(f, r)
    hi = xp.maximum(f, r)
    wi = mulhi32(lo, _as_u32(n_words, xp), xp).astype(i32)
    mask = xp.zeros(lo.shape, xp.uint32) if hasattr(lo, "shape") else u(0)
    for i in range(n_hashes):
        b = ((hi >> u(5 * i)) if i < 6 else (lo >> u(5 * (i - 6)))) & u(31)
        mask = mask | (u(1) << b)
    return wi, mask


def wordbit_from_hashes(f, r, n_hashes: int, n_words: int, xp):
    """Per-bit view of the blocked addressing: (word int32 (..., H), bit
    uint32 (..., H)) — the SAME bits wordmask_from_hashes tests, unrolled
    for build paths that deduplicate (word, bit) pairs."""
    u = xp.uint32
    wi, _ = wordmask_from_hashes(f, r, n_hashes, n_words, xp)
    lo = xp.minimum(f, r)
    hi = xp.maximum(f, r)
    bits = []
    for i in range(n_hashes):
        bits.append((((hi >> u(5 * i)) if i < 6 else (lo >> u(5 * (i - 6)))) & u(31)))
    wis = [wi] * n_hashes
    return xp.stack(wis, axis=-1), xp.stack(bits, axis=-1)


def wordbit(words, n_hashes: int, n_words: int, seed: int, xp, k: int):
    """(word_index, bit) of packed k-mer words (..., W)."""
    f, r = hash_words(words, k, seed, xp)
    return wordbit_from_hashes(f, r, n_hashes, n_words, xp)


def wordmask(words, n_hashes: int, n_words: int, seed: int, xp, k: int):
    """(word_index, 32-bit mask) of packed k-mer words (..., W)."""
    f, r = hash_words(words, k, seed, xp)
    return wordmask_from_hashes(f, r, n_hashes, n_words, xp)


def wordbit_classic_from_hashes(f, r, n_hashes: int, n_words: int, xp):
    """CLASSIC (unblocked) addressing: H independent (word, bit) pairs by
    double hashing g_i = h1 + i*h2 with (h1, h2) = (min(f,r), max(f,r)|1),
    word = fastrange(g_i), bit = g_i & 31. Lower false-positive rate than
    the blocked v4 family (no per-word key clustering) at H gathers per
    probe — used by the graph API's FP-sensitive traversals, NOT by the
    container format."""
    u = xp.uint32
    i32 = xp.int32 if xp is jnp else np.int64
    if isinstance(n_words, (int, np.integer)) and n_words > MAX_WORDS:
        raise ValueError(f"n_words {n_words} > {MAX_WORDS}")
    h1 = xp.minimum(f, r)
    h2 = xp.maximum(f, r) | u(1)
    nw = _as_u32(n_words, xp)
    wis, bits = [], []
    for i in range(n_hashes):
        g = h1 + u(i) * h2
        wis.append(mulhi32(g, nw, xp).astype(i32))
        bits.append(g & u(31))
    return xp.stack(wis, axis=-1), xp.stack(bits, axis=-1)


def build_np_classic(solid_words: np.ndarray, n_words: int, n_hashes: int,
                     seed: int, k: int) -> np.ndarray:
    bitset = np.zeros(n_words, dtype=np.uint32)
    if solid_words.shape[0]:
        f, r = hash_words(solid_words, k, seed, np)
        wi, bit = wordbit_classic_from_hashes(f, r, n_hashes, n_words, np)
        np.bitwise_or.at(bitset, wi.reshape(-1), np.uint32(1) << bit.reshape(-1))
    return bitset


def probe_classic(bitset, words, n_hashes: int, n_words: int, seed: int, k: int):
    """Classic-addressed probe of packed k-mer words (..., W) -> bool."""
    xp = np if isinstance(words, np.ndarray) else jnp
    f, r = hash_words(words, k, seed, xp)
    wi, bit = wordbit_classic_from_hashes(f, r, n_hashes, n_words, xp)
    return probe_wordbit(bitset, wi, bit, xp)


def auto_params(hist: np.ndarray, cutoff: int,
                lossy_quals: bool = False,
                stored_filter: bool = True) -> tuple[float, int]:
    """(bits_per_kmer, n_hashes) from the count histogram. The stored
    filter and the extra walk events it prevents trade off against each
    other, and the optimum shifts with coverage: every false-positive
    branch repeats in each read that crosses it, so the FP cost scales
    with the mean solid-kmer coverage while the filter cost is flat per
    solid k-mer. Calibrated by end-to-end archive-size sweeps at 4x/10x/
    25x/50x coverage (1% and 0.5% error): measured optima (bpk, H) =
    (4,2) at mean_cov 3.3, (8,3) at 7.3 and 5.8, (18,4) at 17.5, (24,4)
    at 35 — i.e. bpk tracks 1.2x mean_cov over the practical range, and
    H=5 measured worse than H=4 everywhere. Rule: bpk = clip(1.2 *
    mean_cov, 4, 24); H steps 2/3/4 at bpk 6/10.

    stored_filter=False (the UNITIGS-section regime, round 5): when the
    archive stores the solid set as unitigs and REBUILDS the filter at
    decode (FORMAT.md §4a), bits_per_kmer costs HBM only — zero archive
    bytes — while every false positive still inflates the bif/err event
    streams (and, in lossy mode, forfeits quality smoothing). The
    optimum therefore detaches from the stored-size tradeoff the rules
    below were swept for: floor bpk at 24 (blocked-addressing FP ~
    (H*32/bpk/32)^H = 0.08% at H=4, vs ~4% at the lossless auto choice
    for 7x coverage), H = 4. The decoder reads n_words/H from META, so
    the choice is format-transparent.

    lossy_quals shifts the optimum hard toward a DENSE filter: the LOSSY-Q1
    transform only smooths qualities at graph-CONFIRMED positions
    (scount == 1), so every false-positive branch also forfeits quality
    smoothing — the FP cost includes the quality stream, not just walk
    events. E.coli-sweep at kmer-cov 7 (lossy totals): bpk 7.3 -> 4.53 MB,
    16 -> 3.69, 24 -> 3.65 (optimum), 32 -> 3.89. Rule: bpk = clip(3.4 *
    mean_cov, 12, 24), H = 4."""
    c = min(max(int(cutoff), 0), hist.size - 1)
    n_solid = float(hist[c:].sum())
    if n_solid <= 0:
        return (16.0, 4) if lossy_quals else (8.0, 3)
    mean_cov = float((np.arange(hist.size) * hist)[c:].sum()) / n_solid
    if lossy_quals:
        bpk = float(np.clip(3.4 * mean_cov, 12.0, 24.0))
        return (max(bpk, 24.0), 4) if not stored_filter else (bpk, 4)
    bpk = float(np.clip(1.2 * mean_cov, 4.0, 24.0))
    if not stored_filter:
        return max(bpk, 24.0), 4
    H = 2 if bpk < 6.0 else (3 if bpk < 10.0 else 4)
    return bpk, H


def choose_n_words(n_solid: int, bits_per_kmer: float) -> int:
    """Bitset words for an EXACTLY-sized filter (multiple of 64 words =
    2048 bits; fastrange addressing needs no power of two)."""
    want_words = int(np.ceil(max(64.0, n_solid * bits_per_kmer) / 32.0))
    return min(-(-want_words // 64) * 64, MAX_WORDS)


def saturation_warning(n_solid: int, n_words: int, bits_per_kmer: float) -> str | None:
    """Warn when the filter is materially SMALLER than its configured
    design point (the default bits_per_kmer is deliberately lean — sized
    at the measured end-to-end ratio optimum, where the stored filter and
    the extra walk events balance — so an absolute false-positive
    threshold would fire on every healthy run). With exact sizing this
    only happens when MAX_WORDS clips a huge build; the reference never
    warns at all, and a silently clipped filter collapses the ratio."""
    want_bits = n_solid * bits_per_kmer
    have_bits = 32.0 * n_words
    if have_bits < 0.8 * want_bits:
        return (
            f"Bloom filter clipped: {n_solid} solid k-mers want "
            f"{want_bits / 8e6:.0f} MB at {bits_per_kmer} bits/kmer but the "
            f"filter is capped at {have_bits / 8e6:.0f} MB; false positives "
            "will inflate the event streams (raise abundance to shrink the "
            "solid set)"
        )
    return None


def build_np(solid_words: np.ndarray, n_words: int, n_hashes: int, seed: int, k: int) -> np.ndarray:
    """Host build: returns uint32 bitset of shape (n_words,). Native
    per-row kernel when available (the numpy form's k table-gather rounds
    cost ~60-90 s at chr-scale row counts — count.finalize and the
    decode-side rebuild both sit on this); bit-identical fallback."""
    bitset = np.zeros(n_words, dtype=np.uint32)
    if not solid_words.shape[0]:
        return bitset
    from leon_tpu import native

    lib = native.get_lib()
    if lib is not None and hasattr(lib, "leon_bloom_build"):
        tab = tables(seed, k)
        T = np.ascontiguousarray(tab[0])
        Tc = np.ascontiguousarray(tab[1])
        w = np.ascontiguousarray(solid_words, dtype=np.uint32)
        rc = lib.leon_bloom_build(w.shape[0], w.shape[1], w.ctypes.data,
                                  int(n_words), int(n_hashes), int(k),
                                  T.ctypes.data, Tc.ctypes.data,
                                  bitset.ctypes.data)
        if rc == 0:
            return bitset
        bitset[:] = 0
    wi, mask = wordmask(solid_words, n_hashes, n_words, seed, np, k)
    np.bitwise_or.at(bitset, wi.reshape(-1), mask.reshape(-1))
    return bitset


def probe_wordbit(bitset, wi, bit, xp):
    """True iff all bits at (wi, bit) pairs (..., H) are set."""
    u = xp.uint32
    w = bitset[wi]
    hit = (w >> bit) & u(1)
    return (hit == 1).all(axis=-1)


def probe_wordmask(bitset, wi, mask, xp):
    """Blocked membership: ONE gathered word per key, all mask bits set."""
    w = bitset[wi]
    return (w & mask) == mask


def probe(bitset, words, n_hashes: int, n_words: int, seed: int, k: int):
    """Device probe of packed k-mer words (..., W) -> bool (...)."""
    wi, mask = wordmask(words, n_hashes, n_words, seed, jnp, k)
    return probe_wordmask(bitset, wi, mask, jnp)


def probe_np(bitset: np.ndarray, words: np.ndarray, n_hashes: int, n_words: int, seed: int, k: int):
    wi, mask = wordmask(words, n_hashes, n_words, seed, np, k)
    return probe_wordmask(bitset, wi, mask, np)


def _build_device_jit():
    from functools import partial

    import jax

    @partial(jax.jit, static_argnames=("n_alloc", "H", "seed", "k"))
    def _build(uw, cnt, co, nw, n_alloc: int, H: int, seed: int, k: int):
        wi, bit = wordbit(uw, H, nw, seed, jnp, k)  # (M, H)
        solid = cnt >= co
        # pad slot n_alloc (static, >= traced nw) absorbs non-solid rows
        wif = jnp.where(solid[:, None], wi.astype(jnp.uint32), jnp.uint32(n_alloc)).reshape(-1)
        bitf = jnp.where(solid[:, None], bit, jnp.uint32(0)).reshape(-1)
        swi, sbit = jax.lax.sort((wif, bitf), num_keys=2)
        first = jnp.concatenate(
            [jnp.ones(1, bool), (swi[1:] != swi[:-1]) | (sbit[1:] != sbit[:-1])]
        )
        idx = jnp.where(first, swi, jnp.uint32(n_alloc)).astype(jnp.int32)
        out = jnp.zeros(n_alloc + 1, jnp.uint32).at[idx].add(
            jnp.uint32(1) << sbit, mode="drop"
        )
        return out[:n_alloc]

    return _build


_build_device = None


def build_device(uniq_words, counts, cutoff, n_words: int, n_hashes: int,
                 seed: int, k: int):
    """Device build from a distinct-kmer run: (M, W) u32 words + (M,) i32
    counts (0 = pad). Sort-dedup-scatter: sorting the (word, bit) pairs and
    dropping duplicates makes scatter-ADD equal bitwise OR (each set bit
    contributes exactly once) without a byte-per-bit scratch array.

    Returns a bitset of shape (alloc_words(n_words),): exact n_words is
    traced data, only the padded allocation shape is static — so the
    compiled program is shared across filter sizes within a grid bucket."""
    global _build_device
    if _build_device is None:
        _build_device = _build_device_jit()
    n_alloc = alloc_words(n_words)
    return _build_device(uniq_words, counts, cutoff, jnp.uint32(n_words),
                         n_alloc, n_hashes, seed, k)
